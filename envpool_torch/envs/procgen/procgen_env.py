"""Procgen family of the port — host-native tier over libenv (requires
``procgen``); the port's copy of ``envpool_tpu/envs/procgen/procgen_env.py``.

Parity target: ``envpool/procgen/procgen_env.h`` (which links procgen's C++
``Game`` objects directly). The procgen python wheel does not expose
single-game objects, so this tier drives a ``ProcgenGym3Env(num=1)`` per
env — the same one-emulator-per-env-object layout as the reference, on the
HostEnvPool worker threads. Config keys, the 64x64x3 obs (optionally
channel-first), the 15-button action space, and the
prev_level_seed/prev_level_complete/level_seed info fields match
``procgen_env.h:58-88, 125-210``.

``procgen`` is imported only inside ``ProcgenEnv.__init__``; the package
``__init__`` gates the family on it.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from envpool_torch.core.host_pool import HostEnv
from envpool_torch.core.spec import ArraySpec

RES = 64
_DISTRIBUTION = {0: "easy", 1: "hard", 2: "extreme", 10: "memory"}


class ProcgenEnv(HostEnv):
  """One procgen game instance per env object."""

  name = "Procgen"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "env_name": "bigfish", "channel_first": True, "num_levels": 0,
      "start_level": 0, "use_sequential_levels": False,
      "center_agent": True, "use_backgrounds": True,
      "use_monochrome_assets": False, "restrict_themes": False,
      "use_generated_assets": False, "paint_vel_info": False,
      "use_easy_jump": False, "distribution_mode": 1,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    shape = (3, RES, RES) if cfg.channel_first else (RES, RES, 3)
    return {
      "obs": ArraySpec(np.uint8, shape, 0, 255),
      "info:prev_level_seed": ArraySpec(np.int32, (-1,)),
      "info:prev_level_complete": ArraySpec(np.int32, (-1,)),
      "info:level_seed": ArraySpec(np.int32, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, 14)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    from procgen import ProcgenGym3Env
    self.channel_first = bool(cfg.channel_first)
    self.game = ProcgenGym3Env(
      num=1,
      env_name=str(cfg.env_name),
      num_levels=int(cfg.num_levels),
      start_level=int(cfg.start_level),
      use_sequential_levels=bool(cfg.use_sequential_levels),
      center_agent=bool(cfg.center_agent),
      use_backgrounds=bool(cfg.use_backgrounds),
      use_monochrome_assets=bool(cfg.use_monochrome_assets),
      restrict_themes=bool(cfg.restrict_themes),
      use_generated_assets=bool(cfg.use_generated_assets),
      paint_vel_info=bool(cfg.paint_vel_info),
      distribution_mode=_DISTRIBUTION[int(cfg.distribution_mode)],
      rand_seed=(int(cfg.seed) + env_id) % (2**31),
    )

  def _obs(self) -> np.ndarray:
    _, obs, _ = self.game.observe()
    rgb = obs["rgb"][0]
    if self.channel_first:
      rgb = np.transpose(rgb, (2, 0, 1))
    return np.ascontiguousarray(rgb)

  def _info(self) -> Dict[str, Any]:
    info = self.game.get_info()[0]
    return {
      "prev_level_seed": np.int32(info.get("prev_level_seed", -1)),
      "prev_level_complete": np.int32(info.get("prev_level_complete", 0)),
      "level_seed": np.int32(info.get("level_seed", -1)),
    }

  def reset(self) -> Tuple[np.ndarray, Dict[str, Any]]:
    # gym3 envs reset themselves: the first observe() after construction or
    # after a ``first`` step is the episode's start (procgen_env.h:150-160)
    return self._obs(), self._info()

  def step(self, action) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
    self.game.act(np.asarray([action], np.int32))
    rew, _, first = self.game.observe()
    return self._obs(), float(rew[0]), bool(first[0]), self._info()
