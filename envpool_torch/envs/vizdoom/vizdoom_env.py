"""ViZDoom family of the port — host-native tier (requires the ``vizdoom``
wheel); the port's copy of ``envpool_tpu/envs/vizdoom/vizdoom_env.py``.

Parity target: ``envpool/vizdoom/vizdoom_env.h`` (DoomGame driven on worker
threads with an Atari-style frame pipeline). Implemented here:

- DoomGame configured from cfg/wad/iwad paths, per-env seed, player mode;
- frame pipeline: frame_skip via ``make_action(..., skip)``, per-channel
  INTER_AREA resize to img_height x img_width (the Atari tier's
  ``_resize_area_np``), stack_num stacking with push-all-on-reset;
- reward shaping from game-variable deltas: for each configured variable,
  ``pos * max(delta, 0) + neg * max(-delta, 0)`` per step, so a negative
  ``neg`` makes a loss a penalty (``HEALTH (0.005, -0.003)``), the
  reference's reward_config contract (``vizdoom_env.h:52-66, 300-360``);
- episodic_life (done on death with real reset on true episode end),
  .lmp demo recording via ``lmp_save_dir``;
- the 16 game-variable info fields, float64;
- ``use_combined_action``: the discrete id indexes the admissible button
  combinations of ``action_set.py`` on the host; otherwise the action is a
  float64 row of button values.

``vizdoom`` is imported only inside functions: the module imports without
it, and building a spec or an env needs it.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict

import numpy as np

from envpool_torch.core.host_pool import HostEnv
from envpool_torch.core.spec import ArraySpec
from envpool_torch.envs.atari.atari_env import _resize_area_np

from .action_set import build_action_set

INFO_VARS = [
  "AMMO2", "AMMO3", "AMMO4", "AMMO5", "AMMO6", "AMMO7", "ARMOR",
  "DAMAGECOUNT", "DEATHCOUNT", "FRAGCOUNT", "HEALTH", "HITCOUNT",
  "KILLCOUNT", "SELECTED_WEAPON", "SELECTED_WEAPON_AMMO", "USER2",
]

DEFAULT_REWARD_CONFIG = {
  "FRAGCOUNT": (1, -1.5), "KILLCOUNT": (1, 0), "DEATHCOUNT": (-0.75, 0.75),
  "HITCOUNT": (0.01, -0.01), "DAMAGECOUNT": (0.003, -0.003),
  "HEALTH": (0.005, -0.003), "ARMOR": (0.005, -0.001),
}


@functools.lru_cache(maxsize=64)
def _screen_channels(cfg_path: str) -> int:
  import vizdoom
  dg = vizdoom.DoomGame()
  if cfg_path:
    dg.load_config(cfg_path)
  return int(dg.get_screen_channels())


@functools.lru_cache(maxsize=64)
def _available_buttons(cfg_path: str) -> tuple:
  import vizdoom
  dg = vizdoom.DoomGame()
  if cfg_path:
    dg.load_config(cfg_path)
  return tuple(b.name for b in dg.get_available_buttons())


class VizdoomEnv(HostEnv):
  """One DoomGame per env object."""

  name = "Vizdoom"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "img_height": 84, "img_width": 84, "stack_num": 4, "frame_skip": 4,
      "lmp_save_dir": "", "episodic_life": False, "force_speed": False,
      "use_combined_action": False, "use_inter_area_resize": True,
      "weapon_duration": 5, "delta_button_config": (),
      "cfg_path": "", "wad_path": "",
      "iwad_path": "", "game_args": "", "map_id": "map01",
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    ch = _screen_channels(str(cfg.cfg_path))
    spec = {
      "obs": ArraySpec(
        np.uint8,
        (int(cfg.stack_num) * ch, int(cfg.img_height), int(cfg.img_width)),
        0, 255,
      ),
    }
    for v in INFO_VARS:
      spec[f"info:{v}"] = ArraySpec(np.float64, (-1,))
    return spec

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    buttons = _available_buttons(str(cfg.cfg_path))
    if cfg.use_combined_action:
      n = len(build_action_set(
        buttons, bool(cfg.force_speed), dict(cfg.delta_button_config)
      ))
      return {"action": ArraySpec(np.int32, (-1,), 0, n - 1)}
    return {"action": ArraySpec(np.float64, (-1, len(buttons)))}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    import vizdoom
    dg = vizdoom.DoomGame()
    if cfg.cfg_path:
      dg.load_config(str(cfg.cfg_path))
    if cfg.wad_path:
      dg.set_doom_scenario_path(str(cfg.wad_path))
    if cfg.iwad_path:
      dg.set_doom_game_path(str(cfg.iwad_path))
    if cfg.map_id:
      dg.set_doom_map(str(cfg.map_id))
    if cfg.game_args:
      dg.add_game_args(str(cfg.game_args))
    dg.set_window_visible(False)
    dg.set_mode(vizdoom.Mode.PLAYER)
    dg.set_seed((int(cfg.seed) + env_id) % (2**31))
    dg.init()
    self.dg = dg
    self.ch = int(dg.get_screen_channels())
    self.hw = (int(cfg.img_height), int(cfg.img_width))
    self.stack_num = int(cfg.stack_num)
    self.stack = np.zeros((self.stack_num, self.ch, *self.hw), np.uint8)
    self.var_ids = {
      v: getattr(vizdoom.GameVariable, v, None) for v in INFO_VARS
    }
    self.reward_cfg = DEFAULT_REWARD_CONFIG
    self.prev_vars: Dict[str, float] = {}
    self.episode_idx = 0
    if cfg.use_combined_action:
      self.action_set = build_action_set(
        [b.name for b in dg.get_available_buttons()],
        bool(cfg.force_speed), dict(cfg.delta_button_config),
      )
    else:
      self.action_set = None

  # ---------------------------------------------------------------- helpers

  def _get_var(self, name: str) -> float:
    gv = self.var_ids.get(name)
    if gv is None:
      return 0.0
    try:
      return float(self.dg.get_game_variable(gv))
    except Exception:
      return 0.0

  def _frame(self) -> np.ndarray:
    state = self.dg.get_state()
    if state is None or state.screen_buffer is None:
      # a finished episode has no screen
      return np.zeros((self.ch, *self.hw), np.uint8)
    buf = np.asarray(state.screen_buffer)
    if buf.ndim == 2:
      buf = buf[None]
    # CHW -> HWC for the resize, back to CHW
    small = _resize_area_np(np.transpose(buf, (1, 2, 0)), self.hw)
    return np.transpose(small, (2, 0, 1))

  def _push(self, push_all: bool) -> None:
    frame = self._frame()
    self.stack = np.roll(self.stack, -1, axis=0)
    self.stack[-1] = frame
    if push_all:
      self.stack[:] = frame[None]

  def _obs(self) -> np.ndarray:
    return self.stack.reshape(self.stack_num * self.ch, *self.hw)

  def _info(self) -> Dict[str, Any]:
    return {v: np.float64(self._get_var(v)) for v in INFO_VARS}

  def _shaping(self) -> float:
    reward = 0.0
    for name, (pos, neg) in self.reward_cfg.items():
      cur = self._get_var(name)
      delta = cur - self.prev_vars.get(name, cur)
      # pos scales gains, neg scales losses (vizdoom_env.h:52-66)
      reward += pos * max(delta, 0.0) + neg * max(-delta, 0.0)
      self.prev_vars[name] = cur
    return reward

  # ---------------------------------------------------------------- env API

  def reset(self):
    lmp_dir = str(self.cfg.lmp_save_dir)
    self.episode_idx += 1
    if lmp_dir:
      path = os.path.join(
        lmp_dir, f"env_{self.env_id}_ep_{self.episode_idx}.lmp"
      )
      self.dg.new_episode(path)
    else:
      self.dg.new_episode()
    self.prev_vars = {}
    self._shaping()  # latch the variables' baselines
    self._push(push_all=True)
    return self._obs(), self._info()

  def step(self, action):
    if self.action_set is not None:
      buttons = list(self.action_set[int(np.asarray(action).ravel()[0])])
    else:
      buttons = [float(a) for a in np.asarray(action).ravel()]
    self.dg.make_action(buttons, int(self.cfg.frame_skip))
    done = bool(self.dg.is_episode_finished())
    if self.cfg.episodic_life:
      done = done or bool(self.dg.is_player_dead())
    reward = self._shaping()
    self._push(push_all=False)
    return self._obs(), reward, done, self._info()
