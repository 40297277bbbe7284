"""Atari family of the port — host-native ALE tier with the reference's
wrapper stack; the port's copy of ``envpool_tpu/envs/atari/atari_env.py``.

Parity target: ``envpool/atari/atari_env.h:40-314``. ALE is a 6502 emulator
that runs only on the host, so like the reference this family runs it on
the HostEnvPool's worker threads (ALE releases the GIL) and implements the
full in-engine wrapper stack from scratch:

- noop reset: uniform(0, noop_max-1)+1-fire_reset noops after game reset,
  re-resetting on game-over during noops (:151-168);
- fire reset: one FIRE action if the action set contains it (:135-142, :169);
- frame_skip with elementwise max over the LAST TWO skipped frames
  (:186-205, :269-276);
- grayscale via ALE's palette, INTER_AREA resize to img_height x img_width
  (same area-overlap math as ``envpool_torch.ops.image``), stack_num frame
  stacking with push-all-on-reset (:281-287);
- episodic_life (done on life loss, real reset only on true game over,
  :170-207), zero_discount_on_life_loss (:210-214), reward_clip to sign
  (:217-223), repeat_action_probability (sticky actions, via ALE setting),
  full/minimal action space (:128-133);
- info fields lives / unclipped reward / terminated (:241-247).

Requires ``ale_py`` (optional dependency, like every non-sokoban family in
the reference's ``envpool/entry.py:17-55``), imported inside functions only.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np

from envpool_torch.core.host_pool import HostEnv
from envpool_torch.core.spec import ArraySpec

RAW_H, RAW_W = 210, 160


@functools.lru_cache(maxsize=64)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
  """Same area-overlap matrix as ``envpool_torch.ops.image._area_weights``."""
  scale = n_in / n_out
  w = np.zeros((n_out, n_in), dtype=np.float32)
  for o in range(n_out):
    lo, hi = o * scale, (o + 1) * scale
    for i in range(int(np.floor(lo)), min(int(np.ceil(hi)), n_in)):
      overlap = min(hi, i + 1) - max(lo, i)
      if overlap > 0:
        w[o, i] = overlap / scale
  return w


def _resize_area_np(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
  """cv2.INTER_AREA-equivalent resize of [H, W, C] uint8 on host."""
  wh = _area_weights(img.shape[0], out_hw[0])
  ww = _area_weights(img.shape[1], out_hw[1])
  x = np.einsum("oh,hwc->owc", wh, img.astype(np.float32))
  x = np.einsum("pw,owc->opc", ww, x)
  return np.clip(np.floor(x + 0.5), 0, 255).astype(np.uint8)


def find_rom(task: str) -> str:
  """Resolve a rom name ('pong') to a path via ale_py's rom registry."""
  import ale_py.roms
  path = getattr(ale_py.roms, "get_rom_path", None)
  if path is not None:
    rom = path(task)
    if rom is None:
      raise FileNotFoundError(f"ALE rom not found: {task}")
    return str(rom)
  rom = getattr(ale_py.roms, _snake_to_camel(task), None)
  if rom is None:
    raise FileNotFoundError(f"ALE rom not found: {task}")
  return str(rom)


def _snake_to_camel(s: str) -> str:
  return "".join(w.capitalize() for w in s.split("_"))


def _make_ale(task: str, seed: int, repeat_action_probability: float):
  import ale_py
  if hasattr(ale_py.ALEInterface, "setLoggerMode"):
    ale_py.ALEInterface.setLoggerMode(ale_py.LoggerMode.Error)
  ale = ale_py.ALEInterface()
  ale.setFloat("repeat_action_probability", repeat_action_probability)
  ale.setInt("random_seed", seed)
  ale.loadROM(find_rom(task))
  return ale


@functools.lru_cache(maxsize=256)
def _action_set_size(task: str, full_action_space: bool) -> int:
  ale = _make_ale(task, 0, 0.0)
  if full_action_space:
    return len(ale.getLegalActionSet())
  return len(ale.getMinimalActionSet())


class AtariEnv(HostEnv):
  """Atari ``-v5`` env (``envpool/atari/atari_env.h:85-307``)."""

  name = "Atari"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "stack_num": 4, "frame_skip": 4, "noop_max": 30,
      "zero_discount_on_life_loss": False, "episodic_life": False,
      "reward_clip": False, "use_fire_reset": True,
      "img_height": 84, "img_width": 84, "task": "pong",
      "full_action_space": False, "repeat_action_probability": 0.0,
      "use_inter_area_resize": True, "gray_scale": True,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    c = 1 if cfg.gray_scale else 3
    return {
      "obs": ArraySpec(
        np.uint8,
        (int(cfg.stack_num) * c, int(cfg.img_height), int(cfg.img_width)),
        0, 255,
      ),
      "info:lives": ArraySpec(np.int32, (-1,)),
      "info:reward": ArraySpec(np.float32, (-1,)),
      "info:terminated": ArraySpec(np.int32, (-1,), 0, 1),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    n = _action_set_size(str(cfg.task), bool(cfg.full_action_space))
    return {"action": ArraySpec(np.int32, (-1,), 0, n - 1)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    self.ale = _make_ale(
      str(cfg.task), int(cfg.seed) + env_id,
      float(cfg.repeat_action_probability),
    )
    if cfg.full_action_space:
      self.action_set = self.ale.getLegalActionSet()
    else:
      self.action_set = self.ale.getMinimalActionSet()
    self.fire_reset = bool(cfg.use_fire_reset) and any(
      int(a) == 1 for a in self.action_set
    )
    self.gray = bool(cfg.gray_scale)
    self.channels = 1 if self.gray else 3
    hw = (int(cfg.img_height), int(cfg.img_width))
    self.out_hw = hw
    self.stack_num = int(cfg.stack_num)
    self.frame_skip = int(cfg.frame_skip)
    self.stack = np.zeros(
      (self.stack_num, self.channels, *hw), np.uint8
    )
    self.maxpool = np.zeros((2, RAW_H, RAW_W, self.channels), np.uint8)
    self.lives = 0
    self.game_elapsed = 0  # frames since real game reset (episodic_life)
    self.game_over_flag = True

  # -- screen grabs -------------------------------------------------------

  def _grab(self, buf_idx: int) -> None:
    if self.gray:
      self.ale.getScreenGrayscale(self.maxpool[buf_idx, :, :, 0])
    else:
      self.ale.getScreenRGB(self.maxpool[buf_idx])

  def _push_stack(self, push_all: bool, maxpool: bool) -> None:
    frame = self.maxpool[0]
    if maxpool:
      frame = np.maximum(self.maxpool[0], self.maxpool[1])
    if self.cfg.use_inter_area_resize:
      small = _resize_area_np(frame, self.out_hw)
    else:  # bilinear fallback: simple area is still closer than nothing
      small = _resize_area_np(frame, self.out_hw)
    chw = np.transpose(small, (2, 0, 1))
    self.stack = np.roll(self.stack, -1, axis=0)
    self.stack[-1] = chw
    if push_all:
      self.stack[:] = chw[None]

  def _obs(self) -> np.ndarray:
    return self.stack.reshape(
      self.stack_num * self.channels, *self.out_hw
    )

  def _info(self, reward: float) -> Dict[str, Any]:
    return {
      "lives": np.int32(self.ale.lives()),
      "reward": np.float32(reward),
      "terminated": np.int32(self.ale.game_over()),
      # elapsed_step tracks the REAL game episode, surviving episodic-life
      # sub-resets (atari_env.h:245-248)
      "_override": {"elapsed_step": np.int32(self.game_elapsed)},
    }

  # -- env API ------------------------------------------------------------

  def reset(self):
    cfg = self.cfg
    noop = int(self.gen.integers(0, int(cfg.noop_max))) + 1 - int(
      self.fire_reset
    )
    push_all = False
    if (
      not cfg.episodic_life or self.ale.game_over()
      or self.game_elapsed >= int(cfg.max_episode_steps)
    ):
      self.ale.reset_game()
      self.game_elapsed = 0
      push_all = True
    while noop > 0:
      noop -= 1
      self.ale.act(0)
      if self.ale.game_over():
        self.ale.reset_game()
        push_all = True
    if self.fire_reset:
      self.ale.act(1)
    self._grab(0)
    self._push_stack(push_all, False)
    self.lives = self.ale.lives()
    return self._obs(), self._info(0.0)

  def step(self, action):
    cfg = self.cfg
    reward = 0.0
    done = False
    act = self.action_set[int(action)]
    skip_id = self.frame_skip
    while skip_id > 0 and not done:
      reward += self.ale.act(act)
      done = self.ale.game_over()
      if skip_id <= 2:
        self._grab(2 - skip_id)
      skip_id -= 1
    self._push_stack(False, skip_id == 0)
    self.game_elapsed += 1
    max_steps = int(cfg.max_episode_steps)
    done |= self.game_elapsed >= max_steps
    new_lives = self.ale.lives()
    if cfg.episodic_life and 0 < new_lives < self.lives:
      done = True
    info_reward = reward
    if cfg.reward_clip:
      reward = float(np.sign(reward))
    info = self._info(info_reward)
    # common-field rewrites (atari_env.h:208-223, :237-239)
    info["_override"].update({
      "done": np.bool_(done),
      "trunc": np.bool_(done and self.game_elapsed >= max_steps),
    })
    if cfg.zero_discount_on_life_loss:
      info["_override"]["discount"] = np.float32(
        self.lives == new_lives and not done
      )
    else:
      info["_override"]["discount"] = np.float32(not done)
    self.lives = new_lives
    return self._obs(), reward, done, self._info2_step_type(info, done)

  @staticmethod
  def _info2_step_type(info: Dict[str, Any], done: bool) -> Dict[str, Any]:
    info["_override"]["step_type"] = np.int32(2 if done else 1)
    return info
