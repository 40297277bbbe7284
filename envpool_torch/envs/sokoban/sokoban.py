"""Sokoban — the fork's flagship family, batched in PyTorch.

The port of ``envpool_tpu/envs/sokoban/sokoban.py``; every function takes
and returns the whole ``[N, ...]`` batch. Semantics are the JAX package's,
bit for bit (``tests/test_torch_sokoban_parity.py``):
- push/move arena logic, box matching, reward = reward_step + reward_box *
  (prev_unmatched - unmatched) + reward_finished if solved
  (``envpool/sokoban/sokoban_envpool.cc:85-167``);
- a negative action is a noop with a NaN reward that does not advance the
  step counter (``sokoban_envpool.cc:87-95``);
- per-episode step cap sampled uniform[min_episode_steps,
  max_episode_steps]; a solved episode is never truncated;
- reset-into-terminal-obs (``FuncEnv.env_resets``): on a terminal step the
  next episode's level is loaded before the observation is written;
- level streaming: sequential mode walks the (file-name sorted) level
  stream at positions env_id + k * num_envs; random mode picks a uniform
  file, then a uniform level in it, from the threefry stream.

Where the JAX package works around the TPU (one-hot GEMMs for the level
fetch, one-hot masks for cell reads and writes, seven mask passes for the
render), the plain version (``step_plain``, ``reset_plain``) uses what a
GPU does well: one gather from the ``[n_levels, D, D]`` bank, three gathers
and three masked scatters on the flattened worlds, and one palette gather
for the render. ``step`` and ``reset`` run it for CPU tensors; for CUDA
tensors they are one launch each of ``csrc/sokoban_step.cu``, which
computes the same thing, bit for bit, with its next episodes drawn in the
kernel from ``csrc/threefry.cuh`` (``SokobanEnv.kernel_launches`` counts
the launches). ``SokobanEnv.fused_advance`` is the pool's whole advance in
one launch of the same kernel (the key split, the reset select, the
epilogue and the mask of ``TorchEnvPool._advance``), taken for CUDA tensors
(``SokobanEnv.advance_launches`` counts those launches); the pool's general
path over ``step_plain`` / ``reset_plain`` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from envpool_torch import _build
from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec

from .level_loader import (
  BOX,
  BOX_ON_TARGET,
  EMPTY,
  PLAYER,
  PLAYER_ON_TARGET,
  TARGET,
  WALL,
  LevelBank,
  generate_bank,
  load_bank,
)

# action codes (sokoban_envpool.h:31-35)
ACT_PUSH_UP, ACT_PUSH_DOWN, ACT_PUSH_LEFT, ACT_PUSH_RIGHT = range(4)
MAX_ACTION = ACT_PUSH_RIGHT

# Per-action (row, col) deltas: the reference's (x, y) = (column, row)
# kChangeCoordinates {{0,-1},{0,1},{-1,0},{1,0}} on [row, col] worlds.
_CHANGE_COORDINATES = np.asarray(
  [[-1, 0], [1, 0], [0, -1], [0, 1]], dtype=np.int32
)

# tiny-world RGB palette indexed by tile code (sokoban_envpool.cc:171-177)
TINY_COLORS = np.asarray(
  [
    [0, 0, 0],        # WALL
    [243, 248, 238],  # EMPTY
    [254, 126, 125],  # TARGET
    [254, 95, 56],    # BOX_ON_TARGET
    [142, 121, 56],   # BOX
    [160, 212, 56],   # PLAYER
    [219, 212, 56],   # PLAYER_ON_TARGET
  ],
  dtype=np.uint8,
)

#: environment variable naming the disk cache of generated banks ("" turns
#: it off); the default is ``envpool_torch_banks`` in the temporary directory
BANK_CACHE_ENV = "ENVPOOL_TORCH_BANK_CACHE"


@functools.lru_cache(maxsize=32)
def _bank_cached(
  levels_dir: str, dim_room: int, n_levels_to_load: int, seed: int
) -> LevelBank:
  if levels_dir:
    return load_bank(levels_dir, dim_room, -1)
  # no levels_dir: a deterministic procedurally generated bank, cached on
  # disk across processes (generating 1024 levels takes seconds), in the
  # same .npy format as the JAX package's cache
  n = n_levels_to_load if n_levels_to_load > 0 else 1024
  cache_dir = os.environ.get(
    BANK_CACHE_ENV, os.path.join(tempfile.gettempdir(), "envpool_torch_banks")
  )
  path = (
    os.path.join(cache_dir, f"bank_s{seed}_n{n}_d{dim_room}.npy")
    if cache_dir else ""
  )
  if path and os.path.exists(path):
    try:
      levels = np.load(path)
    except (OSError, ValueError):
      levels = None  # corrupt cache: regenerate below
    if levels is not None and levels.shape == (n, dim_room, dim_room):
      return LevelBank(
        levels,
        np.zeros(n, dtype=np.int32),
        np.arange(n, dtype=np.int32),
        ["<generated>"],
      )
  bank = generate_bank(seed, n, dim_room=dim_room)
  if path:
    try:
      os.makedirs(cache_dir, exist_ok=True)
      tmp = path + f".tmp{os.getpid()}"
      with open(tmp, "wb") as f:  # np.save(path) would append ".npy"
        np.save(f, bank.levels)
      os.replace(tmp, path)
    except OSError:
      pass  # unwritable cache dir: run uncached
  return bank


def _get_bank(cfg: Any) -> LevelBank:
  return _bank_cached(
    str(cfg.levels_dir), int(cfg.dim_room),
    int(cfg.n_levels_to_load), int(cfg.seed)
  )


@functools.lru_cache(maxsize=None)
def _device_bank(
  levels_dir: str, dim_room: int, n_levels_to_load: int, seed: int,
  device: torch.device,
) -> Dict[str, torch.Tensor]:
  """The bank and its tables on ``device``, built once per config.

  Kept with the env for the life of the process (an unbounded cache): a
  captured graph holds the bank's addresses, in the step kernel's arguments
  or the plain version's gathers, and replays read them for as long as the
  graph lives, so no bank may be freed while any pool could still replay.
  A bank is ``n_levels * D * D`` bytes and a few tables (~110 KB for 1024
  levels of 10 x 10) per (config, device)."""
  bank = _bank_cached(levels_dir, dim_room, n_levels_to_load, seed)

  def dev(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)

  return {
    "levels": dev(bank.levels),               # [n, D, D] uint8
    "file_idx": dev(bank.file_idx),           # [n] int32
    "level_idx": dev(bank.level_idx),         # [n] int32
    "file_start": dev(bank.file_start.astype(np.int64)),
    "file_len": dev(bank.file_len),           # int32, as the JAX cast gives
  }


@functools.lru_cache(maxsize=4)
def _constants(device: torch.device) -> Dict[str, torch.Tensor]:
  return {
    "delta": torch.from_numpy(_CHANGE_COORDINATES).to(device),
    "palette": torch.from_numpy(TINY_COLORS).to(device),
  }


#: the largest ``dim_room`` the step kernel takes (a block's 32 worlds in
#: 48 KB of shared memory)
KERNEL_MAX_DIM = 32

#: the kernel's modes (``sokoban_launch``'s ``mode``)
_STEP, _RESET, _ADVANCE = 0, 1, 2


class _StepArgs(ctypes.Structure):
  """``struct SokobanArgs`` of ``csrc/sokoban_step.cu``."""

  _fields_ = [
    *((name, ctypes.c_void_p) for name in (
      "world", "player", "unmatched", "steps", "cap", "cursor", "file_idx",
      "level_idx", "action", "keys",
    )),
    ("key_stride", ctypes.c_longlong), ("key_col", ctypes.c_longlong),
    *((name, ctypes.c_void_p) for name in (
      "levels", "bank_file_idx", "bank_level_idx", "file_start", "file_len",
    )),
    *((name, ctypes.c_int) for name in (
      "n_files", "n", "dim", "sequential", "n_eff", "num_envs",
    )),
    ("cap_lo", ctypes.c_uint), ("cap_span", ctypes.c_uint), ("cap_hi", ctypes.c_int),
    ("reward_step", ctypes.c_float), ("reward_box", ctypes.c_float),
    ("reward_finished", ctypes.c_float),
    *((name, ctypes.c_void_p) for name in (
      "world_out", "player_out", "unmatched_out", "steps_out", "cap_out",
      "cursor_out", "file_idx_out", "level_idx_out", "obs", "reward", "done",
      "trunc", "elapsed", "elapsed_in", "done_in", "mask", "rng_out",
      "step_type", "discount", "done_carry",
    )),
    ("force_reset", ctypes.c_int),
  ]


def _kernel():
  """The C entry point of ``csrc/sokoban_step.cu``, built at first use."""
  fn = _build.load("sokoban_step").sokoban_launch
  if fn.argtypes is None:
    fn.argtypes = [ctypes.POINTER(_StepArgs), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
  return fn


@functools.lru_cache(maxsize=64)
def _pool_args(cfg: Any, n: int, device: torch.device) -> _StepArgs:
  """The template argument struct of one pool shape (config, width,
  device), its constant fields filled once. Every pool of that shape shares
  it, so nothing writes it after this: each launch fills the pointers of
  its tensors in a copy of its own. It holds the device bank's addresses,
  which live for the process."""
  d = int(cfg.dim_room)
  if not 0 < d <= KERNEL_MAX_DIM:
    raise ValueError(f"the step kernel takes dim_room 1..{KERNEL_MAX_DIM}, got {d}")
  lo, hi = int(cfg.min_episode_steps), int(cfg.max_episode_steps)
  i32 = torch.iinfo(torch.int32)
  span = (hi - lo + 1) & 0xFFFFFFFF if lo < hi else 0
  if not i32.min <= hi <= i32.max or (lo < hi and span == 0):
    raise ValueError(f"episode steps [{lo}, {hi}] outside what the kernel takes")
  bank = _device_bank(
    str(cfg.levels_dir), d, int(cfg.n_levels_to_load), int(cfg.seed), device
  )
  n_levels, n_load = bank["levels"].shape[0], int(cfg.n_levels_to_load)
  f32 = np.float32
  args = _StepArgs()
  for field, key in (("levels", "levels"), ("bank_file_idx", "file_idx"),
                     ("bank_level_idx", "level_idx"), ("file_start", "file_start"),
                     ("file_len", "file_len")):
    setattr(args, field, bank[key].data_ptr())
  args.n_files = bank["file_start"].shape[0]
  args.n, args.dim = n, d
  args.sequential = int(bool(cfg.load_sequentially))
  args.n_eff = n_load if 0 < n_load <= n_levels else n_levels
  args.num_envs = int(cfg.num_envs)
  args.cap_lo, args.cap_span, args.cap_hi = lo & 0xFFFFFFFF, span, hi
  args.reward_step = float(f32(cfg.reward_step))
  args.reward_box = float(f32(cfg.reward_box))
  args.reward_finished = float(f32(cfg.reward_finished))
  return args


#: the state's fields in the order ``_fresh_episode`` builds them
_STATE_KEYS = (
  "world", "player", "unmatched", "steps", "cap", "cursor", "file_idx",
  "level_idx",
)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
  """int64 values -> int32 with two's-complement wrap (the JAX casts)."""
  x = x & 0xFFFFFFFF
  return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


class SokobanEnv(FuncEnv):
  """Sokoban-v0."""

  name = "Sokoban"
  env_resets = True
  #: launches of ``csrc/sokoban_step.cu`` in step and reset mode
  kernel_launches = 0
  #: launches of ``csrc/sokoban_step.cu`` in advance mode (``fused_advance``)
  advance_launches = 0

  @staticmethod
  def default_config() -> Dict[str, Any]:
    # defaults of SokobanEnvFns::DefaultConfig (sokoban_envpool.h:40-48)
    return {
      "reward_finished": 10.0,
      "reward_box": 1.0,
      "reward_step": -0.1,
      "dim_room": 10,
      "levels_dir": "",
      "verbose": 0,
      "min_episode_steps": 0,
      "load_sequentially": False,
      "n_levels_to_load": -1,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    d = int(cfg.dim_room)
    return {
      "obs": ArraySpec(np.uint8, (3, d, d)),
      "info:level_file_idx": ArraySpec(np.int32, (-1,)),
      "info:level_idx": ArraySpec(np.int32, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, MAX_ACTION)}

  # ----------------------------------------------------------------- helpers

  @classmethod
  def _load_level(
    cls, cfg: Any, cursor: torch.Tensor, keys: torch.Tensor
  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick each env's next level -> (world, file_idx, level_idx, cursor).

    ``cursor`` is each env's flat-stream position (env_id included).
    """
    bank = _device_bank(
      str(cfg.levels_dir), int(cfg.dim_room), int(cfg.n_levels_to_load),
      int(cfg.seed), keys.device,
    )
    n = bank["levels"].shape[0]
    if bool(cfg.load_sequentially):
      n_load = int(cfg.n_levels_to_load)
      n_eff = n_load if 0 < n_load <= n else n
      # floor mod (jnp.mod), not fmod: the int32 cursor may wrap negative
      flat = torch.remainder(cursor, n_eff).long()
      new_cursor = cursor + int(cfg.num_envs)
    else:
      sub = prng.split(keys, 2)
      n_files = bank["file_start"].shape[0]
      f = prng.randint(sub[:, 0], (), 0, n_files).long()
      length = bank["file_len"][f]
      lvl = torch.remainder(prng.randint(sub[:, 1], (), 0, 2**30), length)
      flat = bank["file_start"][f] + lvl.long()
      new_cursor = cursor
    return (
      bank["levels"][flat],
      bank["file_idx"][flat],
      bank["level_idx"][flat],
      new_cursor,
    )

  @staticmethod
  def _sample_cap(cfg: Any, keys: torch.Tensor) -> torch.Tensor:
    """uniform[min_episode_steps, max_episode_steps] per episode."""
    lo = int(cfg.min_episode_steps)
    hi = int(cfg.max_episode_steps)
    if lo >= hi:
      return torch.full(
        (keys.shape[0],), hi, dtype=torch.int32, device=keys.device
      )
    # the JAX package's uint32 arithmetic: bits % span, cast to int32, + lo
    span = (hi - lo + 1) & 0xFFFFFFFF
    bits = prng.random_bits(keys, ())
    return _wrap_i32(lo + _wrap_i32(bits % span).long())

  @classmethod
  def _fresh_episode(
    cls, cfg: Any, cursor: torch.Tensor, keys: torch.Tensor
  ) -> Dict[str, torch.Tensor]:
    sub = prng.split(keys, 2)
    world, fidx, lidx, cursor2 = cls._load_level(cfg, cursor, sub[:, 0])
    n, d = world.shape[0], world.shape[1]
    on_player = (world == PLAYER) | (world == PLAYER_ON_TARGET)
    # torch has no bool argmax; on ties it gives the first index, as jnp
    flat_pos = torch.argmax(on_player.reshape(n, d * d).to(torch.uint8), 1)
    flat_pos = flat_pos.to(torch.int32)
    return {
      "world": world,
      "player": torch.stack([flat_pos // d, flat_pos % d], 1),
      "unmatched": (world == BOX).sum((1, 2), dtype=torch.int32),
      "steps": torch.zeros(n, dtype=torch.int32, device=world.device),
      "cap": cls._sample_cap(cfg, sub[:, 1]),
      "cursor": cursor2,
      "file_idx": fidx,
      "level_idx": lidx,
    }

  # ------------------------------------------------------------------- hooks

  @classmethod
  def init(cls, cfg: Any, env_ids: torch.Tensor, keys: torch.Tensor) -> Any:
    # Like the reference constructor, init does NOT consume a level — the
    # first reset does. The all-wall stub world is never observed: the pool
    # resets every lane on its first step.
    del keys
    d, n, dev = int(cfg.dim_room), env_ids.shape[0], env_ids.device

    def full(shape, value, dtype=torch.int32):
      return torch.full(shape, value, dtype=dtype, device=dev)

    return {
      "world": full((n, d, d), WALL, torch.uint8),
      "player": full((n, 2), 0),
      "unmatched": full((n,), 1),
      "steps": full((n,), 0),
      "cap": full((n,), 1),
      "cursor": env_ids.to(torch.int32),
      "file_idx": full((n,), -1),
      "level_idx": full((n,), -1),
    }

  @classmethod
  def reset(
    cls, cfg: Any, state: Any, keys: torch.Tensor
  ) -> Tuple[Any, Any, Dict]:
    """``reset_plain`` for CPU (and meta) tensors; one launch of the step
    kernel in reset mode for CUDA tensors."""
    if state["world"].device.type in ("cpu", "meta"):
      return cls.reset_plain(cfg, state, keys)
    new, obs, _, _, _, elapsed = cls._launch(cfg, state, None, keys)
    return new, obs, dict(cls._info(new), elapsed_step=elapsed)

  @classmethod
  def reset_plain(
    cls, cfg: Any, state: Any, keys: torch.Tensor
  ) -> Tuple[Any, Any, Dict]:
    new = cls._fresh_episode(cfg, state["cursor"], keys)
    info = dict(cls._info(new), elapsed_step=torch.zeros_like(new["steps"]))
    return new, cls._render(new["world"]), info

  @classmethod
  def step(
    cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor
  ) -> Tuple[Any, Any, torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    """``step_plain`` for CPU (and meta) tensors; one launch of
    ``csrc/sokoban_step.cu`` for CUDA tensors."""
    if state["world"].device.type in ("cpu", "meta"):
      return cls.step_plain(cfg, state, action, keys)
    out, obs, reward, done, trunc, elapsed = cls._launch(cfg, state, action, keys)
    return out, obs, reward, done, trunc, dict(cls._info(out), elapsed_step=elapsed)

  @classmethod
  def _launch(cls, cfg: Any, state: Any, action: Any, keys: torch.Tensor):
    """One launch of the step kernel (reset mode where ``action`` is None):
    (state, obs, reward, done, trunc, elapsed_step), the three step outputs
    None in reset mode. See ``_run``."""
    if state["world"].device.type != "cuda":
      raise ValueError(f"no Sokoban step kernel for device {state['world'].device}")
    mode = _RESET if action is None else _STEP
    new, outs = cls._run(cfg, mode, state, action, keys)
    SokobanEnv.kernel_launches += int(new["world"].shape[0] > 0)
    if mode == _RESET:
      return new, outs["obs"], None, None, None, outs["elapsed_step"]
    return (new, outs["obs"], outs["reward"], outs["done"], outs["trunc"],
            outs["elapsed_step"])

  @classmethod
  def fused_advance(
    cls, cfg: Any, ps: Any, action: torch.Tensor, mask: Optional[torch.Tensor],
    force_reset: bool,
  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor,
             Dict[str, torch.Tensor]]:
    """The pool's whole advance (``FuncEnv.fused_advance``) in one launch of
    the step kernel in advance mode: (env state, carried keys, elapsed, done
    flags, outputs by the pool's output names). ``elapsed`` is also the
    ``elapsed_step`` output and ``info:level_file_idx`` / ``info:level_idx``
    are the state's ``file_idx`` / ``level_idx``, as in the general path.
    CUDA tensors only; see ``_run``."""
    if ps.rng.device.type != "cuda":
      raise ValueError(f"no Sokoban step kernel for device {ps.rng.device}")
    n = ps.rng.shape[0]
    dev = ps.rng.device
    for name, v, dtype in (("elapsed", ps.elapsed, torch.int32),
                           ("done", ps.done, torch.bool),
                           ("mask", mask, torch.bool)):
      if v is not None and (v.dtype != dtype or tuple(v.shape) != (n,) or v.device != dev):
        raise ValueError(f"{name} must be {dtype} ({n},) on {dev}, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")
    adv = (ps.elapsed.contiguous(), ps.done.contiguous(),
           None if mask is None else mask.contiguous(), bool(force_reset))
    new, outs = cls._run(cfg, _ADVANCE, ps.env, action, ps.rng, adv)
    SokobanEnv.advance_launches += int(n > 0)
    outs["info:level_file_idx"] = new["file_idx"]
    outs["info:level_idx"] = new["level_idx"]
    return new, outs.pop("rng"), outs["elapsed_step"], outs.pop("done_carry"), outs

  @classmethod
  def _run(cls, cfg: Any, mode: int, state: Any, action: Any, keys: torch.Tensor,
           adv: Optional[Tuple] = None):
    """One launch of ``csrc/sokoban_step.cu`` in ``mode`` -> (state, outputs
    by name). ``keys``: the step's keys in step and reset mode, the pool's
    carried keys in advance mode; ``adv`` (advance mode): the pool's
    (elapsed, done, mask or None, force_reset). Checks dtypes, shapes and
    devices, allocates the outputs, launches on the device's current
    stream and reads nothing back, so it may be captured. A state field
    that is not contiguous is copied first (the pool's never are)."""
    world = state["world"]
    dev = world.device
    n, d = world.shape[0], int(cfg.dim_room)
    if set(state) != set(_STATE_KEYS):
      raise ValueError(f"Sokoban state fields {sorted(state)}, expected {sorted(_STATE_KEYS)}")
    args = _StepArgs.from_buffer_copy(_pool_args(cfg, n, dev))
    st = {}
    for k in _STATE_KEYS:
      v = state[k]
      shape = (n, d, d) if k == "world" else (n, 2) if k == "player" else (n,)
      dtype = torch.uint8 if k == "world" else torch.int32
      if v.dtype != dtype or v.shape != shape or v.device != dev:
        raise ValueError(f"state[{k!r}] must be {dtype} {shape} on {dev}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")
      st[k] = v.contiguous()
    if keys.dtype != torch.int64 or keys.shape != (n, 2) or keys.device != dev:
      raise ValueError(f"keys must be int64 ({n}, 2) on {dev}, got {keys.dtype} "
                       f"{tuple(keys.shape)} on {keys.device}")
    if mode != _RESET:
      if action.device != dev or action.numel() != n:
        raise ValueError(f"action must hold {n} values on {dev}")
      action = action.reshape(n).to(torch.int32).contiguous()

    # the [n] outputs of one dtype are rows of one allocation (allocations
    # are most of the wrapper's host time)
    i32 = ["unmatched", "steps", "cap", "cursor", "file_idx", "level_idx", "elapsed_step"]
    f32, b8 = [], []
    if mode != _RESET:
      f32, b8 = ["reward"], ["done", "trunc"]
    if mode == _ADVANCE:
      i32.append("step_type")
      f32.append("discount")
      b8.append("done_carry")
    outs = {}
    for names, dtype in ((i32, torch.int32), (f32, torch.float32), (b8, torch.bool)):
      if names:
        rows = torch.empty((len(names), n), dtype=dtype, device=dev).unbind(0)
        outs.update(zip(names, rows))
    new = {"world": torch.empty((n, d, d), dtype=torch.uint8, device=dev),
           "player": torch.empty((n, 2), dtype=torch.int32, device=dev)}
    for k in _STATE_KEYS[2:]:
      new[k] = outs.pop(k)
    outs["obs"] = torch.empty((n, 3, d, d), dtype=torch.uint8, device=dev)
    if mode == _ADVANCE:
      outs["rng"] = torch.empty((n, 2), dtype=torch.int64, device=dev)

    def ptr(name):
      t = outs.get(name)
      return None if t is None else t.data_ptr()

    for k in _STATE_KEYS:
      setattr(args, k, st[k].data_ptr())
      setattr(args, f"{k}_out", new[k].data_ptr())
    args.action = None if mode == _RESET else action.data_ptr()
    args.keys, args.key_stride, args.key_col = keys.data_ptr(), keys.stride(0), keys.stride(1)
    args.obs, args.elapsed = ptr("obs"), ptr("elapsed_step")
    args.reward, args.done, args.trunc = ptr("reward"), ptr("done"), ptr("trunc")
    args.rng_out, args.step_type = ptr("rng"), ptr("step_type")
    args.discount, args.done_carry = ptr("discount"), ptr("done_carry")
    if mode == _ADVANCE:
      elapsed, done, mask, force = adv
      args.elapsed_in, args.done_in = elapsed.data_ptr(), done.data_ptr()
      args.mask = None if mask is None else mask.data_ptr()
      args.force_reset = int(force)
    else:
      args.elapsed_in = args.done_in = args.mask = None
      args.force_reset = 0
    if n > 0:
      with torch.cuda.device(dev):
        err = _kernel()(ctypes.byref(args), mode, torch.cuda.current_stream().cuda_stream)
      if err != 0:
        raise RuntimeError(f"sokoban_step launch failed: CUDA error {err}")
    order = _STATE_KEYS if mode == _RESET else tuple(state)
    return {k: new[k] for k in order}, outs

  @classmethod
  def step_plain(
    cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor
  ) -> Tuple[Any, Any, torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    world = state["world"]
    n, d = world.shape[0], world.shape[1]
    action = action.reshape(n).to(torch.int32)
    noop = action < 0
    delta = _constants(world.device)["delta"][
      torch.clamp(action, 0, MAX_ACTION).long()
    ]
    p0 = state["player"]
    p1 = p0 + delta
    p2 = p0 + 2 * delta

    wf = world.reshape(n, d * d)

    def flat_pos(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
      """(in bounds, flat index clamped into the world) per env."""
      inb = (p[:, 0] >= 0) & (p[:, 0] < d) & (p[:, 1] >= 0) & (p[:, 1] < d)
      flat = torch.where(inb, p[:, 0] * d + p[:, 1], 0).long()
      return inb, flat[:, None]

    def world_at(pos) -> torch.Tensor:
      # an out-of-bounds read is WALL (sokoban_envpool.cc:69-74)
      inb, flat = pos
      return torch.where(inb, wf.gather(1, flat)[:, 0], WALL)

    pos0, pos1, pos2 = flat_pos(p0), flat_pos(p1), flat_pos(p2)
    a0, a1, a2 = world_at(pos0), world_at(pos1), world_at(pos2)
    box_moves = (
      ((a1 == BOX) | (a1 == BOX_ON_TARGET)) &
      ((a2 == EMPTY) | (a2 == TARGET))
    )
    agent_moves = (a1 == EMPTY) | (a1 == TARGET) | box_moves

    def is_target(a: torch.Tensor) -> torch.Tensor:
      return (a == BOX_ON_TARGET) | (a == TARGET) | (a == PLAYER_ON_TARGET)

    t0, t1, t2 = is_target(a0), is_target(a1), is_target(a2)
    u8 = torch.uint8
    new0 = torch.where(t0, TARGET, EMPTY).to(u8)
    new1 = torch.where(t1, PLAYER_ON_TARGET, PLAYER).to(u8)
    new2 = torch.where(
      box_moves, torch.where(t2, BOX_ON_TARGET, BOX).to(u8), a2
    )

    # Masked writes, with the JAX package's drop semantics: a cell is only
    # written where its position is in bounds and the agent moves. A lane
    # that does not write puts back the value it reads at the (clamped)
    # index, so a clamped out-of-bounds p2 corrupts nothing. The three
    # positions differ, so the order of the writes does not matter.
    do_move = agent_moves & ~noop
    wf2 = wf.clone()
    for (inb, flat), new in ((pos2, new2), (pos1, new1), (pos0, new0)):
      write = (do_move & inb)[:, None]
      wf2.scatter_(1, flat, torch.where(write, new[:, None], wf2.gather(1, flat)))
    world2 = wf2.reshape(n, d, d)
    player2 = torch.where(do_move[:, None], p1, p0)
    d_unmatched = torch.where(
      box_moves & do_move, t1.to(torch.int32) - t2.to(torch.int32), 0
    ).to(torch.int32)
    unmatched2 = state["unmatched"] + d_unmatched
    steps2 = state["steps"] + (~noop).to(torch.int32)

    solved = unmatched2 == 0
    f32 = np.float32
    # the JAX package's order: step + box * (-d_unmatched) + finished
    reward = (
      float(f32(cfg.reward_step))
      + float(f32(cfg.reward_box)) * (-d_unmatched).to(torch.float32)
    ) + torch.where(solved, float(f32(cfg.reward_finished)), 0.0)
    reward = torch.where(noop, float("nan"), reward)
    done = solved | (steps2 >= state["cap"])
    trunc = done & ~solved

    stepped = dict(
      state, world=world2, player=player2, unmatched=unmatched2, steps=steps2
    )
    # reset-into-terminal-obs: every lane draws its next episode from this
    # step's own key and the done lanes take it, with no host read here
    fresh = cls._fresh_episode(cfg, state["cursor"], keys)
    out = {
      k: torch.where(done.reshape((n,) + (1,) * (v.ndim - 1)), fresh[k], v)
      for k, v in stepped.items()
    }
    # elapsed_step reports the FINISHING episode's counter, even on the
    # terminal step (sokoban_envpool.cc:177-216); noops left steps2 as is
    info = dict(cls._info(out), elapsed_step=steps2)
    return out, cls._render(out["world"]), reward, done, trunc, info

  @staticmethod
  def _render(world: torch.Tensor) -> torch.Tensor:
    """[N, D, D] tile codes -> [N, 3, D, D] uint8 RGB, one palette gather."""
    palette = _constants(world.device)["palette"]
    return palette[world.long()].permute(0, 3, 1, 2).contiguous()

  @staticmethod
  def _info(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {
      "level_file_idx": state["file_idx"],
      "level_idx": state["level_idx"],
    }
