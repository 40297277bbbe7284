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
render), the port uses what a GPU does well: one gather from the
``[n_levels, D, D]`` bank, three gathers and three masked scatters on the
flattened worlds, and one palette gather for the render.
"""

from __future__ import annotations

import functools
import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

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


@functools.lru_cache(maxsize=8)
def _device_bank(
  levels_dir: str, dim_room: int, n_levels_to_load: int, seed: int,
  device: torch.device,
) -> Dict[str, torch.Tensor]:
  """The bank and its tables on ``device``, built once per config."""
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


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
  """int64 values -> int32 with two's-complement wrap (the JAX casts)."""
  x = x & 0xFFFFFFFF
  return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


class SokobanEnv(FuncEnv):
  """Sokoban-v0."""

  name = "Sokoban"
  env_resets = True

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
    new = cls._fresh_episode(cfg, state["cursor"], keys)
    info = dict(cls._info(new), elapsed_step=torch.zeros_like(new["steps"]))
    return new, cls._render(new["world"]), info

  @classmethod
  def step(
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
