"""MiniGrid Empty family — batched PyTorch dynamics.

The port of ``envpool_tpu/envs/minigrid/minigrid.py`` (parity target
``envpool/minigrid/``, the C++ MiniGrid "Empty" environments):

- 7 actions left/right/forward/pickup/drop/toggle/done; only the first
  three do anything in Empty rooms (``impl/minigrid_env.cc:44-126``);
- reward ``1 - 0.9 * step_count / max_steps`` on reaching the goal, 0
  otherwise (``impl/minigrid_env.cc:83-87``);
- grid: surrounding grey walls, green goal at (width-2, height-2), agent at
  the configured start pos/dir or randomly placed on an empty cell with
  random direction when configured as (-1, -1)/-1
  (``impl/minigrid_empty_env.cc:35-63``, ``impl/minigrid_env.cc:132-156``);
- obs: ``direction`` plus the agent-view partial image [view, view, 3]
  uint8 of (type, color, state), rotated to face up, out-of-grid cells read
  as walls, the agent's own cell shows what it carries (empty here),
  transposed to match the python library (``impl/minigrid_env.cc:158-239``);
- info:agent_pos.

The grid is static, so the state is (pos, dir, steps). Where the JAX
package extracts the view with one-hot matmuls, selects the rotation with
masked adds and the colour with masked selects (TPU workarounds for
gathers), the image here is one gather from the padded type map: the view
window, its rotation by direction (``np.rot90`` of the window's index map,
once per config) and the final transpose are folded into a constant
``[4, view, view]`` table of flat offsets from the agent's cell; the colour
is a gather from the type->colour table.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec

# Act enum (impl/utils.h:24-37)
ACT_LEFT, ACT_RIGHT, ACT_FORWARD = 0, 1, 2
# Type enum (impl/utils.h:48-60)
T_EMPTY, T_WALL, T_GOAL = 1, 2, 8
# Color enum (impl/utils.h:39-46): empty->red, wall->grey, goal->green
TYPE_COLOR = np.zeros(11, dtype=np.uint8)
TYPE_COLOR[T_EMPTY] = 0
TYPE_COLOR[T_WALL] = 5
TYPE_COLOR[T_GOAL] = 1

# forward offsets per direction: 0:+x, 1:+y, 2:-x, 3:-y
_FWD = np.asarray([[1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.int32)


@functools.lru_cache(maxsize=32)
def _grid_np(size: int, view: int) -> np.ndarray:
  """Padded [size+2v, size+2v] type map; pad reads as wall."""
  g = np.full((size, size), T_EMPTY, dtype=np.uint8)
  g[0, :] = g[-1, :] = T_WALL
  g[:, 0] = g[:, -1] = T_WALL
  g[size - 2, size - 2] = T_GOAL  # grid[y][x]; goal at x=w-2, y=h-2
  return np.pad(g, view, constant_values=T_WALL)


def _view_offsets_np(size: int, view: int) -> np.ndarray:
  """[4, view, view] int64: per direction, the flat offset into the padded
  map of each image cell (after rotation and transpose) from the agent's
  cell ``(y + view) * G + (x + view)``, G = size + 2 * view."""
  g = size + 2 * view
  half = view // 2
  # top-left corner of the view relative to the agent, (dx, dy) per
  # direction (impl/minigrid_env.cc:160-177)
  tops = [(0, -half), (-half, 0), (-view + 1, -half), (-half, -view + 1)]
  i, j = np.meshgrid(np.arange(view), np.arange(view), indexing="ij")
  out = np.empty((4, view, view), np.int64)
  for d, (dx, dy) in enumerate(tops):
    window = (dy + i) * g + (dx + j)  # window[r][c] = grid[top_y + r][top_x + c]
    # rotate counter-clockwise dir + 1 times (impl/minigrid_env.cc:195-205):
    # copy[v-1-x][y] = win[y][x], i.e. np.rot90(win, k=-1) per application
    rotated = np.rot90(window, k=-((d + 1) % 4))
    # transpose obs(x, y, c) = view[y][x] (impl/minigrid_env.cc:231-236)
    out[d] = rotated.T
  return out


def _goal_reward(cfg: Any, steps: torch.Tensor) -> torch.Tensor:
  """float32 ``1 - 0.9 * steps / max_steps`` as XLA-CPU computes the JAX
  package's expression: the division by the constant becomes a multiply by
  its float32 reciprocal, 0.9 folds into that constant, and ``1 - x * c``
  is one fused multiply-add (rounded once). Written in float32 order it
  misses by an ulp on about a third of the step counts."""
  c = np.float32(0.9) * (np.float32(1) / np.float32(cfg.max_episode_steps))
  return prng.fma32(steps.to(torch.float32), -float(c), 1.0)


@functools.lru_cache(maxsize=16)
def _device_tables(size: int, view: int, device: torch.device) -> Dict[str, torch.Tensor]:
  return {
    "grid": torch.from_numpy(_grid_np(size, view).ravel()).to(device),
    "offsets": torch.from_numpy(_view_offsets_np(size, view)).to(device),
    "color": torch.from_numpy(TYPE_COLOR).to(device),
    "fwd": torch.from_numpy(_FWD).to(device),
  }


def _tables(cfg: Any, device: torch.device) -> Dict[str, torch.Tensor]:
  return _device_tables(int(cfg.size), int(cfg.agent_view_size), device)


class EmptyEnv(FuncEnv):
  """MiniGrid-Empty-*."""

  name = "Empty"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    # empty.h:31-35; agent_start_pos flattened to two config ints
    return {
      "size": 8,
      "agent_start_pos_x": 1,
      "agent_start_pos_y": 1,
      "agent_start_dir": 0,
      "agent_view_size": 7,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    v = int(cfg.agent_view_size)
    return {
      "obs:direction": ArraySpec(np.int32, (-1,), 0, 3),
      "obs:image": ArraySpec(np.uint8, (v, v, 3), 0, 255),
      "info:agent_pos": ArraySpec(np.int32, (2,), 0, int(cfg.size)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, 6)}

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor) -> Tuple[Any, Any, Dict]:
    del state
    n, device = keys.shape[0], keys.device
    size = int(cfg.size)
    sx, sy = int(cfg.agent_start_pos_x), int(cfg.agent_start_pos_y)
    sdir = int(cfg.agent_start_dir)
    if sx == -1:
      # random placement on an empty interior cell: uniform over the
      # (size-2)^2 - 1 non-goal cells (rejection-equivalent,
      # impl/minigrid_env.cc:132-150)
      kp, kd = prng.split(keys, 2).unbind(1)
      n_int = (size - 2) * (size - 2)
      goal_idx = n_int - 1  # (x=size-2, y=size-2) is last interior cell
      j = prng.randint(kp, (), 0, n_int - 1)
      j = torch.where(j >= goal_idx, j + 1, j)
      pos = torch.stack([j % (size - 2) + 1, j // (size - 2) + 1], 1)
      if sdir == -1:
        direction = prng.randint(kd, (), 0, 4)
      else:
        direction = torch.full((n,), sdir, dtype=torch.int32, device=device)
    else:
      # two fills on the device, not a host-to-device copy (it may be captured)
      pos = torch.stack([
        torch.full((n,), sx, dtype=torch.int32, device=device),
        torch.full((n,), sy, dtype=torch.int32, device=device),
      ], 1)
      direction = torch.full((n,), sdir, dtype=torch.int32, device=device)
    st = {
      "pos": pos.to(torch.int32).contiguous(), "dir": direction,
      "steps": torch.zeros(n, dtype=torch.int32, device=device),
    }
    return st, cls._obs(cfg, st), {"agent_pos": st["pos"]}

  @classmethod
  def step(
    cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor
  ) -> Tuple[Any, Any, torch.Tensor, torch.Tensor, Dict]:
    del keys
    tab = _tables(cfg, state["pos"].device)
    size, view = int(cfg.size), int(cfg.agent_view_size)
    g = size + 2 * view
    pos, direction = state["pos"], state["dir"]
    steps = state["steps"] + 1

    fwd = pos + tab["fwd"][direction.long()]
    fwd_type = tab["grid"][(fwd[:, 1] + view) * g + fwd[:, 0] + view]

    direction = torch.where(
      action == ACT_LEFT, (direction + 3) % 4,
      torch.where(action == ACT_RIGHT, (direction + 1) % 4, direction),
    )
    is_fwd = action == ACT_FORWARD
    can_overlap = (fwd_type == T_EMPTY) | (fwd_type == T_GOAL)
    pos = torch.where((is_fwd & can_overlap)[:, None], fwd, pos)
    reached_goal = is_fwd & (fwd_type == T_GOAL)
    reward = torch.where(reached_goal, _goal_reward(cfg, steps), 0.0)

    st = {"pos": pos, "dir": direction, "steps": steps}
    return st, cls._obs(cfg, st), reward, reached_goal, {"agent_pos": pos}

  @classmethod
  def _obs(cls, cfg: Any, st: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    view = int(cfg.agent_view_size)
    g = int(cfg.size) + 2 * view
    tab = _tables(cfg, st["pos"].device)
    pos, direction = st["pos"], st["dir"]
    center = (pos[:, 1] + view) * g + pos[:, 0] + view
    idx = center[:, None, None] + tab["offsets"][direction.long()]
    types = tab["grid"][idx]  # [N, view, view], already rotated and transposed
    # the agent's own cell (rotated [view-1, view//2]) shows what it
    # carries: nothing, so empty
    types[:, view // 2, view - 1] = T_EMPTY
    img = torch.stack([types, tab["color"][types.long()], torch.zeros_like(types)], -1)
    return {"direction": direction, "image": img}
