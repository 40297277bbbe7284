"""FrozenLake — batched PyTorch dynamics.

The port of ``envpool_tpu/envs/toy_text/frozen_lake.py`` (parity target
``envpool/toy_text/frozen_lake.h:30-110``): slippery move
``act = (act + U{-1,0,1} + 4) % 4``, clamped grid walk over the standard
4x4 / 8x8 maps, terminal on Hole (reward 0) or Goal (reward 1).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec

_MAP4 = ["SFFF", "FHFH", "FFFH", "HFFG"]
_MAP8 = [
  "SFFFFFFF", "FFFFFFFF", "FFFHFFFF", "FFFFFHFF", "FFFHFFFF", "FHHFFFHF",
  "FHFFHFHF", "FFFHFFFG"
]


def _tiles(size: int) -> np.ndarray:
  """0=frozen/start, 1=hole, 2=goal."""
  rows = _MAP8 if size == 8 else _MAP4
  code = {"S": 0, "F": 0, "H": 1, "G": 2}
  return np.array([[code[c] for c in r] for r in rows], np.int32)


@functools.lru_cache(maxsize=8)
def _device_tiles(size: int, device: torch.device) -> torch.Tensor:
  return torch.from_numpy(_tiles(size).ravel()).to(device)


class FrozenLakeEnv(FuncEnv):
  """FrozenLake-v1 / FrozenLake8x8-v1."""

  name = "FrozenLake"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"reward_threshold": 0.7, "size": 4}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.int32, (-1,), 0, cfg.size * cfg.size - 1)
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, 3)}

  @staticmethod
  def reset(cfg: Any, state: Any, keys: torch.Tensor):
    del state
    x = torch.zeros(keys.shape[0], dtype=torch.int32, device=keys.device)
    return {"x": x, "y": x}, x, {}

  @staticmethod
  def step(cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor):
    size = cfg.size if cfg.size == 8 else 4
    slip = prng.randint(keys, (), -1, 2)
    act = (action.to(torch.int32) + slip + 4) % 4
    # act: 0 left(-y) 1 down(+x) 2 right(+y) 3 up(-x)
    dx = torch.where(act == 1, 1, torch.where(act == 3, -1, 0))
    dy = torch.where(act == 2, 1, torch.where(act == 0, -1, 0))
    x = torch.clamp(state["x"] + dx, 0, size - 1).to(torch.int32)
    y = torch.clamp(state["y"] + dy, 0, size - 1).to(torch.int32)
    cell = x * size + y
    tile = _device_tiles(size, keys.device)[cell]
    term = tile > 0
    reward = torch.where(tile == 2, 1.0, 0.0).to(torch.float32)
    return {"x": x, "y": y}, cell, reward, term, {}
