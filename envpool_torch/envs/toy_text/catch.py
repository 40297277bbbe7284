"""Catch (bsuite) — batched PyTorch dynamics.

The port of ``envpool_tpu/envs/toy_text/catch.py`` (parity target
``envpool/toy_text/catch.h:30-100``): height x width board, ball falls one
row per step, paddle moves {-1,0,+1}, reward ±1 when the ball reaches the
bottom row. Obs renders ball + paddle as ones.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec


class CatchEnv(FuncEnv):
  """Catch-v0."""

  name = "Catch"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"height": 10, "width": 5}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (cfg.height, cfg.width), 0.0, 1.0)
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, 2)}

  @staticmethod
  def _obs(cfg: Any, x, y, paddle) -> torch.Tensor:
    h, w = int(cfg.height), int(cfg.width)
    rows = torch.arange(h, device=x.device)[None, :, None]
    cols = torch.arange(w, device=x.device)[None, None, :]
    ball = (rows == x[:, None, None]) & (cols == y[:, None, None])
    pad = (rows == h - 1) & (cols == paddle[:, None, None])
    return (ball | pad).to(torch.float32)

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    y = prng.randint(keys, (), 0, int(cfg.width))
    x = torch.zeros_like(y)
    paddle = torch.full_like(y, int(cfg.width) // 2)
    new = {"x": x, "y": y, "paddle": paddle}
    return new, cls._obs(cfg, x, y, paddle), {}

  @classmethod
  def step(cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor):
    del keys
    paddle = torch.clamp(
      state["paddle"] + action.to(torch.int32) - 1, 0, int(cfg.width) - 1
    )
    x = state["x"] + 1
    y = state["y"]
    term = x == int(cfg.height) - 1
    reward = torch.where(
      term, torch.where(y == paddle, 1.0, -1.0), 0.0
    ).to(torch.float32)
    new = {"x": x, "y": y, "paddle": paddle}
    return new, cls._obs(cfg, x, y, paddle), reward, term, {}
