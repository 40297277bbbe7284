"""dm_control's reward ``tolerance`` over tensors, the port's copy of
``envpool_tpu/envs/mujoco/dmc/device_rewards.py``: the same branch-free
math as ``envpool/mujoco/dmc/utils.cc:176-245`` (dm_control's
``utils/rewards.py``), elementwise over a batch. ``sigmoid`` is a Python
string; the scale constants are Python floats, as the JAX code's are."""

from __future__ import annotations

import math

import torch

from .rewards import (
  COSINE, GAUSSIAN, HYPERBOLIC, LINEAR, LONG_TAIL, QUADRATIC, RECIPROCAL,
  TANH_SQUARED,
)

__all__ = ["tolerance"]


def tolerance(
  x: torch.Tensor,
  bound_min: float = 0.0,
  bound_max: float = 0.0,
  margin: float = 0.0,
  value_at_margin: float = 0.1,
  sigmoid: str = GAUSSIAN,
) -> torch.Tensor:
  """1 inside [bound_min, bound_max], falling off through ``sigmoid``
  outside it to ``value_at_margin`` at distance ``margin``; with margin 0,
  the indicator of the bounds. In ``x``'s dtype."""
  in_bounds = (bound_min <= x) & (x <= bound_max)
  if margin <= 0.0:
    return in_bounds.to(x.dtype)
  d = torch.where(x < bound_min, bound_min - x, x - bound_max) / margin
  if sigmoid == GAUSSIAN:
    scale = math.sqrt(-2 * math.log(value_at_margin))
    value = torch.exp(-0.5 * torch.square(scale * d))
  elif sigmoid == HYPERBOLIC:
    scale = math.acosh(1 / value_at_margin)
    value = 1 / torch.cosh(scale * d)
  elif sigmoid == LONG_TAIL:
    scale = math.sqrt(1 / value_at_margin - 1)
    value = 1 / (torch.square(scale * d) + 1)
  elif sigmoid == RECIPROCAL:
    scale = 1 / value_at_margin - 1
    value = 1 / (torch.abs(d) * scale + 1)
  elif sigmoid == COSINE:
    scale = math.acos(2 * value_at_margin - 1) / math.pi
    s = d * scale
    value = torch.where(torch.abs(s) < 1, (1 + torch.cos(math.pi * s)) / 2, 0.0)
  elif sigmoid == LINEAR:
    s = d * (1 - value_at_margin)
    value = torch.where(torch.abs(s) < 1, 1 - s, 0.0)
  elif sigmoid == QUADRATIC:
    s = d * math.sqrt(1 - value_at_margin)
    value = torch.where(torch.abs(s) < 1, 1 - torch.square(s), 0.0)
  elif sigmoid == TANH_SQUARED:
    scale = math.atanh(math.sqrt(1 - value_at_margin))
    value = 1 - torch.square(torch.tanh(d * scale))
  else:
    raise ValueError(f"Unknown sigmoid {sigmoid}")
  return torch.where(in_bounds, 1.0, value).to(x.dtype)
