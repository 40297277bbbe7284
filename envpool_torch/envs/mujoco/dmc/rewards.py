"""dm_control's reward ``tolerance`` on host floats and its sigmoid names,
the port's own copy of ``envpool_tpu/envs/mujoco/dmc/rewards.py``.

Exact re-implementation of ``envpool/mujoco/dmc/utils.cc:176-245`` (itself
dm_control's ``utils/rewards.py``): value 1 inside [bound_min, bound_max],
falling off through the chosen sigmoid outside, reaching
``value_at_margin`` at distance ``margin``. The host tier's domains
(``domains.py``) use it; the device tier has ``device_rewards.py``.
"""

from __future__ import annotations

import math

GAUSSIAN = "gaussian"
HYPERBOLIC = "hyperbolic"
LONG_TAIL = "long_tail"
RECIPROCAL = "reciprocal"
COSINE = "cosine"
LINEAR = "linear"
QUADRATIC = "quadratic"
TANH_SQUARED = "tanh_squared"


def tolerance(
  x: float,
  bound_min: float = 0.0,
  bound_max: float = 0.0,
  margin: float = 0.0,
  value_at_margin: float = 0.1,
  sigmoid: str = GAUSSIAN,
) -> float:
  if bound_min <= x <= bound_max:
    return 1.0
  if margin <= 0.0:
    return 0.0
  d = (bound_min - x if x < bound_min else x - bound_max) / margin
  if sigmoid == GAUSSIAN:
    scaled = math.sqrt(-2 * math.log(value_at_margin)) * d
    return math.exp(-0.5 * scaled * scaled)
  if sigmoid == HYPERBOLIC:
    scaled = math.acosh(1 / value_at_margin) * d
    return 1 / math.cosh(scaled)
  if sigmoid == LONG_TAIL:
    scaled = math.sqrt(1 / value_at_margin - 1) * d
    return 1 / (scaled * scaled + 1)
  if sigmoid == RECIPROCAL:
    scale = 1 / value_at_margin - 1
    return 1 / (abs(d) * scale + 1)
  if sigmoid == COSINE:
    scale = math.acos(2 * value_at_margin - 1) / math.pi
    scaled = d * scale
    return (1 + math.cos(math.pi * scaled)) / 2 if abs(scaled) < 1 else 0.0
  if sigmoid == LINEAR:
    scale = 1 - value_at_margin
    scaled = d * scale
    return 1 - scaled if abs(scaled) < 1 else 0.0
  if sigmoid == QUADRATIC:
    scale = math.sqrt(1 - value_at_margin)
    scaled = d * scale
    return 1 - scaled * scaled if abs(scaled) < 1 else 0.0
  if sigmoid == TANH_SQUARED:
    scale = math.atanh(math.sqrt(1 - value_at_margin))
    t = math.tanh(d * scale)
    return 1 - t * t
  raise ValueError(f"Unknown sigmoid {sigmoid}")
