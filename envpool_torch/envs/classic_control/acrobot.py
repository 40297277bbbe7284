"""Acrobot — batched PyTorch dynamics with RK4 integration.

The port of ``envpool_tpu/envs/classic_control/acrobot.py`` (parity target
``envpool/classic_control/acrobot.h:30-212``, gym's "book" dynamics): RK4
over [theta1, theta2, dtheta1, dtheta2, torque], angle wrap to [-pi, pi),
velocity clamps at 4π/9π, reward -1 until the tip crosses the line
(-cos(s0) - cos(s0+s1) > 1 -> reward 0, terminal). The state is ``[N, 5]``
float32 and every expression keeps the JAX code's order of operations (and
so its Python-folded constants); XLA contracts multiply-adds and its trig
may differ by an ulp, so the parity test holds the state to a float
tolerance.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec

from .pendulum import angle_wrap

_G = 9.8
_DT = 0.2
_L = 1.0
_M = 1.0
_LC = 0.5
_I = 1.0
_MAX_VEL1 = 4 * math.pi
_MAX_VEL2 = 9 * math.pi
_INIT_RANGE = 0.1


def _derivs(s: torch.Tensor) -> torch.Tensor:
  theta1, theta2, dtheta1, dtheta2, a = s.unbind(1)
  d1 = (
    _M * _LC * _LC +
    _M * (_L * _L + _LC * _LC + 2 * _L * _LC * torch.cos(theta2)) + _I * 2
  )
  d2 = _M * (_LC * _LC + _L * _LC * torch.cos(theta2)) + _I
  phi2 = _M * _LC * _G * torch.cos(theta1 + theta2 - math.pi / 2)
  phi1 = (
    -(dtheta2 + 2 * dtheta1) * _M * _L * _LC * dtheta2 * torch.sin(theta2) +
    _M * (_LC + _L) * _G * torch.cos(theta1 - math.pi / 2) + phi2
  )
  ddtheta2 = (
    a + d2 / d1 * phi1 -
    _M * _L * _LC * dtheta1 * dtheta1 * torch.sin(theta2) - phi2
  ) / (_M * _LC * _LC + _I - d2 * d2 / d1)
  ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
  return torch.stack(
    [dtheta1, dtheta2, ddtheta1, ddtheta2, torch.zeros_like(a)], 1
  )


def _rk4(y0: torch.Tensor) -> torch.Tensor:
  k1 = _derivs(y0)
  k2 = _derivs(y0 + k1 * (_DT / 2))
  k3 = _derivs(y0 + k2 * (_DT / 2))
  k4 = _derivs(y0 + k3 * _DT)
  return y0 + (k1 + k2 * 2 + k3 * 2 + k4) * (_DT / 6.0)


class AcrobotEnv(FuncEnv):
  """Acrobot-v1."""

  name = "Acrobot"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"reward_threshold": -100.0}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(
        np.float32, (6,),
        [-1.0, -1.0, -1.0, -1.0, -4 * math.pi, -9 * math.pi],
        [1.0, 1.0, 1.0, 1.0, 4 * math.pi, 9 * math.pi],
      ),
      "info:state": ArraySpec(np.float32, (2,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, 2)}

  @staticmethod
  def _out(s: torch.Tensor):
    obs = torch.stack(
      [
        torch.cos(s[:, 0]), torch.sin(s[:, 0]), torch.cos(s[:, 1]),
        torch.sin(s[:, 1]), s[:, 2], s[:, 3],
      ], 1
    ).to(torch.float32)
    return obs, {"state": s[:, :2].to(torch.float32)}

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    s4 = prng.uniform(keys, (4,), -_INIT_RANGE, _INIT_RANGE)
    s = torch.cat([s4, torch.zeros_like(s4[:, :1])], 1)
    obs, info = cls._out(s)
    return {"s": s}, obs, info

  @classmethod
  def step(cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor):
    del keys
    s = state["s"].clone()
    s[:, 4] = action.reshape(-1).to(torch.float32) - 1.0
    s = _rk4(s)
    s = torch.stack([
      angle_wrap(s[:, 0]), angle_wrap(s[:, 1]),
      torch.clamp(s[:, 2], -_MAX_VEL1, _MAX_VEL1),
      torch.clamp(s[:, 3], -_MAX_VEL2, _MAX_VEL2), s[:, 4],
    ], 1)
    term = -torch.cos(s[:, 0]) - torch.cos(s[:, 0] + s[:, 1]) > 1
    reward = torch.where(term, 0.0, -1.0).to(torch.float32)
    obs, info = cls._out(s)
    return {"s": s}, obs, reward, term, info
