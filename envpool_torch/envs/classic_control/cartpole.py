"""CartPole — batched PyTorch dynamics.

The port of ``envpool_tpu/envs/classic_control/cartpole.py`` (parity
target ``envpool/classic_control/cartpole.h:30-122``): Euler integration
with tau = 0.02, uniform(-0.05, 0.05) init of the four state variables from
the threefry stream, termination at |x| > 2.4 or |theta| > 12 degrees;
reward 1.0 per step. float32 throughout, like the JAX package; XLA may
contract multiply-adds and its trig may differ by an ulp, so the parity
test holds observations to a float tolerance.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec

_GRAVITY = 9.8
_MASS_CART = 1.0
_MASS_POLE = 0.1
_MASS_TOTAL = _MASS_CART + _MASS_POLE
_LENGTH = 0.5
_MASS_POLE_LENGTH = _MASS_POLE * _LENGTH
_FORCE_MAG = 10.0
_TAU = 0.02
_THETA_THRESHOLD = 12 * 2 * math.pi / 360
_X_THRESHOLD = 2.4
_INIT_RANGE = 0.05


class CartPoleEnv(FuncEnv):
  """CartPole-v0/v1."""

  name = "CartPole"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"reward_threshold": 195.0}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    fmax = float(np.finfo(np.float32).max)
    return {
      "obs": ArraySpec(
        np.float32, (4,),
        [-4.8, -fmax, -math.pi / 7.5, -fmax],
        [4.8, fmax, math.pi / 7.5, fmax],
      )
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, 1)}

  @staticmethod
  def reset(cfg: Any, state: Any, keys: torch.Tensor) -> Tuple[Any, Any, Dict]:
    del state
    s = prng.uniform(keys, (4,), -_INIT_RANGE, _INIT_RANGE)
    return {"s": s}, s, {}

  @staticmethod
  def step(
    cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor
  ) -> Tuple[Any, Any, torch.Tensor, torch.Tensor, Dict]:
    del keys
    x, x_dot, theta, theta_dot = state["s"].unbind(1)
    n = x.shape[0]
    force = torch.where(action.reshape(n) == 1, _FORCE_MAG, -_FORCE_MAG)
    costheta = torch.cos(theta)
    sintheta = torch.sin(theta)
    temp = (
      force + _MASS_POLE_LENGTH * theta_dot * theta_dot * sintheta
    ) / _MASS_TOTAL
    theta_acc = (_GRAVITY * sintheta - costheta * temp) / (
      _LENGTH * (4.0 / 3.0 - _MASS_POLE * costheta * costheta / _MASS_TOTAL)
    )
    x_acc = temp - _MASS_POLE_LENGTH * theta_acc * costheta / _MASS_TOTAL

    x = x + _TAU * x_dot
    x_dot = x_dot + _TAU * x_acc
    theta = theta + _TAU * theta_dot
    theta_dot = theta_dot + _TAU * theta_acc
    term = (
      (x < -_X_THRESHOLD) | (x > _X_THRESHOLD) |
      (theta < -_THETA_THRESHOLD) | (theta > _THETA_THRESHOLD)
    )
    s = torch.stack([x, x_dot, theta, theta_dot], 1).to(torch.float32)
    reward = torch.ones(n, dtype=torch.float32, device=s.device)
    return {"s": s}, s, reward, term, {}
