"""Pendulum — batched PyTorch dynamics.

The port of ``envpool_tpu/envs/classic_control/pendulum.py`` (parity
target ``envpool/classic_control/pendulum.h:30-122``). Config key
``version`` switches the v0/v1 integration order (clamp theta_dot before or
after updating theta). The reward is computed from the pre-step state:
``-(theta^2 + 0.1 theta_dot^2 + 0.001 u^2)``; never terminal. float32 in the
JAX package's order of operations; XLA contracts multiply-adds, so the
parity test holds observations and rewards to a float tolerance.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec

_MAX_SPEED = 8.0
_MAX_TORQUE = 2.0
_DT = 0.05
_GRAVITY = 10.0


def angle_wrap(theta: torch.Tensor) -> torch.Tensor:
  """Wrap into [-pi, pi), matching the reference's while loops."""
  return theta - 2 * math.pi * torch.floor((theta + math.pi) / (2 * math.pi))


class PendulumEnv(FuncEnv):
  """Pendulum-v0/v1."""

  name = "Pendulum"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"version": 0}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (3,), [-1.0, -1.0, -8.0], [1.0, 1.0, 8.0])
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 1), -2.0, 2.0)}

  @staticmethod
  def _obs(theta: torch.Tensor, theta_dot: torch.Tensor) -> torch.Tensor:
    return torch.stack(
      [torch.cos(theta), torch.sin(theta), theta_dot], 1
    ).to(torch.float32)

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    k1, k2 = prng.split(keys, 2).unbind(1)
    theta = prng.uniform(k1, (), -math.pi, math.pi)
    theta_dot = prng.uniform(k2, (), -1.0, 1.0)
    return {"theta": theta, "theta_dot": theta_dot}, cls._obs(
      theta, theta_dot
    ), {}

  @classmethod
  def step(cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor):
    del keys
    theta, theta_dot = state["theta"], state["theta_dot"]
    u = torch.clamp(action[:, 0], -_MAX_TORQUE, _MAX_TORQUE)
    cost = theta * theta + 0.1 * theta_dot * theta_dot + 0.001 * u * u
    new_theta_dot = theta_dot + 3 * (
      _GRAVITY / 2 * torch.sin(theta) + u
    ) * _DT
    if cfg.version == 0:
      theta = theta + new_theta_dot * _DT
    theta_dot = torch.clamp(new_theta_dot, -_MAX_SPEED, _MAX_SPEED)
    if cfg.version == 1:
      theta = theta + theta_dot * _DT
    theta = angle_wrap(theta)
    term = torch.zeros_like(theta, dtype=torch.bool)
    new_state = {"theta": theta, "theta_dot": theta_dot}
    return new_state, cls._obs(theta, theta_dot), (-cost).to(
      torch.float32
    ), term, {}
