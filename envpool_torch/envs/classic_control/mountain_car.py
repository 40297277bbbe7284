"""MountainCar (discrete and continuous) — batched PyTorch dynamics.

The port of ``envpool_tpu/envs/classic_control/mountain_car.py`` (parity
targets ``envpool/classic_control/mountain_car.h:30-120`` and
``mountain_car_continuous.h:30-124``), float32 in the JAX code's order of
operations.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec

_MIN_POS = -1.2
_MAX_POS = 0.6
_MAX_SPEED = 0.07
_GRAVITY = 0.0025


def _reset_state(keys: torch.Tensor) -> Dict[str, torch.Tensor]:
  pos = prng.uniform(keys, (), -0.6, -0.4)
  return {"pos": pos, "vel": torch.zeros_like(pos)}


def _obs(state: Dict[str, torch.Tensor]) -> torch.Tensor:
  return torch.stack([state["pos"], state["vel"]], 1).to(torch.float32)


def _integrate(pos: torch.Tensor, vel: torch.Tensor, push: torch.Tensor):
  """Shared hill-climb update with the reference's boundary handling."""
  vel = vel + push - torch.cos(3 * pos) * _GRAVITY
  vel = torch.clamp(vel, -_MAX_SPEED, _MAX_SPEED)
  pos = torch.clamp(pos + vel, _MIN_POS, _MAX_POS)
  vel = torch.where((pos == _MIN_POS) & (vel < 0), 0.0, vel)
  return pos, vel


class MountainCarEnv(FuncEnv):
  """MountainCar-v0 (3 discrete actions)."""

  name = "MountainCar"
  _FORCE = 0.001
  _GOAL_POS = 0.5

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"reward_threshold": -110.0}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (2,), [-1.2, -0.07], [0.6, 0.07])
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, 2)}

  @staticmethod
  def reset(cfg: Any, state: Any, keys: torch.Tensor):
    del state
    new = _reset_state(keys)
    return new, _obs(new), {}

  @classmethod
  def step(cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor):
    del keys
    push = (action.reshape(-1).to(torch.float32) - 1.0) * cls._FORCE
    pos, vel = _integrate(state["pos"], state["vel"], push)
    term = (pos >= cls._GOAL_POS) & (vel >= 0.0)
    new = {"pos": pos, "vel": vel}
    return new, _obs(new), torch.full_like(pos, -1.0), term, {}


class MountainCarContinuousEnv(FuncEnv):
  """MountainCarContinuous-v0 (1-d continuous action)."""

  name = "MountainCarContinuous"
  _POWER = 0.0015
  _GOAL_POS = 0.45

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"reward_threshold": 90.0}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (2,), [-1.2, -0.07], [0.6, 0.07])
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 1), -1.0, 1.0)}

  @staticmethod
  def reset(cfg: Any, state: Any, keys: torch.Tensor):
    del state
    new = _reset_state(keys)
    return new, _obs(new), {}

  @classmethod
  def step(cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor):
    del keys
    raw = action[:, 0]
    # the reward penalty uses the raw (unclamped) action, as the reference does
    reward = -0.1 * raw * raw
    act = torch.clamp(raw, -1.0, 1.0)
    pos, vel = _integrate(state["pos"], state["vel"], act * cls._POWER)
    term = (pos >= cls._GOAL_POS) & (vel >= 0.0)
    reward = torch.where(term, reward + 100.0, reward)
    new = {"pos": pos, "vel": vel}
    return new, _obs(new), reward.to(torch.float32), term, {}
