"""Classic control family of the port (``envpool_tpu/envs/classic_control``)."""

from envpool_torch.core.envpool_api import py_env

from .acrobot import AcrobotEnv
from .cartpole import CartPoleEnv
from .mountain_car import MountainCarContinuousEnv, MountainCarEnv
from .pendulum import PendulumEnv

(
  CartPoleEnvSpec,
  CartPoleDMEnvPool,
  CartPoleGymEnvPool,
  CartPoleGymnasiumEnvPool,
) = py_env(CartPoleEnv)

(
  PendulumEnvSpec,
  PendulumDMEnvPool,
  PendulumGymEnvPool,
  PendulumGymnasiumEnvPool,
) = py_env(PendulumEnv)

(
  MountainCarEnvSpec,
  MountainCarDMEnvPool,
  MountainCarGymEnvPool,
  MountainCarGymnasiumEnvPool,
) = py_env(MountainCarEnv)

(
  MountainCarContinuousEnvSpec,
  MountainCarContinuousDMEnvPool,
  MountainCarContinuousGymEnvPool,
  MountainCarContinuousGymnasiumEnvPool,
) = py_env(MountainCarContinuousEnv)

(
  AcrobotEnvSpec,
  AcrobotDMEnvPool,
  AcrobotGymEnvPool,
  AcrobotGymnasiumEnvPool,
) = py_env(AcrobotEnv)

__all__ = [
  "AcrobotEnv",
  "CartPoleEnv",
  "MountainCarContinuousEnv",
  "MountainCarEnv",
  "PendulumEnv",
  "CartPoleEnvSpec",
  "CartPoleDMEnvPool",
  "CartPoleGymEnvPool",
  "CartPoleGymnasiumEnvPool",
  "PendulumEnvSpec",
  "PendulumDMEnvPool",
  "PendulumGymEnvPool",
  "PendulumGymnasiumEnvPool",
  "MountainCarEnvSpec",
  "MountainCarDMEnvPool",
  "MountainCarGymEnvPool",
  "MountainCarGymnasiumEnvPool",
  "MountainCarContinuousEnvSpec",
  "MountainCarContinuousDMEnvPool",
  "MountainCarContinuousGymEnvPool",
  "MountainCarContinuousGymnasiumEnvPool",
  "AcrobotEnvSpec",
  "AcrobotDMEnvPool",
  "AcrobotGymEnvPool",
  "AcrobotGymnasiumEnvPool",
]
