"""Box2D family of the port (CarRacing-v2)."""

from envpool_torch.core.envpool_api import py_env

from .car_racing import CarRacingEnv

(
  CarRacingEnvSpec,
  CarRacingDMEnvPool,
  CarRacingGymEnvPool,
  CarRacingGymnasiumEnvPool,
) = py_env(CarRacingEnv)

__all__ = [
  "CarRacingEnv",
  "CarRacingEnvSpec",
  "CarRacingDMEnvPool",
  "CarRacingGymEnvPool",
  "CarRacingGymnasiumEnvPool",
]
