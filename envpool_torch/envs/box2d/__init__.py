"""Box2D family of the port (CarRacing-v2, LunarLander, BipedalWalker)."""

from envpool_torch.core.envpool_api import py_env

from .bipedal_walker import BipedalWalkerEnv, BipedalWalkerHardcoreEnv
from .car_racing import CarRacingEnv
from .lunar_lander import LunarLanderContinuousEnv, LunarLanderEnv

(
  CarRacingEnvSpec,
  CarRacingDMEnvPool,
  CarRacingGymEnvPool,
  CarRacingGymnasiumEnvPool,
) = py_env(CarRacingEnv)

(
  BipedalWalkerEnvSpec,
  BipedalWalkerDMEnvPool,
  BipedalWalkerGymEnvPool,
  BipedalWalkerGymnasiumEnvPool,
) = py_env(BipedalWalkerEnv)

(
  BipedalWalkerHardcoreEnvSpec,
  BipedalWalkerHardcoreDMEnvPool,
  BipedalWalkerHardcoreGymEnvPool,
  BipedalWalkerHardcoreGymnasiumEnvPool,
) = py_env(BipedalWalkerHardcoreEnv)

(
  LunarLanderEnvSpec,
  LunarLanderDMEnvPool,
  LunarLanderGymEnvPool,
  LunarLanderGymnasiumEnvPool,
) = py_env(LunarLanderEnv)

(
  LunarLanderContinuousEnvSpec,
  LunarLanderContinuousDMEnvPool,
  LunarLanderContinuousGymEnvPool,
  LunarLanderContinuousGymnasiumEnvPool,
) = py_env(LunarLanderContinuousEnv)

__all__ = [
  "CarRacingEnv",
  "CarRacingEnvSpec",
  "CarRacingDMEnvPool",
  "CarRacingGymEnvPool",
  "CarRacingGymnasiumEnvPool",
  "BipedalWalkerEnv",
  "BipedalWalkerHardcoreEnv",
  "BipedalWalkerEnvSpec",
  "BipedalWalkerDMEnvPool",
  "BipedalWalkerGymEnvPool",
  "BipedalWalkerGymnasiumEnvPool",
  "BipedalWalkerHardcoreEnvSpec",
  "BipedalWalkerHardcoreDMEnvPool",
  "BipedalWalkerHardcoreGymEnvPool",
  "BipedalWalkerHardcoreGymnasiumEnvPool",
  "LunarLanderEnv",
  "LunarLanderContinuousEnv",
  "LunarLanderEnvSpec",
  "LunarLanderDMEnvPool",
  "LunarLanderGymEnvPool",
  "LunarLanderGymnasiumEnvPool",
  "LunarLanderContinuousEnvSpec",
  "LunarLanderContinuousDMEnvPool",
  "LunarLanderContinuousGymEnvPool",
  "LunarLanderContinuousGymnasiumEnvPool",
]
