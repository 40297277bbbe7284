"""Toy text family of the port (``envpool_tpu/envs/toy_text``)."""

from envpool_torch.core.envpool_api import py_env

from .blackjack import BlackjackEnv
from .catch import CatchEnv
from .cliffwalking import CliffWalkingEnv
from .frozen_lake import FrozenLakeEnv
from .nchain import NChainEnv
from .taxi import TaxiEnv

(
  CatchEnvSpec,
  CatchDMEnvPool,
  CatchGymEnvPool,
  CatchGymnasiumEnvPool,
) = py_env(CatchEnv)

(
  FrozenLakeEnvSpec,
  FrozenLakeDMEnvPool,
  FrozenLakeGymEnvPool,
  FrozenLakeGymnasiumEnvPool,
) = py_env(FrozenLakeEnv)

(
  CliffWalkingEnvSpec,
  CliffWalkingDMEnvPool,
  CliffWalkingGymEnvPool,
  CliffWalkingGymnasiumEnvPool,
) = py_env(CliffWalkingEnv)

(
  BlackjackEnvSpec,
  BlackjackDMEnvPool,
  BlackjackGymEnvPool,
  BlackjackGymnasiumEnvPool,
) = py_env(BlackjackEnv)

(
  TaxiEnvSpec,
  TaxiDMEnvPool,
  TaxiGymEnvPool,
  TaxiGymnasiumEnvPool,
) = py_env(TaxiEnv)

(
  NChainEnvSpec,
  NChainDMEnvPool,
  NChainGymEnvPool,
  NChainGymnasiumEnvPool,
) = py_env(NChainEnv)

__all__ = [
  "BlackjackEnv", "CatchEnv", "CliffWalkingEnv", "FrozenLakeEnv",
  "NChainEnv", "TaxiEnv",
  "CatchEnvSpec", "CatchDMEnvPool", "CatchGymEnvPool",
  "CatchGymnasiumEnvPool",
  "FrozenLakeEnvSpec", "FrozenLakeDMEnvPool", "FrozenLakeGymEnvPool",
  "FrozenLakeGymnasiumEnvPool",
  "CliffWalkingEnvSpec", "CliffWalkingDMEnvPool", "CliffWalkingGymEnvPool",
  "CliffWalkingGymnasiumEnvPool",
  "BlackjackEnvSpec", "BlackjackDMEnvPool", "BlackjackGymEnvPool",
  "BlackjackGymnasiumEnvPool",
  "TaxiEnvSpec", "TaxiDMEnvPool", "TaxiGymEnvPool",
  "TaxiGymnasiumEnvPool",
  "NChainEnvSpec", "NChainDMEnvPool", "NChainGymEnvPool",
  "NChainGymnasiumEnvPool",
]
