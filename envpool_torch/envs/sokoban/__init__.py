"""Sokoban family of the port (Sokoban-v0)."""

from envpool_torch.core.envpool_api import py_env

from .sokoban import SokobanEnv

(
  SokobanEnvSpec,
  SokobanDMEnvPool,
  SokobanGymEnvPool,
  SokobanGymnasiumEnvPool,
) = py_env(SokobanEnv)

__all__ = [
  "SokobanEnv",
  "SokobanEnvSpec",
  "SokobanDMEnvPool",
  "SokobanGymEnvPool",
  "SokobanGymnasiumEnvPool",
]
