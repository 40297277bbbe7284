"""MiniGrid family of the port (``envpool_tpu/envs/minigrid``)."""

from envpool_torch.core.envpool_api import py_env

from .minigrid import EmptyEnv

(
  EmptyEnvSpec,
  EmptyDMEnvPool,
  EmptyGymEnvPool,
  EmptyGymnasiumEnvPool,
) = py_env(EmptyEnv)

__all__ = [
  "EmptyEnv",
  "EmptyEnvSpec",
  "EmptyDMEnvPool",
  "EmptyGymEnvPool",
  "EmptyGymnasiumEnvPool",
]
