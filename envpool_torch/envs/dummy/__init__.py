"""Dummy family of the port (the engine's test fixture)."""

from envpool_torch.core.envpool_api import py_env

from .dummy import DummyEnv

(
  DummyEnvSpec,
  DummyDMEnvPool,
  DummyGymEnvPool,
  DummyGymnasiumEnvPool,
) = py_env(DummyEnv)

__all__ = [
  "DummyEnv",
  "DummyEnvSpec",
  "DummyDMEnvPool",
  "DummyGymEnvPool",
  "DummyGymnasiumEnvPool",
]
