"""Classic control family of the port (CartPole-v0/v1 so far)."""

from envpool_torch.core.envpool_api import py_env

from .cartpole import CartPoleEnv

(
  CartPoleEnvSpec,
  CartPoleDMEnvPool,
  CartPoleGymEnvPool,
  CartPoleGymnasiumEnvPool,
) = py_env(CartPoleEnv)

__all__ = [
  "CartPoleEnv",
  "CartPoleEnvSpec",
  "CartPoleDMEnvPool",
  "CartPoleGymEnvPool",
  "CartPoleGymnasiumEnvPool",
]
