"""Procgen family of the port (host tier; requires the ``procgen`` wheel).

Importing this package without the wheel raises ModuleNotFoundError, as
the JAX package's does (``entry.py`` skips the family then).
"""

import procgen  # noqa: F401  -- gate on availability

from envpool_torch.core.envpool_api import py_env
from envpool_torch.core.host_pool import HostEnvPool

from .procgen_env import ProcgenEnv

(
  ProcgenEnvSpec,
  ProcgenDMEnvPool,
  ProcgenGymEnvPool,
  ProcgenGymnasiumEnvPool,
) = py_env(ProcgenEnv, pool_base=HostEnvPool)

__all__ = [
  "ProcgenEnv",
  "ProcgenEnvSpec",
  "ProcgenDMEnvPool",
  "ProcgenGymEnvPool",
  "ProcgenGymnasiumEnvPool",
]
