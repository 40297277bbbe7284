"""Core runtime of the port: specs, functional env interface, the device
pool engine and the host tier's engine, dialects and the threefry PRNG."""

from envpool_torch.core.env import FuncEnv
from envpool_torch.core.env_spec import EnvSpec
from envpool_torch.core.envpool_api import py_env
from envpool_torch.core.host_pool import HostEnv, HostEnvPool
from envpool_torch.core.pool import (
  PoolState,
  TorchEnvPool,
  XlaHandle,
  state_from_numpy,
)
from envpool_torch.core.spec import ArraySpec

__all__ = [
  "ArraySpec",
  "EnvSpec",
  "FuncEnv",
  "HostEnv",
  "HostEnvPool",
  "PoolState",
  "TorchEnvPool",
  "XlaHandle",
  "py_env",
  "state_from_numpy",
]
