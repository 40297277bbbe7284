"""ViZDoom family of the port (host tier; requires the ``vizdoom`` wheel).

``action_set`` (combined-action discretization) is pure and always
importable; the env/pool classes exist only where ``vizdoom`` imports —
without it, touching them raises ImportError (the failure the registry
expects). Any other import failure propagates.
"""

from . import action_set  # noqa: F401  -- pure, wheel-free

try:
  import vizdoom  # noqa: F401
  _IMPORT_ERROR = None
except ModuleNotFoundError as _e:  # the wheel is absent
  if _e.name != "vizdoom":
    raise
  _IMPORT_ERROR = _e

__all__ = [
  "action_set",
  "VizdoomEnv",
  "VizdoomEnvSpec",
  "VizdoomDMEnvPool",
  "VizdoomGymEnvPool",
  "VizdoomGymnasiumEnvPool",
]

if _IMPORT_ERROR is None:
  from envpool_torch.core.envpool_api import py_env
  from envpool_torch.core.host_pool import HostEnvPool

  from .vizdoom_env import VizdoomEnv

  (
    VizdoomEnvSpec,
    VizdoomDMEnvPool,
    VizdoomGymEnvPool,
    VizdoomGymnasiumEnvPool,
  ) = py_env(VizdoomEnv, pool_base=HostEnvPool)
else:

  def __getattr__(name: str):
    if name in __all__:
      raise ImportError(
        f"envpool_torch.envs.vizdoom.{name} requires the 'vizdoom' wheel"
      ) from _IMPORT_ERROR
    raise AttributeError(name)
