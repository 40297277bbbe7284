"""Entry point importing every ported family's registration, in the JAX
package's order (``envpool_tpu/entry.py``).

The families that need an optional wheel (procgen, vizdoom) are skipped
only where that wheel is absent: any other import failure propagates, so
a broken module of the port never drops out of the registry unseen.
"""

import importlib

import envpool_torch.envs.dummy.registration  # noqa: F401
import envpool_torch.envs.classic_control.registration  # noqa: F401
import envpool_torch.envs.toy_text.registration  # noqa: F401
import envpool_torch.envs.box2d.registration  # noqa: F401
import envpool_torch.envs.atari.registration  # noqa: F401
import envpool_torch.envs.mujoco.registration  # noqa: F401
import envpool_torch.envs.mujoco.dmc.registration  # noqa: F401
import envpool_torch.envs.minigrid.registration  # noqa: F401


def _register_if_installed(module: str, wheel: str) -> None:
  """Import ``module``, a registration that needs the package ``wheel``;
  skip it if and only if ``wheel`` itself is missing."""
  try:
    importlib.import_module(module)
  except ModuleNotFoundError as e:
    if e.name != wheel:
      raise


_register_if_installed("envpool_torch.envs.procgen.registration", "procgen")
_register_if_installed("envpool_torch.envs.vizdoom.registration", "vizdoom")

import envpool_torch.envs.sokoban.registration  # noqa: E402,F401
