"""Atari family of the port: the host tier's ALE ``AtariEnv`` with the
reference's wrapper stack (``atari_env.py``, on the ``HostEnvPool``) and the
on-device demo ``PongJaxDemo-v5``.

The module imports without ALE (the wrapper stack is testable against a
scripted emulator); building an Atari spec or pool needs ``ale_py``, and
the ROM ids are registered only where it is installed
(``envpool/entry.py:17-55`` pattern).
"""

from envpool_torch.core.envpool_api import py_env
from envpool_torch.core.host_pool import HostEnvPool

from .atari_device_demo import PongDemoEnv
from .atari_env import AtariEnv

(
  AtariEnvSpec,
  AtariDMEnvPool,
  AtariGymEnvPool,
  AtariGymnasiumEnvPool,
) = py_env(AtariEnv, pool_base=HostEnvPool)

(
  PongDemoEnvSpec,
  PongDemoDMEnvPool,
  PongDemoGymEnvPool,
  PongDemoGymnasiumEnvPool,
) = py_env(PongDemoEnv)

__all__ = [
  "AtariEnv",
  "AtariEnvSpec",
  "AtariDMEnvPool",
  "AtariGymEnvPool",
  "AtariGymnasiumEnvPool",
  "PongDemoEnv",
  "PongDemoEnvSpec",
  "PongDemoDMEnvPool",
  "PongDemoGymEnvPool",
  "PongDemoGymnasiumEnvPool",
]
