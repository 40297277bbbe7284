"""Atari family of the port: the on-device demo ``PongJaxDemo-v5`` only.

The JAX package's ALE-backed ``AtariEnv`` (``envpool_tpu/envs/atari/
atari_env.py``) and its ``*-v5`` ids run on the host tier, which the port
does not have yet (``ROADMAP.md`` queue 1, item 9); they come with it.
"""

from envpool_torch.core.envpool_api import py_env

from .atari_device_demo import PongDemoEnv

(
  PongDemoEnvSpec,
  PongDemoDMEnvPool,
  PongDemoGymEnvPool,
  PongDemoGymnasiumEnvPool,
) = py_env(PongDemoEnv)

__all__ = [
  "PongDemoEnv",
  "PongDemoEnvSpec",
  "PongDemoDMEnvPool",
  "PongDemoGymEnvPool",
  "PongDemoGymnasiumEnvPool",
]
