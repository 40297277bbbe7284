"""dm_control-suite family of the port: the on-device ``...Jax-v1`` tier
(``device_domains.py``), all 15 of its domains. The host tier comes in a
later slice."""

from envpool_torch.core.envpool_api import py_env

from .device_domains import (
  DmcAcrobotJaxEnv,
  DmcBallInCupJaxEnv,
  DmcCartpoleJaxEnv,
  DmcCheetahJaxEnv,
  DmcFingerJaxEnv,
  DmcFishJaxEnv,
  DmcHopperJaxEnv,
  DmcHumanoidCMUJaxEnv,
  DmcHumanoidJaxEnv,
  DmcManipulatorJaxEnv,
  DmcPendulumJaxEnv,
  DmcPointMassJaxEnv,
  DmcReacherJaxEnv,
  DmcSwimmerJaxEnv,
  DmcWalkerJaxEnv,
)

__all__ = []

for _env_cls in (
  DmcAcrobotJaxEnv, DmcBallInCupJaxEnv, DmcCartpoleJaxEnv,
  DmcCheetahJaxEnv, DmcFingerJaxEnv, DmcFishJaxEnv, DmcHopperJaxEnv,
  DmcHumanoidJaxEnv, DmcHumanoidCMUJaxEnv, DmcManipulatorJaxEnv,
  DmcPendulumJaxEnv, DmcPointMassJaxEnv,
  DmcReacherJaxEnv, DmcSwimmerJaxEnv, DmcWalkerJaxEnv,
):
  _spec, _dm, _gym, _gymnasium = py_env(_env_cls)
  _name = _env_cls.name  # "DmcPendulumJax" etc.
  globals()[f"{_name}EnvSpec"] = _spec
  globals()[f"{_name}DMEnvPool"] = _dm
  globals()[f"{_name}GymEnvPool"] = _gym
  globals()[f"{_name}GymnasiumEnvPool"] = _gymnasium
  __all__ += [
    f"{_name}EnvSpec", f"{_name}DMEnvPool",
    f"{_name}GymEnvPool", f"{_name}GymnasiumEnvPool",
  ]
