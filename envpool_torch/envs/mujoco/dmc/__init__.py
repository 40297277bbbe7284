"""dm_control-suite family of the port: the host tier (``domains.py`` over
``base.py``, raw mujoco on the ``HostEnvPool``'s worker threads, models from
``assets.py``) and the on-device ``...Jax-v1`` tier (``device_domains.py``),
15 domains each."""

from envpool_torch.core.envpool_api import py_env
from envpool_torch.core.host_pool import HostEnvPool

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
from .domains import (
  DmcAcrobotEnv,
  DmcBallInCupEnv,
  DmcCartpoleEnv,
  DmcCheetahEnv,
  DmcFingerEnv,
  DmcFishEnv,
  DmcHopperEnv,
  DmcHumanoidCMUEnv,
  DmcHumanoidEnv,
  DmcManipulatorEnv,
  DmcPendulumEnv,
  DmcPointMassEnv,
  DmcReacherEnv,
  DmcSwimmerEnv,
  DmcWalkerEnv,
)

__all__ = []

for _env_cls in (
  DmcAcrobotEnv, DmcBallInCupEnv, DmcCartpoleEnv, DmcCheetahEnv,
  DmcFingerEnv, DmcFishEnv, DmcHopperEnv, DmcHumanoidCMUEnv,
  DmcHumanoidEnv, DmcManipulatorEnv, DmcPendulumEnv, DmcPointMassEnv,
  DmcReacherEnv, DmcSwimmerEnv, DmcWalkerEnv,
):
  _spec, _dm, _gym, _gymnasium = py_env(_env_cls, pool_base=HostEnvPool)
  _name = _env_cls.name  # "DmcPendulum" etc.
  globals()[f"{_name}EnvSpec"] = _spec
  globals()[f"{_name}DMEnvPool"] = _dm
  globals()[f"{_name}GymEnvPool"] = _gym
  globals()[f"{_name}GymnasiumEnvPool"] = _gymnasium
  __all__ += [
    f"{_name}EnvSpec", f"{_name}DMEnvPool",
    f"{_name}GymEnvPool", f"{_name}GymnasiumEnvPool",
  ]

# on-device tier: the TorchEnvPool engine
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
