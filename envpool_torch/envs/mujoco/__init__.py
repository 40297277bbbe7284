"""MuJoCo family of the port: the on-device ``-Jax-v4`` tier's tasks
(``device_tasks.py`` over ``device_engine.py`` and ``device_collision.py``,
models from ``device_model.py``'s committed data). The dm_control
``-Jax-v1`` tier is ``dmc/``; the host tier comes in a later slice."""

from envpool_torch.core.envpool_api import py_env

from .device_tasks import (
  AntJaxEnv,
  HalfCheetahJaxEnv,
  HopperJaxEnv,
  HumanoidJaxEnv,
  HumanoidStandupJaxEnv,
  InvertedDoublePendulumJaxEnv,
  InvertedPendulumJaxEnv,
  PusherJaxEnv,
  ReacherJaxEnv,
  SwimmerJaxEnv,
  Walker2dJaxEnv,
)

__all__ = []

for _env_cls in (
  ReacherJaxEnv, InvertedPendulumJaxEnv, InvertedDoublePendulumJaxEnv,
  SwimmerJaxEnv, HalfCheetahJaxEnv, HopperJaxEnv, Walker2dJaxEnv, AntJaxEnv,
  HumanoidJaxEnv, HumanoidStandupJaxEnv, PusherJaxEnv,
):
  _spec, _dm, _gym, _gymnasium = py_env(_env_cls)
  _name = _env_cls.name
  globals()[f"{_name}EnvSpec"] = _spec
  globals()[f"{_name}DMEnvPool"] = _dm
  globals()[f"{_name}GymEnvPool"] = _gym
  globals()[f"{_name}GymnasiumEnvPool"] = _gymnasium
  __all__ += [
    f"{_name}EnvSpec", f"{_name}DMEnvPool",
    f"{_name}GymEnvPool", f"{_name}GymnasiumEnvPool",
  ]
