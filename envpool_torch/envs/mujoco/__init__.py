"""MuJoCo family of the port: the host tier's gym tasks (``gym_tasks.py``,
raw ``mj_step`` on the ``HostEnvPool``'s worker threads; ``mujoco`` and
``gymnasium`` are imported when a pool is built) and the on-device
``-Jax-v4`` tier's tasks (``device_tasks.py`` over ``device_engine.py`` and
``device_collision.py``, models from ``device_model.py``'s committed data).
The dm_control tiers are ``dmc/``."""

from envpool_torch.core.envpool_api import py_env
from envpool_torch.core.host_pool import HostEnvPool

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
from .gym_tasks import (
  AntEnv,
  HalfCheetahEnv,
  HopperEnv,
  HumanoidEnv,
  HumanoidStandupEnv,
  InvertedDoublePendulumEnv,
  InvertedPendulumEnv,
  PusherEnv,
  ReacherEnv,
  SwimmerEnv,
  Walker2dEnv,
)

__all__ = []

for _env_cls in (
  AntEnv, HalfCheetahEnv, HopperEnv, HumanoidEnv, HumanoidStandupEnv,
  InvertedDoublePendulumEnv, InvertedPendulumEnv, PusherEnv, ReacherEnv,
  SwimmerEnv, Walker2dEnv,
):
  _spec, _dm, _gym, _gymnasium = py_env(_env_cls, pool_base=HostEnvPool)
  _name = _env_cls.name
  # class-name prefix "Gym" matches the reference's binding names
  # (``envpool/mujoco/gym/registration.py:47-50``)
  globals()[f"Gym{_name}EnvSpec"] = _spec
  globals()[f"Gym{_name}DMEnvPool"] = _dm
  globals()[f"Gym{_name}GymEnvPool"] = _gym
  globals()[f"Gym{_name}GymnasiumEnvPool"] = _gymnasium
  __all__ += [
    f"Gym{_name}EnvSpec", f"Gym{_name}DMEnvPool",
    f"Gym{_name}GymEnvPool", f"Gym{_name}GymnasiumEnvPool",
  ]

# on-device tier: the TorchEnvPool engine
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
