"""MuJoCo task registration of the port: the host tier's 22 gym ids and the
on-device ``-Jax-v4`` ids of ``envpool_tpu/envs/mujoco/registration.py``
(``:5-48`` and ``:89-111``), in its order and with the same class names,
``post_constraint`` flags and caps (``envpool/mujoco/gym/registration.py``).
The dm_control ids are registered by ``dmc/registration.py``."""

from envpool_torch.registration import register

for _task, _version, _post_constraint, _max_episode_steps in [
  ("Ant", "v3", False, 1000),
  ("Ant", "v4", True, 1000),
  ("HalfCheetah", "v3", False, 1000),
  ("HalfCheetah", "v4", True, 1000),
  ("Hopper", "v3", False, 1000),
  ("Hopper", "v4", True, 1000),
  ("Humanoid", "v3", False, 1000),
  ("Humanoid", "v4", True, 1000),
  ("HumanoidStandup", "v2", False, 1000),
  ("HumanoidStandup", "v4", True, 1000),
  ("InvertedDoublePendulum", "v2", False, 1000),
  ("InvertedDoublePendulum", "v4", True, 1000),
  ("InvertedPendulum", "v2", False, 1000),
  ("InvertedPendulum", "v4", True, 1000),
  ("Pusher", "v2", False, 100),
  ("Pusher", "v4", True, 100),
  ("Reacher", "v2", False, 50),
  ("Reacher", "v4", True, 50),
  ("Swimmer", "v3", False, 1000),
  ("Swimmer", "v4", True, 1000),
  ("Walker2d", "v3", False, 1000),
  ("Walker2d", "v4", True, 1000),
]:
  _extra_args = {}
  if _task in ["Ant", "Humanoid"] and _version == "v3":
    _extra_args["use_contact_force"] = True
  register(
    task_id=f"{_task}-{_version}",
    import_path="envpool_torch.envs.mujoco",
    spec_cls=f"Gym{_task}EnvSpec",
    dm_cls=f"Gym{_task}DMEnvPool",
    gym_cls=f"Gym{_task}GymEnvPool",
    gymnasium_cls=f"Gym{_task}GymnasiumEnvPool",
    post_constraint=_post_constraint,
    max_episode_steps=_max_episode_steps,
    **_extra_args,
  )

for _task, _max_episode_steps in [
  ("Reacher", 50),
  ("InvertedPendulum", 1000),
  ("InvertedDoublePendulum", 1000),
  ("Swimmer", 1000),
  ("HalfCheetah", 1000),
  ("Hopper", 1000),
  ("Walker2d", 1000),
  ("Ant", 1000),
  ("Humanoid", 1000),
  ("HumanoidStandup", 1000),
  ("Pusher", 100),
]:
  register(
    task_id=f"{_task}Jax-v4",
    import_path="envpool_torch.envs.mujoco",
    spec_cls=f"{_task}JaxEnvSpec",
    dm_cls=f"{_task}JaxDMEnvPool",
    gym_cls=f"{_task}JaxGymEnvPool",
    gymnasium_cls=f"{_task}JaxGymnasiumEnvPool",
    max_episode_steps=_max_episode_steps,
  )
