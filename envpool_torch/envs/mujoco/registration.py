"""MuJoCo task registration of the port: the on-device ``-Jax-v4`` ids of
``envpool_tpu/envs/mujoco/registration.py:89-111``, in its order and with
the same class names and caps. The host tier waits for its slice; the
dm_control ``-Jax-v1`` ids are registered by ``dmc/registration.py``."""

from envpool_torch.registration import register

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
