"""Box2D task registration of the port; the same ids and default kwargs as
``envpool_tpu/envs/box2d/registration.py``."""

from envpool_torch.registration import register

register(
  task_id="LunarLander-v2",
  import_path="envpool_torch.envs.box2d",
  spec_cls="LunarLanderEnvSpec",
  dm_cls="LunarLanderDMEnvPool",
  gym_cls="LunarLanderGymEnvPool",
  gymnasium_cls="LunarLanderGymnasiumEnvPool",
  max_episode_steps=1000,
)

register(
  task_id="LunarLanderContinuous-v2",
  import_path="envpool_torch.envs.box2d",
  spec_cls="LunarLanderContinuousEnvSpec",
  dm_cls="LunarLanderContinuousDMEnvPool",
  gym_cls="LunarLanderContinuousGymEnvPool",
  gymnasium_cls="LunarLanderContinuousGymnasiumEnvPool",
  max_episode_steps=1000,
)

for _task, _cls in [
  ("BipedalWalker-v3", "BipedalWalker"),
  ("BipedalWalkerHardcore-v3", "BipedalWalkerHardcore"),
]:
  register(
    task_id=_task,
    import_path="envpool_torch.envs.box2d",
    spec_cls=f"{_cls}EnvSpec",
    dm_cls=f"{_cls}DMEnvPool",
    gym_cls=f"{_cls}GymEnvPool",
    gymnasium_cls=f"{_cls}GymnasiumEnvPool",
    max_episode_steps=1600 if _cls == "BipedalWalker" else 2000,
  )

register(
  task_id="CarRacing-v2",
  import_path="envpool_torch.envs.box2d",
  spec_cls="CarRacingEnvSpec",
  dm_cls="CarRacingDMEnvPool",
  gym_cls="CarRacingGymEnvPool",
  gymnasium_cls="CarRacingGymnasiumEnvPool",
  max_episode_steps=1000,
)
