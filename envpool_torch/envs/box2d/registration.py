"""Box2D task registration of the port (CarRacing only so far); the same
id and default kwargs as ``envpool_tpu/envs/box2d/registration.py``."""

from envpool_torch.registration import register

register(
  task_id="CarRacing-v2",
  import_path="envpool_torch.envs.box2d",
  spec_cls="CarRacingEnvSpec",
  dm_cls="CarRacingDMEnvPool",
  gym_cls="CarRacingGymEnvPool",
  gymnasium_cls="CarRacingGymnasiumEnvPool",
  max_episode_steps=1000,
)
