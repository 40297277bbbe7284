"""Sokoban task registration of the port; the same id and default kwargs as
``envpool_tpu/envs/sokoban/registration.py``."""

from envpool_torch.registration import register

register(
  task_id="Sokoban-v0",
  import_path="envpool_torch.envs.sokoban",
  spec_cls="SokobanEnvSpec",
  dm_cls="SokobanDMEnvPool",
  gym_cls="SokobanGymEnvPool",
  gymnasium_cls="SokobanGymnasiumEnvPool",
  max_episode_steps=60,
  reward_step=-0.1,
  max_num_players=1,
)
