"""Dummy task registration of the port (engine test fixture); the same id
and default kwargs as ``envpool_tpu/envs/dummy/registration.py``."""

from envpool_torch.registration import register

register(
  task_id="Dummy-v0",
  import_path="envpool_torch.envs.dummy",
  spec_cls="DummyEnvSpec",
  dm_cls="DummyDMEnvPool",
  gym_cls="DummyGymEnvPool",
  gymnasium_cls="DummyGymnasiumEnvPool",
  max_episode_steps=200,
)
