"""Classic control task registration of the port (CartPole only so far);
the same ids and default kwargs as
``envpool_tpu/envs/classic_control/registration.py``."""

from envpool_torch.registration import register

register(
  task_id="CartPole-v0",
  import_path="envpool_torch.envs.classic_control",
  spec_cls="CartPoleEnvSpec",
  dm_cls="CartPoleDMEnvPool",
  gym_cls="CartPoleGymEnvPool",
  gymnasium_cls="CartPoleGymnasiumEnvPool",
  max_episode_steps=200,
  reward_threshold=195.0,
)

register(
  task_id="CartPole-v1",
  import_path="envpool_torch.envs.classic_control",
  spec_cls="CartPoleEnvSpec",
  dm_cls="CartPoleDMEnvPool",
  gym_cls="CartPoleGymEnvPool",
  gymnasium_cls="CartPoleGymnasiumEnvPool",
  max_episode_steps=500,
  reward_threshold=475.0,
)
