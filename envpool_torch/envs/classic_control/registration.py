"""Classic control task registration of the port; the same ids and default
kwargs as ``envpool_tpu/envs/classic_control/registration.py``."""

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

register(
  task_id="Pendulum-v0",
  import_path="envpool_torch.envs.classic_control",
  spec_cls="PendulumEnvSpec",
  dm_cls="PendulumDMEnvPool",
  gym_cls="PendulumGymEnvPool",
  gymnasium_cls="PendulumGymnasiumEnvPool",
  version=0,
  max_episode_steps=200,
)

register(
  task_id="Pendulum-v1",
  import_path="envpool_torch.envs.classic_control",
  spec_cls="PendulumEnvSpec",
  dm_cls="PendulumDMEnvPool",
  gym_cls="PendulumGymEnvPool",
  gymnasium_cls="PendulumGymnasiumEnvPool",
  version=1,
  max_episode_steps=200,
)

register(
  task_id="MountainCar-v0",
  import_path="envpool_torch.envs.classic_control",
  spec_cls="MountainCarEnvSpec",
  dm_cls="MountainCarDMEnvPool",
  gym_cls="MountainCarGymEnvPool",
  gymnasium_cls="MountainCarGymnasiumEnvPool",
  max_episode_steps=200,
)

register(
  task_id="MountainCarContinuous-v0",
  import_path="envpool_torch.envs.classic_control",
  spec_cls="MountainCarContinuousEnvSpec",
  dm_cls="MountainCarContinuousDMEnvPool",
  gym_cls="MountainCarContinuousGymEnvPool",
  gymnasium_cls="MountainCarContinuousGymnasiumEnvPool",
  max_episode_steps=999,
)

register(
  task_id="Acrobot-v1",
  import_path="envpool_torch.envs.classic_control",
  spec_cls="AcrobotEnvSpec",
  dm_cls="AcrobotDMEnvPool",
  gym_cls="AcrobotGymEnvPool",
  gymnasium_cls="AcrobotGymnasiumEnvPool",
  max_episode_steps=500,
)
