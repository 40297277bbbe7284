"""Toy text task registration of the port; the same ids and kwargs as
``envpool_tpu/envs/toy_text/registration.py`` (the reference's
``envpool/toy_text/registration.py:18-100``)."""

from envpool_torch.registration import register

register(
  task_id="Catch-v0",
  import_path="envpool_torch.envs.toy_text",
  spec_cls="CatchEnvSpec",
  dm_cls="CatchDMEnvPool",
  gym_cls="CatchGymEnvPool",
  gymnasium_cls="CatchGymnasiumEnvPool",
  height=10,
  width=5,
)

register(
  task_id="FrozenLake-v1",
  import_path="envpool_torch.envs.toy_text",
  spec_cls="FrozenLakeEnvSpec",
  dm_cls="FrozenLakeDMEnvPool",
  gym_cls="FrozenLakeGymEnvPool",
  gymnasium_cls="FrozenLakeGymnasiumEnvPool",
  size=4,
  max_episode_steps=100,
  reward_threshold=0.7,
)

register(
  task_id="FrozenLake8x8-v1",
  import_path="envpool_torch.envs.toy_text",
  spec_cls="FrozenLakeEnvSpec",
  dm_cls="FrozenLakeDMEnvPool",
  gym_cls="FrozenLakeGymEnvPool",
  gymnasium_cls="FrozenLakeGymnasiumEnvPool",
  size=8,
  max_episode_steps=200,
  reward_threshold=0.85,
)

register(
  task_id="Taxi-v3",
  import_path="envpool_torch.envs.toy_text",
  spec_cls="TaxiEnvSpec",
  dm_cls="TaxiDMEnvPool",
  gym_cls="TaxiGymEnvPool",
  gymnasium_cls="TaxiGymnasiumEnvPool",
  max_episode_steps=200,
  reward_threshold=8.0,
)

register(
  task_id="NChain-v0",
  import_path="envpool_torch.envs.toy_text",
  spec_cls="NChainEnvSpec",
  dm_cls="NChainDMEnvPool",
  gym_cls="NChainGymEnvPool",
  gymnasium_cls="NChainGymnasiumEnvPool",
  max_episode_steps=1000,
)

register(
  task_id="CliffWalking-v0",
  import_path="envpool_torch.envs.toy_text",
  spec_cls="CliffWalkingEnvSpec",
  dm_cls="CliffWalkingDMEnvPool",
  gym_cls="CliffWalkingGymEnvPool",
  gymnasium_cls="CliffWalkingGymnasiumEnvPool",
)

register(
  task_id="Blackjack-v1",
  import_path="envpool_torch.envs.toy_text",
  spec_cls="BlackjackEnvSpec",
  dm_cls="BlackjackDMEnvPool",
  gym_cls="BlackjackGymEnvPool",
  gymnasium_cls="BlackjackGymnasiumEnvPool",
  sab=True,
  natural=False,
)
