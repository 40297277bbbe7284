"""MiniGrid task registration of the port; the same ids and kwargs as
``envpool_tpu/envs/minigrid/registration.py`` (the reference's
``envpool/minigrid/registration.py``).

The reference passes ``agent_start_pos=(-1, -1)``; the config here uses the
flattened ``agent_start_pos_x/_y`` ints, as the JAX package's does.
"""

from envpool_torch.registration import register

_TASKS = [
  ("MiniGrid-Empty-5x5-v0", dict(max_episode_steps=100, size=5)),
  (
    "MiniGrid-Empty-Random-5x5-v0",
    dict(
      max_episode_steps=100, size=5,
      agent_start_pos_x=-1, agent_start_pos_y=-1, agent_start_dir=-1,
    ),
  ),
  ("MiniGrid-Empty-6x6-v0", dict(max_episode_steps=144, size=6)),
  (
    "MiniGrid-Empty-Random-6x6-v0",
    dict(
      max_episode_steps=144, size=6,
      agent_start_pos_x=-1, agent_start_pos_y=-1, agent_start_dir=-1,
    ),
  ),
  ("MiniGrid-Empty-8x8-v0", dict(max_episode_steps=256, size=8)),
  ("MiniGrid-Empty-16x16-v0", dict(max_episode_steps=1024, size=16)),
]

for task_id, kwargs in _TASKS:
  register(
    task_id=task_id,
    import_path="envpool_torch.envs.minigrid",
    spec_cls="EmptyEnvSpec",
    dm_cls="EmptyDMEnvPool",
    gym_cls="EmptyGymEnvPool",
    gymnasium_cls="EmptyGymnasiumEnvPool",
    **kwargs,
  )
