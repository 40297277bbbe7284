"""Procgen registration of the port (``envpool_tpu/envs/procgen/
registration.py``, ``envpool/procgen/registration.py``): the 16 games ×
their distribution modes, 42 ids. Importing this module without the
wheel raises ModuleNotFoundError (``entry.py`` skips the family then)."""

import procgen  # noqa: F401  -- gate on availability

from envpool_torch.registration import register

procgen_game_config = [
  ("bigfish", 6000, [0, 1]),
  ("bossfight", 4000, [0, 1]),
  ("caveflyer", 1000, [0, 1, 10]),
  ("chaser", 1000, [0, 1, 2]),
  ("climber", 1000, [0, 1]),
  ("coinrun", 1000, [0, 1]),
  ("dodgeball", 1000, [0, 1, 2, 10]),
  ("fruitbot", 1000, [0, 1]),
  ("heist", 1000, [0, 1, 10]),
  ("jumper", 1000, [0, 1, 10]),
  ("leaper", 500, [0, 1, 2]),
  ("maze", 500, [0, 1, 10]),
  ("miner", 1000, [0, 1, 10]),
  ("ninja", 1000, [0, 1]),
  ("plunder", 4000, [0, 1]),
  ("starpilot", 1000, [0, 1, 2]),
]

distribution = {0: "Easy", 1: "Hard", 2: "Extreme", 10: "Memory"}

for env_name, timeout, dist_mode in procgen_game_config:
  for dist_value in dist_mode:
    register(
      task_id=f"{env_name.capitalize()}{distribution[dist_value]}-v0",
      import_path="envpool_torch.envs.procgen",
      spec_cls="ProcgenEnvSpec",
      dm_cls="ProcgenDMEnvPool",
      gym_cls="ProcgenGymEnvPool",
      gymnasium_cls="ProcgenGymnasiumEnvPool",
      env_name=env_name,
      distribution_mode=dist_value,
      max_episode_steps=timeout,
    )
