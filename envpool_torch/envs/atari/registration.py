"""Atari task registration of the port (``envpool_tpu/envs/atari/
registration.py``, ``envpool/atari/registration.py``).

The on-device demo registers first and unconditionally. The ALE ids are
generated from ``ale_py``'s rom registry ("pong" -> "Pong-v5"), like the
reference generates them from its bundled roms directory, and only where
``ale_py`` is installed.
"""

from envpool_torch.registration import register

register(
  task_id="PongJaxDemo-v5",
  import_path="envpool_torch.envs.atari",
  spec_cls="PongDemoEnvSpec",
  dm_cls="PongDemoDMEnvPool",
  gym_cls="PongDemoGymEnvPool",
  gymnasium_cls="PongDemoGymnasiumEnvPool",
  max_episode_steps=27000,
)


def _game_list():
  try:
    import ale_py.roms
  except ImportError:
    return []  # emulator tier gated on the optional wheel; demo stays
  get_all = getattr(ale_py.roms, "get_all_rom_ids", None)
  if get_all is not None:
    return sorted(get_all())
  return sorted(
    n for n in dir(ale_py.roms) if not n.startswith("_") and n.islower()
  )


for _game in _game_list():
  register(
    task_id="".join(g.capitalize() for g in _game.split("_")) + "-v5",
    import_path="envpool_torch.envs.atari",
    spec_cls="AtariEnvSpec",
    dm_cls="AtariDMEnvPool",
    gym_cls="AtariGymEnvPool",
    gymnasium_cls="AtariGymnasiumEnvPool",
    task=_game,
    max_episode_steps=27000,
  )
