"""ViZDoom registration of the port (``envpool_tpu/envs/vizdoom/
registration.py``, ``envpool/vizdoom/registration.py``).

Every scenario bundled with the vizdoom wheel whose ``.cfg`` and ``.wad``
both lie in ``vizdoom.scenarios_path`` is registered, then the fully
custom ``VizdoomCustom-v1`` (cfg/wad passed at make time). Importing this
module without the wheel raises ModuleNotFoundError (``entry.py`` skips
the family then).
"""

import os

import vizdoom

from envpool_torch.registration import register

_scenario_dir = getattr(vizdoom, "scenarios_path", "")


def _game_list():
  if not _scenario_dir or not os.path.isdir(_scenario_dir):
    return []
  return [
    f[:-4]
    for f in sorted(os.listdir(_scenario_dir))
    if f.endswith(".cfg")
    and os.path.exists(os.path.join(_scenario_dir, f[:-4] + ".wad"))
  ]


for game in _game_list() + ["vizdoom_custom"]:
  name = "".join(g.capitalize() for g in game.split("_"))
  if game == "vizdoom_custom":
    cfg_path = wad_path = ""
  else:
    cfg_path = os.path.join(_scenario_dir, f"{game}.cfg")
    wad_path = os.path.join(_scenario_dir, f"{game}.wad")
  register(
    task_id=f"{name}-v1",
    import_path="envpool_torch.envs.vizdoom",
    spec_cls="VizdoomEnvSpec",
    dm_cls="VizdoomDMEnvPool",
    gym_cls="VizdoomGymEnvPool",
    gymnasium_cls="VizdoomGymnasiumEnvPool",
    cfg_path=cfg_path,
    wad_path=wad_path,
    max_episode_steps=525,
  )
