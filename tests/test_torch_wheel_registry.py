"""The port registers the procgen and vizdoom ids exactly where the JAX
package does. Neither wheel is installed here, so the check runs in a child
process (``tests/_isolation.py``) that puts scripted ``procgen`` and
``vizdoom`` modules in place before either package is imported; this file
imports neither package at its top for that reason."""

import sys
import types

from _isolation import isolated


def _install_fake_wheels(scenarios: str) -> None:
  procgen = types.ModuleType("procgen")
  procgen.ProcgenGym3Env = object
  vizdoom = types.ModuleType("vizdoom")
  vizdoom.scenarios_path = scenarios
  sys.modules["procgen"] = procgen
  sys.modules["vizdoom"] = vizdoom


def _family(registry, prefix: str) -> list:
  """(task id, spec class, kwargs without the package's base_path) of the
  ids whose import path is the family's, in registration order."""
  out = []
  for task_id, (path, spec_cls, kwargs) in registry.specs.items():
    if path.endswith(prefix):
      kw = {k: v for k, v in kwargs.items() if k != "base_path"}
      out.append((task_id, spec_cls, kw))
  return out


@isolated
def test_wheel_families_register_the_jax_ids(tmp_path) -> None:
  """Under fake wheels, with two ``.cfg``/``.wad`` pairs and one lone
  ``.cfg`` in ``vizdoom.scenarios_path``: the port's procgen and vizdoom
  ids equal the JAX package's, in order, with equal kwargs (42 procgen
  ids; the two scenarios and ``VizdoomCustom-v1``); the lone ``.cfg`` is
  not registered; every other id of both packages is the same list."""
  for name in ("basic", "deadly_corridor"):
    (tmp_path / f"{name}.cfg").write_text("")
    (tmp_path / f"{name}.wad").write_text("")
  (tmp_path / "lonely.cfg").write_text("")
  _install_fake_wheels(str(tmp_path))
  import envpool_torch
  import envpool_tpu

  port = envpool_torch.registration.registry
  ref = envpool_tpu.registration.registry
  got, want = _family(port, ".procgen"), _family(ref, ".procgen")
  assert len(got) == 42
  assert got == want
  assert got[0][0] == "BigfishEasy-v0" and got[-1][0] == "StarpilotExtreme-v0"
  got, want = _family(port, ".vizdoom"), _family(ref, ".vizdoom")
  assert [t for t, _, _ in got] == ["Basic-v1", "DeadlyCorridor-v1", "VizdoomCustom-v1"]
  assert got == want
  assert got[0][2] == {"cfg_path": str(tmp_path / "basic.cfg"),
                       "wad_path": str(tmp_path / "basic.wad"),
                       "max_episode_steps": 525}
  assert envpool_torch.list_all_envs() == envpool_tpu.list_all_envs()
  assert len(envpool_torch.list_all_envs()) == 135 + 42 + 3
  for task_id in ("BigfishEasy-v0", "Basic-v1"):
    assert port.envpools[task_id]["gymnasium"][0].startswith("envpool_torch.envs.")
