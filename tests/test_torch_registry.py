"""Registry smoke test of the port: make every registered id in all three
dialects on the CPU; the twin of ``tests/test_registry.py``.

The host tier's ids (``HostEnvPool``s: nothing to compile) reset in every
dialect, as in the JAX file. The ``...Jax...`` ids (the device-physics
families) reset through one dialect only, as the JAX file does: the reset
is the same in every dialect, and the dialect layer is a host-side view
covered by ``test_torch_api.py`` and ``test_torch_gym_dialect.py``. The legacy gym
dialect goes through ``tests/_fake_gym.py``.
"""

import importlib

import pytest
import torch

import envpool_torch
from envpool_torch.core.host_pool import HostEnvPool

import _fake_gym

_fake_gym.install("0.26.2")
torch.set_num_threads(1)

_ONE_DIALECT_RESET_MARKERS = ("Jax",)


def _host_ids():
  """The ids whose pools are ``HostEnvPool``s (the host tier)."""
  ids = []
  for task_id in envpool_torch.list_all_envs():
    path, cls = envpool_torch.registration.registry.envpools[task_id]["gymnasium"]
    if issubclass(getattr(importlib.import_module(path), cls), HostEnvPool):
      ids.append(task_id)
  return ids


def test_port_has_76_ids():
  """The 76 ids of the device tier (``TorchEnvPool``), which the port had
  before the host tier."""
  assert len(envpool_torch.list_all_envs()) - len(_host_ids()) == 76


def test_port_has_59_host_ids():
  """The host tier: the 22 gym MuJoCo and 37 dm_control ids (the ALE ids
  come where ``ale_py`` is installed)."""
  host = [t for t in _host_ids() if not t.endswith("-v5")]
  assert len(host) == 59
  assert sum(t.endswith("-v1") for t in host) == 37


@pytest.mark.parametrize("task_id", envpool_torch.list_all_envs())
def test_make_all_dialects(task_id):
  one_reset = any(m in task_id for m in _ONE_DIALECT_RESET_MARKERS)
  for i, maker in enumerate((
    envpool_torch.make_gymnasium,
    envpool_torch.make_dm,
    envpool_torch.make_gym,
  )):
    env = maker(task_id, num_envs=2, seed=0, device="cpu")
    if one_reset and i > 0:
      assert env.spec is not None
      continue
    out = env.reset()
    assert out is not None


@pytest.mark.parametrize("task_id", envpool_torch.list_all_envs())
def test_spec_roundtrip(task_id):
  spec = envpool_torch.make_spec(task_id, num_envs=3)
  assert spec.config.num_envs == 3
  assert len(spec._state_keys) == len(spec._state_spec)
  assert len(spec._action_keys) == len(spec._action_spec)
