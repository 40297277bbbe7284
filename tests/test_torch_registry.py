"""Registry smoke test of the port: make every registered id in all three
dialects on the CPU; the twin of ``tests/test_registry.py``.

The ``...Jax...`` ids (the device-physics families) reset through one
dialect only, as the JAX file does: the reset is the same in every
dialect, and the dialect layer is a host-side view covered by
``test_torch_api.py`` and ``test_torch_gym_dialect.py``. The legacy gym
dialect goes through ``tests/_fake_gym.py``.
"""

import pytest
import torch

import envpool_torch

import _fake_gym

_fake_gym.install("0.26.2")
torch.set_num_threads(1)

_ONE_DIALECT_RESET_MARKERS = ("Jax",)


def test_port_has_76_ids():
  assert len(envpool_torch.list_all_envs()) == 76


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
