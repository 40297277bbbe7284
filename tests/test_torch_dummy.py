"""The port's twin of ``tests/test_dummy.py`` (CPU pools): the Dummy family's
dict-obs round trip through the dialects.

Mirrors ``envpool/dummy/dummy_py_envpool_test.py:28-98``.
"""

import numpy as np

import envpool_torch


def test_spec_and_config() -> None:
  spec = envpool_torch.make_spec("Dummy-v0", num_envs=4)
  assert set(
    ["state_num", "action_num", "num_envs", "batch_size", "seed"]
  ) <= set(spec.gen_config._fields)
  assert spec.state_array_spec["obs:raw"].shape == (2,)
  assert spec.action_array_spec["action"].shape == (-1,)


def test_gymnasium_roundtrip() -> None:
  env = envpool_torch.make(
    "Dummy-v0", env_type="gymnasium", device="cpu", num_envs=4)
  obs, info = env.reset()
  assert obs["raw"].shape == (4, 2)
  assert obs["clock"].shape == (4,)
  assert np.all(info["step_count"] == 0)
  act = np.asarray([0, 1, 2, 3], np.int32)
  obs, rew, term, trunc, info = env.step(act)
  np.testing.assert_allclose(rew, act.astype(np.float32))
  np.testing.assert_array_equal(obs["raw"][:, 1], act)
  assert np.all(info["step_count"] == 1)


def test_dm_roundtrip() -> None:
  env = envpool_torch.make(
    "Dummy-v0", env_type="dm", device="cpu", num_envs=2)
  ts = env.reset()
  assert ts.observation.raw.shape == (2, 2)
  ts = env.step({"action": np.ones(2, np.int32)})
  np.testing.assert_allclose(ts.reward, 1.0)


def test_termination_after_state_num() -> None:
  env = envpool_torch.make(
    "Dummy-v0", env_type="gymnasium", device="cpu", num_envs=2, state_num=3
  )
  env.reset()
  for i in range(3):
    _, _, term, trunc, _ = env.step(np.zeros(2, np.int32))
  assert np.all(term)
