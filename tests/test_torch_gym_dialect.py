"""Legacy-gym dialect coverage of the port: the twin of
``tests/test_gym_dialect.py`` over ``envpool_torch`` on the CPU.

Modern gym (>=0.26) gets the 5-tuple and reset-with-info; pre-0.26 gym
gets the 4-tuple with ``done``, the ``TimeLimit.truncated`` info key and
the obs-only reset (``envpool/python/gym_envpool.py``). The legacy wheel
is absent, so ``tests/_fake_gym.py`` stands in for it.
"""

import numpy as np
import pytest
import torch

import envpool_torch

import _fake_gym

torch.set_num_threads(1)


def _make(task_id, **kw):
  return envpool_torch.make_gym(task_id, device="cpu", **kw)


@pytest.fixture
def modern_gym():
  mod = _fake_gym.install("0.26.2")
  yield mod
  _fake_gym.install("0.26.2")


@pytest.fixture
def legacy_gym():
  mod = _fake_gym.install("0.21.0")
  yield mod
  _fake_gym.install("0.26.2")


def test_modern_gym_step_tuple(modern_gym):
  env = _make("CartPole-v1", num_envs=4, seed=0)
  out = env.reset()
  assert isinstance(out, tuple) and len(out) == 2  # (obs, info)
  obs, info = out
  assert obs.shape == (4, 4)
  assert "env_id" in info
  obs, rew, term, trunc, info = env.step(np.zeros(4, np.int32))
  assert term.dtype == np.bool_ and trunc.dtype == np.bool_
  assert "TimeLimit.truncated" not in info
  assert np.all(info["elapsed_step"] == 1)


def test_modern_gym_terminated_excludes_truncation(modern_gym):
  cap = 5
  env = _make("CartPole-v1", num_envs=2, seed=0, max_episode_steps=cap)
  env.reset()
  for _ in range(cap - 1):
    _, _, term, trunc, _ = env.step(np.zeros(2, np.int32))
  _, _, term, trunc, _ = env.step(np.zeros(2, np.int32))
  # at the cap truncated lanes are not terminated (gym_envpool.py:84-88)
  assert np.all(trunc | term)
  assert not np.any(term & trunc)


def test_legacy_gym_reset_and_4tuple(legacy_gym):
  env = _make("CartPole-v1", num_envs=3, seed=0)
  out = env.reset()
  # legacy reset: the bare observation, no info
  assert isinstance(out, np.ndarray) and out.shape == (3, 4)
  out = env.step(np.zeros(3, np.int32))
  assert len(out) == 4  # (obs, reward, done, info)
  obs, rew, done, info = out
  assert done.dtype == np.bool_
  assert "TimeLimit.truncated" in info
  assert not np.any(info["TimeLimit.truncated"])


def test_legacy_gym_timelimit_truncated_key(legacy_gym):
  cap = 4
  env = _make("CartPole-v1", num_envs=2, seed=0, max_episode_steps=cap)
  env.reset()
  for _ in range(cap):
    obs, rew, done, info = env.step(np.zeros(2, np.int32))
  # the pole cannot fall in 4 steps from the +-0.05 init: done is pure
  # truncation on every lane
  assert np.all(done)
  assert info["TimeLimit.truncated"].dtype == np.bool_
  assert np.all(info["TimeLimit.truncated"])


def test_legacy_gym_reset_return_info_opt_in(legacy_gym):
  env = _make("CartPole-v1", num_envs=2, seed=0, gym_reset_return_info=True)
  out = env.reset()
  assert isinstance(out, tuple) and len(out) == 2
  _, info = out
  assert np.array_equal(np.sort(info["env_id"]), np.arange(2))


def test_modern_gym_rejects_legacy_reset_flag(modern_gym):
  with pytest.raises(ValueError, match="gym>=0.26.0"):
    _make("CartPole-v1", num_envs=2, seed=0, gym_reset_return_info=False)


def test_gym_spaces(modern_gym):
  import gym
  env = _make("CartPole-v1", num_envs=2, seed=0)
  assert isinstance(env.observation_space, gym.spaces.Box)
  assert env.observation_space.shape == (4,)
  assert isinstance(env.action_space, gym.spaces.Discrete)
  assert env.action_space.n == 2
  # a continuous action family
  env = _make("Pendulum-v1", num_envs=2, seed=0)
  assert isinstance(env.action_space, gym.spaces.Box)


def test_gym_dialect_async(modern_gym):
  env = _make("CartPole-v1", num_envs=6, batch_size=3, seed=0)
  env.async_reset()
  seen = set()
  for _ in range(8):
    obs, rew, term, trunc, info = env.recv()
    assert obs.shape[0] == 3
    seen.update(info["env_id"].tolist())
    env.send(np.zeros(3, np.int32), info["env_id"])
  assert seen == set(range(6))


# the host tier: the dialect veneer over a HostEnvPool, whose _recv gives
# numpy arrays


def _same_tree(got, want):
  if isinstance(want, (tuple, dict)):
    assert len(got) == len(want)
    for k in (want if isinstance(want, dict) else range(len(want))):
      _same_tree(got[k], want[k])
  else:
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_host_pool_legacy_gym_matches_jax(legacy_gym):
  """Hopper-v4 through the legacy dialect: the bare-obs reset, the 4-tuple
  and ``TimeLimit.truncated`` at the cap, each value equal to the JAX
  package's gym dialect at the same seed and actions."""
  import envpool_tpu

  cap = 3
  env = _make("Hopper-v4", num_envs=2, seed=0, max_episode_steps=cap)
  twin = envpool_tpu.make_gym("Hopper-v4", num_envs=2, seed=0,
                              max_episode_steps=cap)
  out, want = env.reset(), twin.reset()
  assert isinstance(out, np.ndarray) and out.shape == (2, 11)
  np.testing.assert_array_equal(out, want)
  act = np.full((2, 3), 0.1)
  for _ in range(cap):
    out, want = env.step(act), twin.step(act)
    assert len(out) == 4
    _same_tree(out, want)
  obs, rew, done, info = out
  assert np.all(done) and np.all(info["TimeLimit.truncated"])


def test_host_pool_gym_dialect_async(modern_gym):
  env = _make("CheetahRun-v1", num_envs=6, batch_size=3, seed=0)
  env.async_reset()
  seen = set()
  for _ in range(8):
    obs, rew, term, trunc, info = env.recv()
    assert obs["position"].shape == (3, 8) and obs["velocity"].shape == (3, 9)
    seen.update(info["env_id"].tolist())
    env.send(np.zeros((3, 6)), info["env_id"])
  assert seen == set(range(6))
