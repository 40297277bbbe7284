"""The port's twin of ``tests/test_api.py`` (CPU pools): specs, spaces,
batch round-trips. Like it, mirrors the reference's api tests
(``envpool/atari/api_test.py:33-316``,
``envpool/dummy/dummy_py_envpool_test.py:28-98``) for the families built so
far.
"""

import dm_env
import gymnasium
import numpy as np
import pytest

import envpool_torch


def test_config_keys() -> None:
  spec = envpool_torch.make_spec("CartPole-v1")
  common = [
    "num_envs", "batch_size", "num_threads", "max_num_players",
    "thread_affinity_offset", "base_path", "seed", "gym_reset_return_info",
    "max_episode_steps"
  ]
  for k in common:
    assert k in spec._config_keys
  assert "reward_threshold" in spec._config_keys
  assert spec.config.max_episode_steps == 500
  assert spec.reward_threshold == 475.0


def test_state_keys_order() -> None:
  spec = envpool_torch.make_spec("CartPole-v1")
  assert spec._state_keys[:8] == [
    "info:env_id", "info:players.env_id", "elapsed_step", "done", "reward",
    "discount", "step_type", "trunc"
  ]
  assert "obs" in spec._state_keys
  assert spec._action_keys[:2] == ["env_id", "players.env_id"]


def test_spaces_gymnasium() -> None:
  env = envpool_torch.make_gymnasium("CartPole-v1", device="cpu", num_envs=2)
  assert isinstance(env.observation_space, gymnasium.spaces.Box)
  assert env.observation_space.shape == (4,)
  assert isinstance(env.action_space, gymnasium.spaces.Discrete)
  assert env.action_space.n == 2

  env = envpool_torch.make_gymnasium("Pendulum-v1", device="cpu", num_envs=2)
  assert isinstance(env.action_space, gymnasium.spaces.Box)
  assert env.action_space.shape == (1,)


def test_spec_dm() -> None:
  env = envpool_torch.make_dm("CartPole-v1", device="cpu", num_envs=2)
  obs_spec = env.observation_spec()
  assert hasattr(obs_spec, "obs")
  assert tuple(obs_spec.obs.shape) == (4,)
  act_spec = env.action_spec()
  assert isinstance(act_spec, dm_env.specs.DiscreteArray)
  assert act_spec.num_values == 2


def test_gymnasium_roundtrip() -> None:
  num_envs = 16
  env = envpool_torch.make_gymnasium("CartPole-v1", device="cpu", num_envs=num_envs, seed=1)
  obs, info = env.reset()
  assert obs.shape == (num_envs, 4)
  assert obs.dtype == np.float32
  np.testing.assert_array_equal(info["env_id"], np.arange(num_envs))
  rng = np.random.default_rng(0)
  ever_done = np.zeros(num_envs, bool)
  for _ in range(10):
    act = rng.integers(0, 2, num_envs)
    obs, rew, term, trunc, info = env.step(act)
    ever_done |= term | trunc
  assert obs.shape == (num_envs, 4)
  assert rew.dtype == np.float32
  assert term.dtype == np.bool_
  assert trunc.dtype == np.bool_
  assert info["elapsed_step"].dtype == np.int32
  # lanes that never terminated have stepped exactly 10 times; terminated
  # lanes auto-reset and restart their counter
  np.testing.assert_array_equal(info["elapsed_step"][~ever_done], 10)


def test_dm_roundtrip() -> None:
  num_envs = 8
  env = envpool_torch.make_dm("CartPole-v1", device="cpu", num_envs=num_envs, seed=1)
  ts = env.reset()
  assert isinstance(ts, dm_env.TimeStep)
  np.testing.assert_array_equal(ts.step_type, 0)  # FIRST
  np.testing.assert_array_equal(ts.discount, 1.0)
  np.testing.assert_array_equal(ts.reward, 0.0)
  assert ts.observation.obs.shape == (num_envs, 4)
  np.testing.assert_array_equal(ts.observation.env_id, np.arange(num_envs))
  ts = env.step(np.zeros(num_envs, np.int32))
  np.testing.assert_array_equal(ts.step_type, 1)  # MID
  np.testing.assert_array_equal(ts.reward, 1.0)


def test_continuous_action_env() -> None:
  num_envs = 4
  env = envpool_torch.make_gymnasium("Pendulum-v1", device="cpu", num_envs=num_envs, seed=3)
  obs, _ = env.reset()
  assert obs.shape == (num_envs, 3)
  obs, rew, term, trunc, _ = env.step(
    np.zeros((num_envs, 1), np.float32)
  )
  assert (rew <= 0).all()
  assert not term.any()


def test_acrobot_info_field() -> None:
  env = envpool_torch.make_gymnasium("Acrobot-v1", device="cpu", num_envs=4, seed=3)
  obs, info = env.reset()
  assert obs.shape == (4, 6)
  obs, rew, term, trunc, info = env.step(np.zeros(4, np.int32))
  assert info["state"].shape == (4, 2)
  # obs[0:2] are cos/sin of info:state[0]
  np.testing.assert_allclose(obs[:, 0], np.cos(info["state"][:, 0]),
                             rtol=1e-5)


def test_action_dtype_check() -> None:
  env = envpool_torch.make_gymnasium("CartPole-v1", device="cpu", num_envs=4)
  env.reset()
  with pytest.raises(RuntimeError, match="dtype"):
    env.send({"action": np.zeros(4, np.float64)})


def test_make_invalid_task() -> None:
  with pytest.raises(AssertionError):
    envpool_torch.make_gymnasium("NoSuchEnv-v0", device="cpu")


def test_len_and_repr() -> None:
  env = envpool_torch.make_gymnasium("CartPole-v0", device="cpu", num_envs=6)
  assert len(env) == 6
  assert "CartPole" in repr(env)
  assert env.config["max_episode_steps"] == 200
