"""The port's MiniGrid Empty family (CPU): every registered id against
``envpool_tpu`` from the same seed and actions over 200 steps with
auto-resets, every output field bit for bit; the goal reward at every
registered cap; the view near walls in all four directions against the JAX
package's one-hot form; twins of ``tests/test_minigrid.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu
from _torch_parity import assert_same, assert_same_config, jax_rollout, port_rollout
from envpool_torch.envs.minigrid import EmptyEnv, minigrid
from envpool_tpu.envs.minigrid import EmptyEnv as JaxEmptyEnv

torch.set_num_threads(1)

T_EMPTY, T_WALL, T_GOAL = 1, 2, 8
TASKS = [t for t in envpool_tpu.list_all_envs() if t.startswith("MiniGrid-")]


def _port(task_id, **kw):
  return envpool_torch.make_gymnasium(task_id, device="cpu", **kw)


def test_registry_matches_jax_package():
  assert TASKS == [t for t in envpool_torch.list_all_envs() if t.startswith("MiniGrid-")]
  for task_id in TASKS:
    assert_same_config(task_id, {})


@pytest.mark.parametrize("task_id", TASKS)
def test_parity_with_jax_package(task_id):
  """Forward-heavy random actions; the cap is cut to 40 so that every lane
  auto-resets (the goal reward at the registered caps is held below)."""
  kw = dict(num_envs=16, seed=3, max_episode_steps=40)
  assert_same_config(task_id, kw)
  acts = np.random.default_rng(0).choice([0, 1, 2, 2, 2, 3], (200, 16)).astype(np.int32)
  keys, got, g_st = port_rollout(task_id, kw, acts)
  want_keys, want, w_st = jax_rollout(task_id, kw, acts)
  assert keys == want_keys
  for t, (g, w) in enumerate(zip(got, want)):
    assert_same(g, w, f"step {t}")
  assert_same(g_st.env, w_st.env, "state")
  np.testing.assert_array_equal(g_st.rng, w_st.rng)
  elapsed = np.stack([g[keys.index("elapsed_step")] for g in got[1:]])
  assert (elapsed == 0).any(0).all()   # every lane auto-reset


def test_goal_reward_at_registered_caps():
  """The reward for reaching the goal at every step count of every
  registered cap, against the JAX package's expression under ``jit``."""
  for cap in sorted({envpool_tpu.make_spec(t).config.max_episode_steps for t in TASKS}):
    steps = np.arange(1, cap + 1, dtype=np.int32)
    want = jax.jit(
      lambda s: 1.0 - 0.9 * s.astype(jnp.float32) / jnp.float32(cap)
    )(jnp.asarray(steps))
    cfg = envpool_torch.make_spec("MiniGrid-Empty-5x5-v0", max_episode_steps=cap).config
    got = minigrid._goal_reward(cfg, torch.from_numpy(steps))
    assert_same(got.numpy(), want, f"cap {cap}")


@pytest.mark.parametrize("size", [5, 16])
def test_view_against_one_hot_form(size):
  """Every interior position in every direction: the gathered, rotated
  and transposed image equals the JAX package's one-hot-matmul window with
  its masked-add rotation (out-of-grid cells read as walls)."""
  cfg = envpool_torch.make_spec("MiniGrid-Empty-5x5-v0", size=size).config
  xs, ys, ds = np.meshgrid(np.arange(1, size - 1), np.arange(1, size - 1), np.arange(4))
  pos = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.int32)
  dirs = ds.ravel().astype(np.int32)
  want = jax.jit(jax.vmap(
    lambda p, d: JaxEmptyEnv._obs(cfg, {"pos": p, "dir": d})["image"]
  ))(jnp.asarray(pos), jnp.asarray(dirs))
  got = EmptyEnv._obs(cfg, {"pos": torch.from_numpy(pos), "dir": torch.from_numpy(dirs)})
  assert_same(got["image"].numpy(), want)


def test_steps_without_reading_the_device():
  """reset and step on the meta device, where a tensor has no data: any
  read of a value on the host raises."""
  for task_id in ("MiniGrid-Empty-8x8-v0", "MiniGrid-Empty-Random-6x6-v0"):
    cfg = envpool_torch.make_spec(task_id).config
    keys = torch.zeros(8, 2, dtype=torch.int64, device="meta")
    state, obs, _ = EmptyEnv.reset(cfg, None, keys)
    _, obs, rew, term, info = EmptyEnv.step(
      cfg, state, torch.zeros(8, dtype=torch.int32, device="meta"), keys
    )
    assert obs["image"].shape == (8, 7, 7, 3) and rew.device.type == "meta"


@pytest.mark.parametrize("task_id", TASKS)
def test_every_dialect_steps(task_id):
  for make in (envpool_torch.make_gym, envpool_torch.make_dm):
    env = make(task_id, num_envs=2, seed=0, device="cpu")
    env.reset()
    assert env.step(np.full(2, 2, np.int32)) is not None


# ------------------------------------------------- twins of test_minigrid.py


def test_spec_and_reset():
  env = _port("MiniGrid-Empty-8x8-v0", num_envs=3)
  obs, info = env.reset()
  assert obs["image"].shape == (3, 7, 7, 3)
  assert obs["image"].dtype == np.uint8
  np.testing.assert_array_equal(obs["direction"], 0)
  np.testing.assert_array_equal(info["agent_pos"], [[1, 1]] * 3)


def test_view_geometry():
  env = _port("MiniGrid-Empty-8x8-v0", num_envs=1)
  obs, _ = env.reset()
  img = obs["image"][0]
  assert img[3, 6, 0] == T_EMPTY


def test_goal_reward_formula():
  env = _port("MiniGrid-Empty-5x5-v0", num_envs=1)
  env.reset()
  acts = [2, 2, 1, 2, 2]
  for a in acts:
    obs, rew, term, trunc, info = env.step(np.asarray([a], np.int32))
  assert term[0]
  np.testing.assert_allclose(rew[0], 1.0 - 0.9 * len(acts) / 100.0, rtol=1e-6)


def test_walls_block():
  env = _port("MiniGrid-Empty-5x5-v0", num_envs=1)
  env.reset()
  env.step(np.asarray([0], np.int32))
  env.step(np.asarray([0], np.int32))
  obs, rew, term, trunc, info = env.step(np.asarray([2], np.int32))
  np.testing.assert_array_equal(info["agent_pos"], [[1, 1]])


def test_random_start_determinism():
  def starts(seed):
    env = _port("MiniGrid-Empty-Random-6x6-v0", num_envs=16, seed=seed)
    obs, info = env.reset()
    return np.asarray(info["agent_pos"]), np.asarray(obs["direction"])

  p1, d1 = starts(5)
  p2, d2 = starts(5)
  p3, d3 = starts(6)
  np.testing.assert_array_equal(p1, p2)
  np.testing.assert_array_equal(d1, d2)
  assert not (np.array_equal(p1, p3) and np.array_equal(d1, d3))
  assert np.all((p1 >= 1) & (p1 <= 4))
  assert not np.any((p1[:, 0] == 4) & (p1[:, 1] == 4))
  assert np.all((d1 >= 0) & (d1 <= 3))


def test_truncation_at_max_steps():
  env = _port("MiniGrid-Empty-5x5-v0", num_envs=2, max_episode_steps=7)
  env.reset()
  for _ in range(6):
    _, _, term, trunc, _ = env.step(np.zeros(2, np.int32))
    assert not np.any(term | trunc)
  _, _, term, trunc, _ = env.step(np.zeros(2, np.int32))
  assert np.all(trunc)
