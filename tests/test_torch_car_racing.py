"""Slice parity: the port's CarRacing-v2 pool against the JAX package's.

Both pools get the same seed and numpy-seeded actions on the CPU. Integer
and bool fields must match exactly, rewards to 1e-4. Observations must
agree on at least 99% of the pixels of every env: float32 trig and
multiply-adds on XLA-CPU (which contracts a*b+c into fused multiply-adds)
and torch-CPU can differ by one ulp, and one ulp can flip a rounded shear
row or a polygon edge pixel. The JAX pool is built (and compiled) once.
"""

import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu

# the suite runs in several worker processes that share the cores: one
# intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

N = 4
KW = dict(num_envs=N, seed=0, n_tracks=2)
STEPS = 20
TEACHER_STEP = 10
INT_STATE = ("track_id", "visited", "visited_count", "new_lap")


def actions(seed, steps, n=N):
  rng = np.random.default_rng(seed)
  return [
    np.stack([
      rng.uniform(-1, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    ], 1).astype(np.float32)
    for _ in range(steps)
  ]


def rollout(env, acts):
  """reset + steps; returns (init state, outputs, state before each step)."""
  init = env.save_state()
  outs = [env.reset()]
  states = []
  for a in acts:
    states.append(env.save_state())
    outs.append(env.step(a))
  return init, outs, states


def assert_obs_close(want, got, frac):
  assert want.shape == got.shape and got.dtype == np.uint8
  eq = (want == got).all(-1).mean(axis=(-2, -1))
  assert np.all(eq >= frac), eq


def assert_step_close(want, got):
  """Gymnasium 5-tuples (or reset 2-tuples) of both packages."""
  *w, w_info = want
  *g, g_info = got
  assert_obs_close(w[0], g[0], 0.99)
  if len(w) == 4:
    np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(g[2], w[2])
    np.testing.assert_array_equal(g[3], w[3])
  for k in ("env_id", "elapsed_step", "tile_visited_count"):
    np.testing.assert_array_equal(g_info[k], w_info[k])


@pytest.fixture(scope="module")
def jax_run():
  env = envpool_tpu.make_gymnasium("CarRacing-v2", **KW)
  acts = actions(0, STEPS)
  init, outs, states = rollout(env, acts)
  # teacher forcing: one step from a carried state, on the coarse path (as
  # rolled out) and on the fine path (past the first-second zoom)
  base = states[TEACHER_STEP]
  fine = base._replace(env=dict(base.env, t=np.asarray(base.env["t"]) + 1.5))
  forced = {}
  for name, st in (("coarse", base), ("fine", fine)):
    env.load_state(st)
    out = env.step(acts[TEACHER_STEP])
    forced[name] = (st, out, env.save_state())
  return dict(
    env=env, acts=acts, init=init, outs=outs, states=states, forced=forced
  )


@pytest.fixture(scope="module")
def torch_env():
  return envpool_torch.make_gymnasium("CarRacing-v2", device="cpu", **KW)


def test_config_and_spec_match(jax_run, torch_env):
  want = dict(jax_run["env"].config)
  got = dict(torch_env.config)
  want.pop("base_path")
  got.pop("base_path")
  assert got == want
  assert torch_env.spec._state_keys == jax_run["env"].spec._state_keys
  assert torch_env.spec._action_keys == jax_run["env"].spec._action_keys


def test_rollout_matches(jax_run):
  env = envpool_torch.make_gymnasium("CarRacing-v2", device="cpu", **KW)
  init, outs, _ = rollout(env, jax_run["acts"])
  j_init = jax_run["init"]
  np.testing.assert_array_equal(init.rng, np.asarray(j_init.rng))
  for k, v in j_init.env.items():
    np.testing.assert_allclose(init.env[k], np.asarray(v), rtol=1e-6, atol=0)
  assert len(outs) == STEPS + 1
  for want, got in zip(jax_run["outs"], outs):
    assert_step_close(want, got)


@pytest.mark.parametrize("path", ["coarse", "fine"])
def test_teacher_forced_step(jax_run, torch_env, path):
  st, want, want_state = jax_run["forced"][path]
  torch_env.load_state(st)
  got = torch_env.step(jax_run["acts"][TEACHER_STEP])
  # the whole batch: >= 99.5% of pixels equal
  eq = (want[0] == got[0]).all(-1).mean()
  assert eq >= 0.995, eq
  np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
  for i in (2, 3):
    np.testing.assert_array_equal(got[i], want[i])
  got_state = torch_env.save_state()
  np.testing.assert_array_equal(got_state.rng, np.asarray(want_state.rng))
  np.testing.assert_array_equal(got_state.elapsed, np.asarray(want_state.elapsed))
  for k, v in want_state.env.items():
    v = np.asarray(v)
    if k in INT_STATE:
      np.testing.assert_array_equal(got_state.env[k], v, err_msg=k)
    else:
      np.testing.assert_allclose(got_state.env[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


def test_jax_state_carries_across(jax_run):
  """A JAX snapshot loads into the port as its PoolState, keys intact."""
  st = jax_run["states"][5]
  ps = envpool_torch.state_from_numpy(st, "cpu")
  assert set(ps.env) == set(st.env)
  assert ps.rng.dtype == torch.int64
  np.testing.assert_array_equal(ps.rng.numpy(), np.asarray(st.rng).astype(np.int64))
  np.testing.assert_array_equal(ps.env["visited"].numpy(), np.asarray(st.env["visited"]))
