"""The port's LunarLander pair (CPU) against ``envpool_tpu``: the terrain and
the reset bit for bit, the step from states carried over from the JAX
package, the pool over a horizon from reset; specs of the four Box2D ids;
twins of ``tests/test_box2d.py``'s behaviour checks.

Tolerances. The reset (terrain, initial force, one zero-action step) is bit
for bit: the port computes the step's divisions by constants, its folded
constant factors and its squared norms as XLA-CPU does. Later steps are
not: XLA contracts other multiply-adds of the substeps and its sin and cos
differ from torch's by an ulp, so the float fields are held to
``rtol=1e-5, atol=1e-4`` (observations below 10 in magnitude) and rewards
(shaping differences of values up to a few hundred, or +-100) to 1e-3
absolute. Bool and integer fields (termination, the legs' contact flags,
the crash flag, elapsed steps) are equal, and no lane parts in these runs.
"""

import jax
import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu
from envpool_torch.envs.box2d import lunar_lander as port_ll
from envpool_tpu.envs.box2d import lunar_lander as jax_ll

from _torch_parity import assert_same_config, jax_rollout, port_rollout

torch.set_num_threads(1)

N = 16
OBS_TOL = dict(rtol=1e-5, atol=1e-4)
REW_ATOL = 1e-3
CLASSES = {
  "LunarLander-v2": (jax_ll.LunarLanderEnv, port_ll.LunarLanderEnv),
  "LunarLanderContinuous-v2": (
    jax_ll.LunarLanderContinuousEnv, port_ll.LunarLanderContinuousEnv
  ),
}
BOX2D_IDS = [
  "LunarLander-v2", "LunarLanderContinuous-v2", "BipedalWalker-v3",
  "BipedalWalkerHardcore-v3",
]


@pytest.fixture(scope="module")
def jax_fns():
  """One jitted, vmapped reset and step of each JAX class."""
  fns = {}
  for task_id, (cls, _) in CLASSES.items():
    fns[task_id] = (
      jax.jit(jax.vmap(lambda k, c=cls: c.reset(None, None, k))),
      jax.jit(jax.vmap(lambda s, a, k, c=cls: c.step(None, s, a, k))),
    )
  return fns


def _keys(seed, n=N):
  keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
  return keys, torch.from_numpy(keys.astype(np.int64))


def _actions(rng, task_id, n=N):
  if task_id == "LunarLanderContinuous-v2":
    return rng.uniform(-1, 1, (n, 2)).astype(np.float32)
  return rng.integers(0, 4, n).astype(np.int32)


def _port_state(st):
  return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


def _assert_step_close(got, want, tag):
  """(state, obs, reward, term) of both packages to the stated tolerance."""
  g_st, g_obs, g_rew, g_term = (got[0], got[1].numpy(), got[2].numpy(), got[3].numpy())
  w_st, w_obs, w_rew, w_term = (
    {k: np.asarray(v) for k, v in want[0].items()}, *map(np.asarray, want[1:4])
  )
  np.testing.assert_array_equal(g_term, w_term, err_msg=tag)
  np.testing.assert_array_equal(g_obs[:, 6:], w_obs[:, 6:], err_msg=tag)
  np.testing.assert_allclose(g_obs, w_obs, **OBS_TOL, err_msg=tag)
  np.testing.assert_allclose(g_rew, w_rew, rtol=0, atol=REW_ATOL, err_msg=tag)
  for k, w in w_st.items():
    g = g_st[k].numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, (tag, k)
    if w.dtype == np.float32 and k not in ("ground_contact", "sleep_time"):
      np.testing.assert_allclose(g, w, rtol=1e-5, atol=REW_ATOL, err_msg=f"{tag} {k}")
    else:
      np.testing.assert_array_equal(g, w, err_msg=f"{tag} {k}")


@pytest.mark.parametrize("task_id", BOX2D_IDS)
def test_spec_matches_jax_package(task_id):
  assert_same_config(task_id, {})
  got, want = envpool_torch.make_spec(task_id), envpool_tpu.make_spec(task_id)
  for g_spec, w_spec in ((got.state_array_spec, want.state_array_spec),
                         (got.action_array_spec, want.action_array_spec)):
    assert list(g_spec) == list(w_spec)
    for k in w_spec:
      g, w = g_spec[k], w_spec[k]
      assert (g.dtype, g.shape) == (w.dtype, w.shape), (task_id, k)
      np.testing.assert_array_equal(g.minimum, w.minimum)
      np.testing.assert_array_equal(g.maximum, w.maximum)


def test_terrain_bit_exact():
  keys, tkeys = _keys(3, 64)
  want = jax.jit(jax.vmap(lambda k: jax_ll._terrain(k)[1]))(keys)
  np.testing.assert_array_equal(port_ll._terrain(tkeys).numpy(), np.asarray(want))


@pytest.mark.parametrize("task_id", list(CLASSES))
def test_reset_bit_exact(jax_fns, task_id):
  keys, tkeys = _keys(0)
  w_st, w_obs, _ = jax_fns[task_id][0](keys)
  g_st, g_obs, _ = CLASSES[task_id][1].reset(None, None, tkeys)
  np.testing.assert_array_equal(g_obs.numpy(), np.asarray(w_obs))
  for k in w_st:
    np.testing.assert_array_equal(g_st[k].numpy(), np.asarray(w_st[k]), err_msg=k)


@pytest.mark.parametrize("task_id", list(CLASSES))
def test_step_from_carried_states(jax_fns, task_id):
  """200 steps of 16 lanes under random actions, each step from the JAX
  package's state (lanes that end are reset by the JAX package)."""
  reset, step = jax_fns[task_id]
  port_cls = CLASSES[task_id][1]
  st = jax.tree.map(np.asarray, reset(_keys(1)[0])[0])
  rng = np.random.default_rng(0)
  ended = 0
  for t in range(200):
    act = _actions(rng, task_id)
    keys, tkeys = _keys(100 + t)
    want = step(st, act, keys)
    got = port_cls.step(None, _port_state(st), torch.from_numpy(act), tkeys)
    _assert_step_close(got, want, f"{task_id} step {t}")
    st = jax.tree.map(np.asarray, want[0])
    done = np.asarray(want[3])
    ended += int(done.sum())
    if done.any():
      fresh = jax.tree.map(np.asarray, reset(keys)[0])
      st = {k: np.where(done.reshape((-1,) + (1,) * (v.ndim - 1)), fresh[k], v)
            for k, v in st.items()}
  assert ended >= 8


@pytest.mark.parametrize("task_id", list(CLASSES))
def test_pool_horizon_from_reset(task_id):
  """Both pools from one seed and the same actions, reset + 60 steps with a
  cap of 25 (every lane auto-resets twice through the pool's key stream):
  integer and bool fields equal, floats to the stated tolerance."""
  kw = dict(num_envs=N, seed=5, max_episode_steps=25)
  rng = np.random.default_rng(1)
  acts = np.stack([_actions(rng, task_id) for _ in range(60)])
  keys, want, w_st = jax_rollout(task_id, kw, acts)
  _, got, g_st = port_rollout(task_id, kw, acts)
  for t, (g, w) in enumerate(zip(got, want)):
    for k, gv, wv in zip(keys, g, w):
      assert gv.dtype == wv.dtype, (t, k)
      if k == "obs":
        np.testing.assert_array_equal(gv[:, 6:], wv[:, 6:], err_msg=f"step {t}")
        np.testing.assert_allclose(gv, wv, **OBS_TOL, err_msg=f"step {t}")
      elif k == "reward":
        np.testing.assert_allclose(gv, wv, rtol=0, atol=REW_ATOL, err_msg=f"step {t}")
      else:
        np.testing.assert_array_equal(gv, wv, err_msg=f"step {t} {k}")
  np.testing.assert_array_equal(g_st.rng, w_st.rng)
  np.testing.assert_array_equal(g_st.env["smooth_y"], w_st.env["smooth_y"])
  elapsed = np.stack([g[keys.index("elapsed_step")] for g in got[1:]])
  assert ((elapsed == 0).sum(0) >= 2).all()


# --------------------------------------------------------- test_box2d twins


def _run(task, seed, steps=120, action_fn=None, num_envs=8):
  env = envpool_torch.make_gymnasium(task, num_envs=num_envs, seed=seed, device="cpu")
  obs, _ = env.reset()
  traj_obs, traj_rew, traj_done = [obs], [], []
  for t in range(steps):
    act = np.zeros(num_envs, np.int32) if action_fn is None else action_fn(t, obs)
    obs, rew, term, trunc, _ = env.step(act)
    traj_obs.append(obs)
    traj_rew.append(rew)
    traj_done.append(term | trunc)
  return np.stack(traj_obs), np.stack(traj_rew), np.stack(traj_done)


def test_determinism() -> None:
  o1, r1, d1 = _run("LunarLander-v2", seed=7, steps=50)
  o2, r2, d2 = _run("LunarLander-v2", seed=7, steps=50)
  o3, _, _ = _run("LunarLander-v2", seed=8, steps=50)
  np.testing.assert_array_equal(o1, o2)
  np.testing.assert_array_equal(r1, r2)
  assert not np.array_equal(o1, o3)


def test_gravity_and_obs_layout() -> None:
  obs, rew, done = _run("LunarLander-v2", seed=1, steps=12)
  first, later = obs[0], obs[10]
  airborne = ~done[:10].any(axis=0)
  assert airborne.any()
  assert np.all(later[airborne, 3] < first[airborne, 3])
  assert np.all(np.abs(first[:, 1] - 1.41) < 0.1)
  assert obs.shape[-1] == 8


def test_main_engine_brakes_fall() -> None:
  o_off, _, d_off = _run("LunarLander-v2", seed=3, steps=30)
  o_on, _, d_on = _run(
    "LunarLander-v2", seed=3, steps=30,
    action_fn=lambda t, o: np.full(8, 2, np.int32),
  )
  m = ~(d_off[:29].any(axis=0) | d_on[:29].any(axis=0))
  assert m.any()
  assert np.mean(o_on[30][m, 3] - o_off[30][m, 3] > 0) > 0.7


def test_crash_gives_minus_100() -> None:
  obs, rew, done = _run("LunarLander-v2", seed=5, steps=400, num_envs=16)
  first_done = done.argmax(axis=0)
  ended = done.any(axis=0)
  assert ended.mean() > 0.8
  terminal_rewards = rew[first_done, np.arange(rew.shape[1])][ended]
  assert np.all(
    (np.abs(terminal_rewards - (-100.0)) < 1e-4)
    | (np.abs(terminal_rewards - 100.0) < 1e-4)
  )


def test_continuous_action_space() -> None:
  env = envpool_torch.make_gymnasium(
    "LunarLanderContinuous-v2", num_envs=4, seed=0, device="cpu"
  )
  assert env.action_space.shape == (2,)
  env.reset()
  obs, rew, term, trunc, _ = env.step(np.zeros((4, 2), np.float32))
  assert obs.shape == (4, 8)


def test_device_defaults_to_cuda():
  """Without a card an entry point called without ``device`` raises."""
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default pool runs there")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    envpool_torch.make_gymnasium("LunarLander-v2", num_envs=2)
