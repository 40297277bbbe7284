"""The port's BipedalWalker pair (CPU) against ``envpool_tpu``: the terrain
of both ids and the lidar fractions bit for bit, the reset, the step from
states carried over from the JAX package, a short horizon from reset;
twins of ``tests/test_bipedal_walker.py``.

The JAX package derives the dynamics by autodiff (``jax.jacfwd``,
``jax.grad``, ``jax.jvp``) and solves with XLA's LU; the port writes the
Jacobians in closed form and solves with LAPACK's. The two agree to float32
rounding, and the walker's contacts (9 simultaneous impulses, friction 2.5)
make it chaotic, so an ulp can grow into a lane that parts. Tolerances:

- terrain (grass walk, hardcore overlays) and lidar fractions: bit for bit;
- one step from a carried state: lidar, termination and the contact flags
  equal and the other observations and the reward within ``1e-4 * (1 +
  |x|)``, except in at most 2 of the 480 lane-steps of each run (lanes that
  part: a contact that flips, or a state that blows up);
- from reset over 10 steps without resets: the same, with ``1e-3 * (1 +
  |x|)`` and at most 3 of the 16 lanes parting.

The JAX package's own walker blows up in some lanes under random actions
(velocities of 1e3 and more, then NaN): the impulses of its 9 contact
points are applied together, unprojected. The port reproduces it; NaN
lanes count as equal when both are NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_torch
from envpool_torch.envs.box2d import bipedal_walker as port_bw
from envpool_tpu.envs.box2d import bipedal_walker as jax_bw

torch.set_num_threads(1)

N = 16


@pytest.fixture(scope="module")
def jax_fns():
  """The JAX package's reset and step, jitted and vmapped once; Hardcore
  shares the step (only its terrain differs) and adds its terrain."""
  cls = jax_bw.BipedalWalkerEnv
  return {
    "reset": jax.jit(jax.vmap(lambda k: cls.reset(None, None, k))),
    "step": jax.jit(jax.vmap(lambda s, a, k: cls.step(None, s, a, k))),
    "terrain": {hc: jax.jit(jax.vmap(lambda k, h=hc: jax_bw._terrain_heights(k, h)))
                for hc in (False, True)},
  }


def _keys(seed, n=N):
  keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
  return keys, torch.from_numpy(keys.astype(np.int64))


def _port_state(st):
  return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


def _parted(got, want, tol):
  """Per lane: does the port's (obs, reward, term) differ from the JAX
  package's beyond ``tol * (1 + |x|)`` in the floats, or at all in the
  lidar, the contact flags and termination? NaN equals NaN."""
  g_obs, w_obs = got[1].numpy(), np.asarray(want[1])
  g_rew, w_rew = got[2].numpy(), np.asarray(want[2])
  assert g_obs.dtype == w_obs.dtype and g_obs.shape == w_obs.shape
  both_nan = np.isnan(g_obs).any(1) & np.isnan(w_obs).any(1)
  floats = np.concatenate([g_obs[:, :14] - w_obs[:, :14], (g_rew - w_rew)[:, None]], 1)
  scale = 1 + np.abs(np.concatenate([w_obs[:, :14], w_rew[:, None]], 1))
  exact = [8, 13] + list(range(14, 24))
  bad = (
    (np.abs(floats) > tol * scale).any(1)
    | (g_obs[:, exact] != w_obs[:, exact]).any(1)
    | (got[3].numpy() != np.asarray(want[3]))
  )
  return bad & ~both_nan


def test_lidar_fractions_bit_exact():
  want = np.asarray(jnp.linspace(0.0, 1.0, 64))
  np.testing.assert_array_equal(port_bw.LIDAR_FRACTIONS.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("hardcore", [False, True])
def test_terrain_bit_exact(jax_fns, hardcore):
  keys, tkeys = _keys(2, 64)
  want = np.asarray(jax_fns["terrain"][hardcore](keys))
  np.testing.assert_array_equal(port_bw._terrain_heights(tkeys, hardcore).numpy(), want)


def test_reset(jax_fns):
  """The reset state and obs: terrain, bools and contacts equal, floats to
  float32 rounding."""
  keys, tkeys = _keys(0)
  w_st, w_obs, _ = jax_fns["reset"](keys)
  g_st, g_obs, _ = port_bw.BipedalWalkerEnv.reset(None, None, tkeys)
  np.testing.assert_allclose(g_obs.numpy(), np.asarray(w_obs), rtol=0, atol=1e-5)
  for k in w_st:
    g, w = g_st[k].numpy(), np.asarray(w_st[k])
    if k in ("q", "qd", "prev_shaping"):
      np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)
    else:
      np.testing.assert_array_equal(g, w, err_msg=k)


def _hardcore_start(tkeys):
  """Hardcore lanes before the reset's zero-action step (its terrain is what
  differs from BipedalWalker-v3's reset)."""
  st, _ = port_bw.BipedalWalkerHardcoreEnv.start_state(tkeys)
  return {k: v.numpy() for k, v in st.items()}


@pytest.mark.parametrize("task_id", ["BipedalWalker-v3", "BipedalWalkerHardcore-v3"])
def test_step_from_carried_states(jax_fns, task_id):
  """30 steps of 16 lanes under random actions, each from the JAX
  package's state; lanes that end are reset (v3 by the JAX package,
  Hardcore to ``_hardcore_start``, whose first step is the reset's)."""
  step = jax_fns["step"]

  def fresh(keys, tkeys):
    if task_id == "BipedalWalker-v3":
      return jax.tree.map(np.asarray, jax_fns["reset"](keys)[0])
    return _hardcore_start(tkeys)

  st = fresh(*_keys(1))
  rng = np.random.default_rng(0)
  parted = 0
  for t in range(30):
    act = rng.uniform(-1, 1, (N, 4)).astype(np.float32)
    keys, tkeys = _keys(100 + t)
    want = step(st, act, keys)
    got = port_bw.BipedalWalkerEnv.step(None, _port_state(st), torch.from_numpy(act), tkeys)
    parted += int(_parted(got, want, 1e-4).sum())
    w_st = jax.tree.map(np.asarray, want[0])
    for k in ("terrain", "first"):
      np.testing.assert_array_equal(got[0][k].numpy(), w_st[k])
    st = w_st
    done = np.asarray(want[3])
    if done.any():
      new = fresh(keys, tkeys)
      st = {k: np.where(done.reshape((-1,) + (1,) * (v.ndim - 1)), new[k], v)
            for k, v in st.items()}
  assert parted <= 2, parted


@pytest.mark.parametrize("task_id", ["BipedalWalker-v3", "BipedalWalkerHardcore-v3"])
def test_horizon_from_reset(jax_fns, task_id):
  """Each package carries its own state for 10 steps from the same reset
  (Hardcore: from ``_hardcore_start``, 11 steps, the first the reset's)."""
  keys, tkeys = _keys(0)
  if task_id == "BipedalWalker-v3":
    w = jax_fns["reset"](keys)[0]
    g = port_bw.BipedalWalkerEnv.reset(None, None, tkeys)[0]
  else:
    w = _hardcore_start(tkeys)
    g = _port_state(w)
  rng = np.random.default_rng(0)
  parted = np.zeros(N, bool)
  for _ in range(10 if task_id == "BipedalWalker-v3" else 11):
    act = rng.uniform(-1, 1, (N, 4)).astype(np.float32)
    want = jax_fns["step"](w, act, keys)
    got = port_bw.BipedalWalkerEnv.step(None, g, torch.from_numpy(act), tkeys)
    parted |= _parted(got, want, 1e-3)
    w, g = want[0], got[0]
  assert parted.sum() <= 3, parted


# ------------------------------------------------ test_bipedal_walker twins


def _run(task, seed, steps, num_envs=4, act=None):
  env = envpool_torch.make_gymnasium(task, num_envs=num_envs, seed=seed, device="cpu")
  obs, _ = env.reset()
  o, r, d = [obs], [], []
  for t in range(steps):
    a = act(t) if act else np.zeros((num_envs, 4), np.float32)
    obs, rew, term, trunc, _ = env.step(a)
    o.append(obs)
    r.append(rew)
    d.append(term | trunc)
  return np.stack(o), np.stack(r), np.stack(d)


def test_spec() -> None:
  spec = envpool_torch.make_spec("BipedalWalker-v3", num_envs=1)
  assert spec.state_array_spec["obs"].shape == (24,)
  assert spec.action_array_spec["action"].shape == (-1, 4)
  assert spec.config.max_episode_steps == 1600
  assert envpool_torch.make_spec("BipedalWalkerHardcore-v3").config.max_episode_steps == 2000


def test_determinism_and_finiteness() -> None:
  o1, r1, _ = _run("BipedalWalker-v3", 3, 30)
  o2, r2, _ = _run("BipedalWalker-v3", 3, 30)
  o3, _, _ = _run("BipedalWalker-v3", 4, 30)
  np.testing.assert_array_equal(o1, o2)
  assert not np.array_equal(o1, o3)
  assert np.isfinite(o1).all() and np.isfinite(r1).all()
  assert np.all((o1[..., 14:] >= 0) & (o1[..., 14:] <= 1))


def test_random_policy_falls_with_crash_penalty() -> None:
  rng = np.random.default_rng(0)
  obs, rew, done = _run(
    "BipedalWalker-v3", 5, 120, num_envs=8,
    act=lambda t: rng.uniform(-1, 1, (8, 4)).astype(np.float32),
  )
  ended = done.any(axis=0)
  assert ended.mean() >= 0.5
  first = done.argmax(axis=0)
  term_rew = rew[first, np.arange(8)][ended]
  assert np.all(term_rew == -100.0)


def test_motors_move_joints() -> None:
  o_idle, _, _ = _run("BipedalWalker-v3", 9, 10)
  o_act, _, _ = _run(
    "BipedalWalker-v3", 9, 10,
    act=lambda t: np.tile(np.asarray([[1.0, 0, 0, 0]], np.float32), (4, 1)),
  )
  assert np.all(o_act[10][:, 4] > 0.3)
  assert np.all(o_act[10][:, 4] > o_idle[10][:, 4] + 0.3)


def test_hardcore_variant() -> None:
  env = envpool_torch.make_gymnasium(
    "BipedalWalkerHardcore-v3", num_envs=2, seed=0, device="cpu"
  )
  obs, _ = env.reset()
  assert obs.shape == (2, 24)
  obs, rew, term, trunc, _ = env.step(np.zeros((2, 4), np.float32))
  assert np.isfinite(obs).all()
