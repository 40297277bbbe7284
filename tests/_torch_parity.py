"""Helpers of the port's parity tests (``tests/test_torch_*.py``): the same
seed and actions through a pool of each package, every output field."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

import envpool_torch
import envpool_tpu


def assert_same(got, want, tag=""):
  """Equal values and dtypes through nested dicts and tuples."""
  if isinstance(want, dict):
    assert sorted(got) == sorted(want), tag
    for k in want:
      assert_same(got[k], want[k], f"{tag}/{k}")
  elif isinstance(want, tuple):
    assert len(got) == len(want), tag
    for i, (g, w) in enumerate(zip(got, want)):
      assert_same(g, w, f"{tag}/{i}")
  else:
    want = np.asarray(want)
    assert got.dtype == want.dtype, tag
    np.testing.assert_array_equal(got, want, err_msg=tag)


def jax_rollout(task_id, kw, acts):
  """The JAX package's pool driven through its in-jit interface: one
  compiled scan over the actions, whose first step is the pool's reset
  (every lane starts done). Returns (state keys, ``len(acts) + 1`` output
  tuples in spec order, the final pool state)."""
  env = envpool_tpu.make_gymnasium(task_id, **kw)
  handle, _, _, step = env.xla()
  acts = jnp.asarray(np.concatenate([np.zeros_like(acts[:1]), acts]))
  handle, outs = jax.jit(lambda h, a: jax.lax.scan(step, h, a))(handle, acts)
  outs = [np.asarray(o) for o in outs]
  return (env.spec._state_keys, [tuple(o[t] for o in outs) for t in range(len(acts))],
          jax.tree.map(np.asarray, handle.pool))


def port_rollout(task_id, kw, acts):
  """The port's pool on the CPU: a reset, then a step per action row.
  Returns (state keys, output tuples in spec order, the final pool state)."""
  env = envpool_torch.make_gymnasium(task_id, device="cpu", **kw)
  env.async_reset()
  outs = [tuple(env._recv())]
  for act in acts:
    env.send(act)
    outs.append(tuple(env._recv()))
  return env.spec._state_keys, outs, env.save_state()


def assert_same_config(task_id, kw):
  """Both packages' configs of ``task_id`` agree, apart from base_path."""
  got = envpool_torch.make_spec(task_id, **kw).config._replace(base_path="")
  assert got == envpool_tpu.make_spec(task_id, **kw).config._replace(base_path="")


def jax_rollout_states(task_id, kw, acts, compiler_options=None, env=None):
  """Like ``jax_rollout``, and per step also the pool state after it: one
  compiled scan of the in-jit step over ``len(acts) + 1`` steps (the first
  the reset). ``env``, where given, is the JAX pool to drive. Returns
  (state keys, output tuples, pool states as a numpy ``PoolState`` with a
  leading step axis)."""
  if env is None:
    env = envpool_tpu.make_gymnasium(task_id, **kw)
  handle, _, _, step = env.xla()

  def body(h, a):
    h, out = step(h, a)
    return h, (out, h.pool)

  acts = jnp.asarray(np.concatenate([np.zeros_like(acts[:1]), acts]))
  run = jax.jit(lambda h, a: jax.lax.scan(body, h, a),
                compiler_options=compiler_options)
  _, (outs, pools) = run(handle, acts)
  outs = [np.asarray(o) for o in outs]
  return (env.spec._state_keys, [tuple(o[t] for o in outs) for t in range(len(acts))],
          jax.tree.map(np.asarray, pools))


def lanes_parted(keys, got, want, tol):
  """Per lane: whether it parts anywhere in ``got`` against ``want`` (lists
  of output tuples in spec order: an integer or bool field differs, or a
  float field by more than ``tol * (1 + |x|)``), and the largest relative
  float error of each lane."""
  n = len(want[0][0])
  parted = np.zeros(n, bool)
  worst = np.zeros(n)
  for g, w in zip(got, want):
    for k, gv, wv in zip(keys, g, w):
      assert gv.dtype == wv.dtype and gv.shape == wv.shape, k
      if gv.dtype.kind == "f":
        err = np.abs(gv.astype(np.float64) - wv) / (1 + np.abs(wv))
        err = err.reshape(n, -1).max(1)
        worst = np.maximum(worst, err)
        parted |= ~(err <= tol)
      else:
        parted |= (gv != wv).reshape(n, -1).any(1)
  return parted, worst


# the dm_control contact ids' float32 pool tolerance and share of lanes that
# may part: their contacts are stiff in float32, as HalfCheetah's are
# (``test_torch_mujoco_contact_tasks.py``); no lane parted when set
DMC_CONTACT_TOL = 1e-3
DMC_CONTACT_SHARE = 0.25


def ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
  """float32 distance in units in the last place, elementwise."""
  def ordered(x):
    i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)
  return np.abs(ordered(got) - ordered(want))


def _recv(env):
  return tuple(np.array(x, copy=True) for x in env._recv())


def init_keys(n, seed=0, first_advance=False):
  """The reset keys of a JAX pool's lanes, ``[n, 2]`` int64: its init
  (``split(fold_in(PRNGKey(seed), i))[1]``, the reset that builds the
  pool's first state) or, with ``first_advance``, its first advance (the
  split of the carried half)."""
  def keys(i):
    carry, sub = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), i))
    return jax.random.split(carry)[1] if first_advance else sub
  out = jax.vmap(keys)(np.arange(n, dtype=np.int32))
  return np.asarray(out).astype(np.int64)


def assert_state_close(got, want, bounds, tag):
  """Per state key: floats within ``bounds[key]`` (an integer: float32
  units in the last place, 0 where not listed, i.e. bit for bit; a float:
  absolute, for values near 0 whose ulps are tiny), other keys equal."""
  assert sorted(got) == sorted(want), tag
  for k, w in want.items():
    g, w = np.asarray(got[k]), np.asarray(w)
    assert g.dtype == w.dtype and g.shape == w.shape, (tag, k)
    bound = bounds.get(k, 0)
    if isinstance(bound, float):
      np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=f"{tag} {k}")
    elif w.dtype.kind == "f":
      assert ulps(g, w).max(initial=0) <= bound, (tag, k, ulps(g, w).max())
    else:
      np.testing.assert_array_equal(g, w, err_msg=f"{tag} {k}")


def pool_parity(task_id, n, steps, carried_at, tol, share, draws=None,
                reset_tol=1e-6):
  """The port's pool (CPU, float32) against the JAX package's on seed 0
  and numpy-seeded uniform actions.

  - The reset draws: the JAX pool's first state, built at its
    construction by its reset compiled at XLA's default level (whose
    multiply-add contraction the port's ``prng.uniform`` mirrors), against
    the port class's reset on the same keys, per ``assert_state_close``
    with ``draws`` (None: skipped, for a reset that is not a draw alone).
  - The scan of the JAX pool's in-jit step, compiled at XLA's backend
    optimisation level 0, against the port's pool: the reset state within
    ``reset_tol`` relative (at level 0 XLA leaves the multiply-adds of a
    uniform draw uncontracted, a few ulps off), then every step's outputs,
    integer and bool fields equal, floats within ``tol * (1 + |x|)`` on
    every lane but those that part, counted against ``share`` of the
    lanes.
  - A fresh port pool loaded with the JAX pool's state after ``carried_at``
    steps (``load_state``, ``state_from_numpy``) steps the rest of the
    actions against the JAX pool's outputs, under the same bound.

  Returns the counts."""
  spec = envpool_torch.make_spec(task_id)
  aspec = spec.action_array_spec["action"]
  acts = np.random.default_rng(1).uniform(
    aspec.minimum, aspec.maximum, (steps, n, aspec.shape[-1])).astype(np.float32)
  jenv = envpool_tpu.make_gymnasium(task_id, num_envs=n, seed=0)
  if draws is not None:
    want0 = jax.tree.map(np.asarray, jenv.xla()[0].pool.env)
    got0, _, _ = spec._env_cls.reset(spec.config, None,
                                     torch.from_numpy(init_keys(n)))
    assert_state_close({k: v.numpy() for k, v in got0.items()}, want0, draws,
                       f"{task_id} draws")
  keys, want, pools = jax_rollout_states(
    task_id, None, acts, env=jenv,
    compiler_options={"xla_backend_optimization_level": 0})
  env = envpool_torch.make_gymnasium(task_id, num_envs=n, seed=0, device="cpu")
  env.async_reset()
  got = [_recv(env)]
  reset_state = env.save_state().env
  for a in acts:
    env.send(a)
    got.append(_recv(env))
  want_state = jax.tree.map(lambda x: x[0], pools).env
  assert sorted(reset_state) == sorted(want_state), task_id
  for k, w in want_state.items():
    g = np.asarray(reset_state[k])
    assert g.dtype == w.dtype and g.shape == w.shape, (task_id, k)
    if w.dtype.kind == "f":
      np.testing.assert_allclose(g, w, rtol=reset_tol, atol=reset_tol,
                                 err_msg=f"{task_id} reset {k}")
    else:
      np.testing.assert_array_equal(g, w, err_msg=f"{task_id} reset {k}")
  parted, worst = lanes_parted(keys, got, want, tol)

  carried = jax.tree.map(lambda x: x[carried_at], pools)
  env2 = envpool_torch.make_gymnasium(task_id, num_envs=n, seed=0, device="cpu")
  env2.load_state(carried)
  got2 = []
  for a in acts[carried_at:]:
    env2.send(a)
    got2.append(_recv(env2))
  parted2, worst2 = lanes_parted(keys, got2, want[carried_at + 1:], tol)
  res = dict(parted=int(parted.sum()), parted_carried=int(parted2.sum()),
             worst=float(worst[~parted].max(initial=0)),
             worst_carried=float(worst2[~parted2].max(initial=0)))
  assert parted.mean() <= share and parted2.mean() <= share, (task_id, res)
  return res
