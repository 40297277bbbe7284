"""Helpers of the port's parity tests (``tests/test_torch_*.py``): the same
seed and actions through a pool of each package, every output field."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

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


def jax_rollout_states(task_id, kw, acts, compiler_options=None):
  """Like ``jax_rollout``, and per step also the pool state after it: one
  compiled scan of the in-jit step over ``len(acts) + 1`` steps (the first
  the reset). Returns (state keys, output tuples, pool states as a numpy
  ``PoolState`` with a leading step axis)."""
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
