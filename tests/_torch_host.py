"""Helpers of the port's host-tier tests (``tests/test_torch_*host*.py``,
``test_torch_atari_stack.py``): the same seed and actions through a
``HostEnvPool`` of each package, every output field bit for bit."""

from __future__ import annotations

import numpy as np


def uniform_actions(spec, n: int, steps: int, seed: int) -> np.ndarray:
  """``[steps, n, ...]`` actions drawn uniformly inside the action bounds
  (``[-1, 1]`` where a bound is not finite), in the action's dtype."""
  a = spec.action_array_spec["action"]
  shape = a.static_shape
  lo = np.broadcast_to(np.asarray(a.minimum, np.float64), shape)
  hi = np.broadcast_to(np.asarray(a.maximum, np.float64), shape)
  lo = np.where(np.isfinite(lo), lo, -1.0)
  hi = np.where(np.isfinite(hi), hi, 1.0)
  rng = np.random.default_rng(seed)
  return rng.uniform(lo, hi, (steps, n, *shape)).astype(a.dtype)


def host_rollout(env, acts, env_id=None) -> list:
  """A reset of every env, then one send/recv per action batch; the raw
  output lists (spec order) of each recv."""
  env._reset(env.all_env_ids)
  outs = [env._recv()]
  for act in acts:
    env.send(act, env_id)
    outs.append(env._recv())
  return outs


def assert_outputs_equal(keys, got, want, tag: str = "") -> None:
  """Output lists of equal length, every field of every step equal in
  dtype, shape and value (NaN equal to NaN)."""
  assert len(got) == len(want), tag
  for t, (g, w) in enumerate(zip(got, want)):
    assert len(g) == len(w) == len(keys), tag
    for k, x, y in zip(keys, g, w):
      x, y = np.asarray(x), np.asarray(y)
      assert x.dtype == y.dtype, (tag, t, k, x.dtype, y.dtype)
      np.testing.assert_array_equal(x, y, err_msg=f"{tag} step {t} {k}")


def async_sequences(env, rounds: int, act_table: np.ndarray) -> dict:
  """Drive an async pool for ``rounds`` recv/send rounds from an
  ``async_reset``; env ``e``'s ``k``-th action is ``act_table[e, k]``, so
  what each env sees does not depend on the completion order. Returns each
  env's outputs, in its own order, as tuples of rows."""
  keys = env.spec._state_keys
  id_col = keys.index("info:env_id")
  seqs = {e: [] for e in range(len(act_table))}
  env.async_reset()
  for _ in range(rounds):
    out = env._recv()
    ids = np.asarray(out[id_col])
    for r, e in enumerate(ids.tolist()):
      seqs[e].append(tuple(col[r] for col in out))
    acts = np.stack([act_table[e, len(seqs[e]) - 1] for e in ids.tolist()])
    env.send(acts, ids)
  return seqs


def assert_sequences_equal(keys, got: dict, want: dict, min_len: int) -> None:
  """Each env's common prefix equal field by field, at least ``min_len``
  long."""
  assert sorted(got) == sorted(want)
  for e in want:
    n = min(len(got[e]), len(want[e]))
    assert n >= min_len, (e, len(got[e]), len(want[e]))
    assert_outputs_equal(keys, got[e][:n], want[e][:n], f"env {e}")
