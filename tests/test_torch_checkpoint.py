"""Pool checkpoint/resume of the port (``envpool_torch/utils/checkpoint.py``):
the twin of ``tests/test_checkpoint.py``, plus a sharded pool's files and
a JAX package snapshot carried through a file.

A snapshot must round-trip exactly: save mid-episode, keep stepping,
restore, and replay bit for bit.
"""

import jax
import numpy as np
import torch

import envpool_torch
import envpool_tpu
from envpool_torch.parallel import ShardedEnvPool, make_mesh
from envpool_torch.utils import load_pool_state, save_pool_state

from _torch_parity import assert_same

torch.set_num_threads(1)


def test_save_restore_bit_exact():
  env = envpool_torch.make_gymnasium("CartPole-v1", num_envs=8, seed=4, device="cpu")
  env.reset()
  acts = np.zeros(8, np.int32)
  for _ in range(5):
    env.step(acts)
  snap = env.save_state()
  ref = [np.asarray(env.step(acts)[0]) for _ in range(5)]
  env.load_state(snap)
  replay = [np.asarray(env.step(acts)[0]) for _ in range(5)]
  for a, b in zip(ref, replay):
    np.testing.assert_array_equal(a, b)


def test_save_restore_via_files(tmp_path):
  env = envpool_torch.make_gymnasium("Catch-v0", num_envs=4, seed=0, device="cpu")
  env.reset()
  env.step(np.zeros(4, np.int32))
  path = str(tmp_path / "pool_ckpt")
  save_pool_state(env, path)
  assert (tmp_path / "pool_ckpt.npz").exists()
  obs_a, *_ = env.step(np.ones(4, np.int32))
  load_pool_state(env, path)
  obs_b, *_ = env.step(np.ones(4, np.int32))
  np.testing.assert_array_equal(obs_a, obs_b)


def test_sharded_pool_via_files(tmp_path):
  """A file of a sharded pool (4 shards) replays bit for bit in it, and
  loads into the unsharded pool of the same spec."""
  kw = dict(num_envs=8, seed=2, max_episode_steps=6, levels_dir="", n_levels_to_load=16)
  spec = envpool_torch.make_spec("Sokoban-v0", **kw)
  env = ShardedEnvPool(spec, make_mesh(devices=["cpu"] * 4))
  ids = np.arange(8, dtype=np.int32)
  rng = np.random.default_rng(0)
  acts = [rng.integers(0, 4, 8).astype(np.int32) for _ in range(10)]
  env._reset(ids)
  env._recv()
  for a in acts[:3]:
    env._send([ids, ids, a])
    env._recv()
  path = str(tmp_path / "sharded.npz")
  save_pool_state(env, path)

  def replay(pool):
    outs = []
    for a in acts[3:]:
      pool._send([ids, ids, a])
      outs.append(tuple(pool._recv()))
    return outs

  want = replay(env)
  load_pool_state(env, path)
  plain = envpool_torch.make_gymnasium("Sokoban-v0", device="cpu", **kw)
  load_pool_state(plain, path)
  for got in (replay(env), replay(plain)):
    for t, (g, w) in enumerate(zip(got, want)):
      assert_same(g, w, f"step {t}")


def test_jax_snapshot_through_a_file(tmp_path):
  """A JAX pool's ``save_state()`` carried into the port, written with
  ``save_pool_state`` and read into a fresh pool, steps as the JAX pool
  does (CartPole-v1: integer fields equal, floats to 1e-5)."""
  kw = dict(num_envs=8, seed=9)
  jenv = envpool_tpu.make_gymnasium("CartPole-v1", **kw)
  jenv.reset()
  for _ in range(3):
    jenv.step(np.ones(8, np.int32))
  carrier = envpool_torch.make_gymnasium("CartPole-v1", device="cpu", **kw)
  carrier.load_state(jax.tree.map(np.asarray, jenv.save_state()))
  save_pool_state(carrier, str(tmp_path / "from_jax"))
  env = envpool_torch.make_gymnasium("CartPole-v1", device="cpu", **kw)
  load_pool_state(env, str(tmp_path / "from_jax"))
  for t in range(6):
    act = np.full(8, t % 2, np.int32)
    got, want = env.step(act), jenv.step(act)
    for g, w in zip(got[:4], want[:4]):
      w = np.asarray(w)
      if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
      else:
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[4]["elapsed_step"], want[4]["elapsed_step"])
