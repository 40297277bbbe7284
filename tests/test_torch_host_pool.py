"""The port's host tier engine (``envpool_torch/core/host_pool.py``) on the
CPU: the twins of ``tests/test_host_pool_stress.py``, the port's
``HostEnvPool`` against the JAX package's over ``InvertedPendulum-v4`` and
``Hopper-v4`` (sync, a partial ``env_id`` subset, async per-env sequences;
every field bit for bit: the same numpy code over the same ``mj_step``),
and the ``xla()`` bridge on the CPU against the host API."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu
from envpool_torch.core.host_pool import HostEnvPool

from _torch_host import (
  assert_outputs_equal,
  assert_sequences_equal,
  async_sequences,
  host_rollout,
  uniform_actions,
)

HOST_IDS = ("InvertedPendulum-v4", "Hopper-v4")


def _make(task_id, **kw):
  return envpool_torch.make_gymnasium(task_id, device="cpu", **kw)


# ------------------------------------------------ twins of the stress tests


def test_async_hammer_first_finishers():
  num_envs, batch = 16, 4
  env = _make("InvertedPendulum-v4", num_envs=num_envs, batch_size=batch,
              num_threads=8, seed=0)
  env.async_reset()
  seen = np.zeros(num_envs, np.int64)
  for _ in range(200):
    obs, rew, term, trunc, info = env.recv()
    ids = info["env_id"]
    assert len(ids) == batch
    assert len(np.unique(ids)) == batch  # an env is never in flight twice
    seen[ids] += 1
    env.send(np.zeros((batch, 1)), env_id=ids)
  # every env keeps making progress (no starvation or deadlock)
  assert seen.min() > 0
  assert seen.sum() == 200 * batch


def test_sync_order_is_stable_under_threads():
  env = _make("InvertedPendulum-v4", num_envs=32, num_threads=8, seed=1)
  env.reset()
  for _ in range(30):
    obs, rew, term, trunc, info = env.step(np.zeros((32, 1)))
    # sync recv is ordered by send position (state_buffer.h:94-97)
    np.testing.assert_array_equal(info["env_id"], np.arange(32))


def test_partial_sync_subset():
  env = _make("InvertedPendulum-v4", num_envs=8, seed=2)
  env.reset()
  subset = np.asarray([6, 1, 3], np.int32)
  obs, rew, term, trunc, info = env.step(np.zeros((3, 1)), env_id=subset)
  np.testing.assert_array_equal(info["env_id"], subset)


def test_worker_exception_surfaces():
  env = _make("InvertedPendulum-v4", num_envs=2, seed=3)
  env.reset()
  env._envs[0].frame_skip = -1  # poison one env
  env._envs[0].mujoco_step = None
  with pytest.raises(TypeError):
    env.step(np.zeros((2, 1)))


def test_async_stress_more_threads_than_cores():
  """Twice as many workers as cores and a short switch interval: no env is
  ever in flight twice, and each env's elapsed_step goes up by one per
  step or restarts at 0 (a lost update of the pool's per-env counters
  would break it); the run ends within its time bound."""
  n_envs, batch = 24, 6
  env = _make("InvertedPendulum-v4", num_envs=n_envs, batch_size=batch,
              num_threads=2 * (os.cpu_count() or 1), seed=13)
  errors = []

  def run():
    try:
      last = np.full(n_envs, -1)
      env.async_reset()
      for _ in range(150):
        obs, rew, term, trunc, info = env.recv()
        ids, elapsed = info["env_id"], info["elapsed_step"]
        assert len(np.unique(ids)) == batch
        assert np.all((elapsed == last[ids] + 1) | (elapsed == 0))
        last[ids] = elapsed
        env.send(np.zeros((batch, 1)), env_id=ids)
    except Exception as e:  # reported by the test's own thread
      errors.append(e)

  old = sys.getswitchinterval()
  sys.setswitchinterval(1e-5)
  try:
    loop = threading.Thread(target=run, daemon=True)
    loop.start()
    loop.join(timeout=120)
  finally:
    sys.setswitchinterval(old)
  assert not loop.is_alive(), "the async loop did not finish in 120 s"
  assert not errors, errors


# ------------------------------------------- against the JAX HostEnvPool


@pytest.mark.parametrize("task_id", HOST_IDS)
def test_sync_matches_jax_pool(task_id):
  kw = dict(num_envs=4, seed=5, num_threads=3)
  got_env, want_env = _make(task_id, **kw), envpool_tpu.make_gymnasium(task_id, **kw)
  acts = uniform_actions(got_env.spec, 4, 30, seed=6)
  keys = got_env.spec._state_keys
  assert keys == want_env.spec._state_keys
  assert_outputs_equal(keys, host_rollout(got_env, acts),
                       host_rollout(want_env, acts), task_id)


@pytest.mark.parametrize("task_id", HOST_IDS)
def test_partial_subset_matches_jax_pool(task_id):
  kw = dict(num_envs=6, seed=7)
  got_env, want_env = _make(task_id, **kw), envpool_tpu.make_gymnasium(task_id, **kw)
  subset = np.asarray([5, 0, 3], np.int32)
  acts = uniform_actions(got_env.spec, 3, 15, seed=8)
  got = host_rollout(got_env, acts, subset)
  want = host_rollout(want_env, acts, subset)
  assert_outputs_equal(got_env.spec._state_keys, got, want, task_id)
  np.testing.assert_array_equal(got[-1][got_env.spec._state_keys.index("info:env_id")],
                                subset)


@pytest.mark.parametrize("task_id", HOST_IDS)
def test_async_sequences_match_jax_pool(task_id):
  """Completion order is free, so each env's own sequence is compared."""
  num_envs, batch, rounds = 8, 3, 40
  kw = dict(num_envs=num_envs, batch_size=batch, num_threads=4, seed=9)
  got_env, want_env = _make(task_id, **kw), envpool_tpu.make_gymnasium(task_id, **kw)
  # [env, k, ...]: env e's k-th action
  table = uniform_actions(got_env.spec, rounds * batch, num_envs, seed=10)
  got = async_sequences(got_env, rounds, table)
  want = async_sequences(want_env, rounds, table)
  assert_sequences_equal(got_env.spec._state_keys, got, want, min_len=2)


# ------------------------------------------------------- the xla() bridge


@pytest.mark.parametrize("task_id", HOST_IDS)
def test_xla_bridge_matches_host_api(task_id):
  """``xla()``'s ``step`` on a CPU pool gives tensors equal to a twin
  pool's host-API outputs at the same seed and actions (the first send
  auto-resets every env, as the first host send does), and an output
  handed out is never written again."""
  kw = dict(num_envs=4, seed=11)
  env, twin = _make(task_id, **kw), _make(task_id, **kw)
  keys = env.spec._state_keys
  acts = uniform_actions(env.spec, 4, 25, seed=12)
  handle, recv, send, step = env.xla()
  assert handle[0] == 0
  for s, o in zip(env.spec._state_spec, handle[1]):
    assert o.shape == (4, *s.static_shape) and o.numpy().dtype == s.dtype
  got, want = [], []
  for act in acts:
    handle, out = step(handle, torch.from_numpy(act))
    assert all(isinstance(o, torch.Tensor) and o.device.type == "cpu" for o in out)
    got.append([o.numpy() for o in out])
    if len(got) == 1:
      first = [x.copy() for x in got[0]]
    twin.send(act)
    want.append(twin._recv())
  assert handle[0] == len(acts)
  assert_outputs_equal(keys, got, want, task_id)
  assert_outputs_equal(keys, [got[0]], [first], "first output kept")
  # a subset through send, then recv returns the same outputs
  subset = torch.tensor([2, 0], dtype=torch.int32)
  handle = send(handle, torch.from_numpy(acts[0][:2]), subset)
  handle, out = recv(handle)
  twin.send(acts[0][:2], np.asarray([2, 0], np.int32))
  assert_outputs_equal(keys, [[o.numpy() for o in out]], [twin._recv()], "subset")


def test_default_device_raises_without_a_card():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is valid")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    envpool_torch.make_gymnasium("InvertedPendulum-v4", num_envs=2)


def test_multi_player_refused():
  spec = envpool_torch.make_spec("InvertedPendulum-v4", num_envs=2,
                                 max_num_players=2)
  with pytest.raises(NotImplementedError, match="multi-player"):
    HostEnvPool(spec, "cpu")
