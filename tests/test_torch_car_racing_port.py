"""The port's pool engine and CarRacing-v2 on their own (CPU): twins of
``tests/test_car_racing.py`` and the engine paths the parity tests do not
drive (masked steps, async cohorts, dm dialect, snapshots, the functional
interface)."""

import numpy as np
import pytest
import torch

import envpool_torch
from envpool_torch.envs.box2d.car_track import PALETTE, generate_track

# the suite runs in several worker processes that share the cores: one
# intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)


def _make(num_envs=2, **kw):
  kw.setdefault("device", "cpu")
  return envpool_torch.make_gymnasium(
    "CarRacing-v2", num_envs=num_envs, seed=0, n_tracks=2, **kw
  )


def _acts(n, seed=0):
  rng = np.random.default_rng(seed)
  return np.stack([
    rng.uniform(-1, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n)
  ], 1).astype(np.float32)


GAS = np.asarray([[0, 1, 0]], np.float32)
BRAKE = np.asarray([[0, 0, 1]], np.float32)


# ---------------------------------------------------------- test_car_racing twins


def test_track_generation() -> None:
  t = generate_track(np.random.default_rng(3))
  assert 200 < t.n_tiles < 460
  assert np.isin(t.bitmap, [2, 3, 4]).mean() > 0.01


def test_reset_obs() -> None:
  obs, info = _make().reset()
  assert obs.shape == (2, 96, 96, 3) and obs.dtype == np.uint8
  flat = obs[0].reshape(-1, 3)
  assert (flat == PALETTE[2]).all(-1).any() or (flat == PALETTE[3]).all(-1).any()
  assert np.all(obs[:, 95, :48] == 0)


def test_gas_collects_tiles_and_reward() -> None:
  env = _make()
  env.reset()
  total = np.zeros(2)
  for _ in range(80):
    obs, rew, term, trunc, info = env.step(np.tile(GAS, (2, 1)))
    total += rew
  assert np.all(info["tile_visited_count"] >= 3)
  assert np.all(total > 0)


def test_brake_stops_progress() -> None:
  counts = []
  for action in (GAS, BRAKE):
    env = _make()
    env.reset()
    for _ in range(40):
      *_, info = env.step(np.tile(action, (2, 1)))
    counts.append(info["tile_visited_count"])
  assert np.all(counts[0] > counts[1])


def test_determinism() -> None:
  def run(seed):
    env = envpool_torch.make_gymnasium(
      "CarRacing-v2", num_envs=2, seed=seed, n_tracks=2, device="cpu"
    )
    acc = [env.reset()[0]]
    for _ in range(10):
      acc.append(env.step(np.tile(np.asarray([[0.2, 0.5, 0]], np.float32), (2, 1)))[0])
    return np.stack(acc)

  np.testing.assert_array_equal(run(7), run(7))


# -------------------------------------------------------------------- engine


def test_default_device_is_cuda() -> None:
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default pool is valid")
  with pytest.raises(RuntimeError, match="CUDA"):
    envpool_torch.make_gymnasium("CarRacing-v2", num_envs=1, n_tracks=1)


def test_unported_features_raise() -> None:
  # the pool has every feature of the JAX package's now: a single-player
  # family refuses max_num_players > 1 with the JAX package's ValueError
  with pytest.raises(ValueError, match="max_num_players"):
    _make(max_num_players=2)


def test_masked_step_matches_full_step() -> None:
  full, part = _make(4), _make(4)
  full.reset()
  part.reset()
  acts = _acts(4)
  want = full.step(acts)
  ids = np.asarray([3, 1], np.int32)
  got = part.step(acts[ids], ids)
  np.testing.assert_array_equal(got[-1]["env_id"], ids)
  np.testing.assert_array_equal(got[0], want[0][ids])
  np.testing.assert_array_equal(got[1], want[1][ids])
  np.testing.assert_array_equal(got[-1]["elapsed_step"], [1, 1])
  # the other lanes did not move: their next step is their first
  rest = part.step(acts[[0, 2]], np.asarray([0, 2], np.int32))
  np.testing.assert_array_equal(rest[0], want[0][[0, 2]])
  # a masked reset restarts only its lanes
  obs, info = part.reset(np.asarray([1], np.int32))
  np.testing.assert_array_equal(info["elapsed_step"], [0])
  np.testing.assert_array_equal(part.save_state().elapsed, [1, 0, 1, 1])


def test_async_recv_order() -> None:
  env = _make(4, batch_size=2)
  assert env.is_async
  env.async_reset()
  order = []
  for _ in range(6):
    obs, rew, term, trunc, info = env.recv()
    assert obs.shape == (2, 96, 96, 3)
    order.append(info["env_id"].tolist())
    env.send(np.tile(GAS, (2, 1)), info["env_id"])
  # cohorts come back first in, first out: the reset's, then each send's
  assert order == [[0, 1], [2, 3]] * 3
  elapsed = env.save_state().elapsed
  np.testing.assert_array_equal(elapsed, [3, 3, 3, 3])


def test_dm_dialect() -> None:
  pytest.importorskip("dm_env")
  env = envpool_torch.make_dm(
    "CarRacing-v2", num_envs=2, seed=0, n_tracks=2, device="cpu"
  )
  ts = env.reset()
  np.testing.assert_array_equal(ts.step_type, [0, 0])
  ts = env.step(np.tile(GAS, (2, 1)))
  np.testing.assert_array_equal(ts.step_type, [1, 1])
  assert ts.observation.obs.shape == (2, 96, 96, 3)
  np.testing.assert_array_equal(ts.observation.env_id, [0, 1])
  np.testing.assert_array_equal(ts.discount, [1.0, 1.0])


def test_save_load_round_trip() -> None:
  env = _make()
  env.reset()
  env.step(np.tile(GAS, (2, 1)))
  snap = env.save_state()
  assert snap.rng.dtype == np.uint32
  first = [env.step(_acts(2, s)) for s in range(3)]
  env.load_state(snap)
  again = [env.step(_acts(2, s)) for s in range(3)]
  for a, b in zip(first, again):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
  # checkpointers may hand the namedtuple back as a dict
  env.load_state(dict(snap._asdict()))
  np.testing.assert_array_equal(env.step(_acts(2, 0))[0], first[0][0])


def test_functional_interface_and_commit() -> None:
  host, func = _make(), _make()
  host.reset()
  func.reset()
  handle, recv, send, step = func.xla()
  acts = [_acts(2, s) for s in range(4)]
  for a in acts[:3]:
    want = host.step(a)
    handle, out = step(handle, torch.from_numpy(a))
    keys = func.spec._state_keys
    np.testing.assert_array_equal(out[keys.index("obs")].numpy(), want[0])
    np.testing.assert_array_equal(out[keys.index("reward")].numpy(), want[1])
  # the handle is a snapshot: the host pool has not moved
  np.testing.assert_array_equal(func.save_state().elapsed, [0, 0])
  func.commit(handle)
  np.testing.assert_array_equal(func.step(acts[3])[0], host.step(acts[3])[0])
