"""The port's mesh layer (``envpool_torch/parallel``) against the
unsharded port and the JAX package's ``ShardedEnvPool`` and sharded
trainer: the twin of ``tests/test_parallel.py``.

A mesh of the port lists logical shards of the CPU (``["cpu"] * 8``); the
JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``. The
contract: a sharded pool equals the unsharded pool bit for bit in every
output field (CartPole-v1, both Sokoban level modes with auto-resets, the
async and masked paths, snapshots, ``xla()``), the env axis is really
partitioned into blocks with their global env ids, and the sharded
trainer's iteration equals the unsharded one and the JAX package's to
``test_torch_ppo.py::test_one_iteration_matches_jax``'s tolerances, on the
env axis and on the model axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu
from envpool_torch.models import MLPActorCritic, SokobanCNN, params_from_flax
from envpool_torch.models.nets import forward_split
from envpool_torch.parallel import ShardedEnvPool, make_mesh
from envpool_torch.parallel import sharded as tsharded
from envpool_torch.parallel.dryrun import dryrun_multichip
from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init
from envpool_tpu.models import MLPActorCritic as JaxMLPActorCritic
from envpool_tpu.parallel import ShardedEnvPool as JaxShardedEnvPool
from envpool_tpu.parallel import make_mesh as jax_make_mesh
from envpool_tpu.train import ppo as jppo

from _torch_parity import assert_same

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _mesh(shape=(8,), names=("env",)):
  return tsharded.Mesh(np.array(["cpu"] * int(np.prod(shape)), object).reshape(shape),
                       names)


def _pair(task_id, n_shards=8, dialect=tsharded.ShardedGymnasiumEnvPool,
          maker=envpool_torch.make_gymnasium, **kw):
  """(unsharded, sharded) pools of one spec on the CPU."""
  spec = envpool_torch.make_spec(task_id, **kw)
  return (maker(task_id, device="cpu", **kw),
          dialect(spec, make_mesh(devices=["cpu"] * n_shards)))


def test_mesh_surface(monkeypatch):
  mesh = make_mesh(devices=CPU8)
  assert mesh.shape == {"env": 8} and mesh.axis_names == ("env",)
  assert mesh.devices.shape == (8,) and all(d == torch.device("cpu") for d in mesh.devices)
  assert make_mesh(n_devices=2, devices=CPU8).shape == {"env": 2}
  grid = _mesh((4, 2), ("env", "model"))
  assert grid.shape == {"env": 4, "model": 2} and grid.size == 8
  with pytest.raises(ValueError):
    tsharded.Mesh(["cpu"] * 4, ("env", "model"))
  # the card by default, never a CPU fallback
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA"):
    make_mesh()
  with pytest.raises(RuntimeError, match="CUDA"):
    ShardedEnvPool(envpool_torch.make_spec("CartPole-v1", num_envs=8))


def test_state_is_partitioned():
  spec = envpool_torch.make_spec("CartPole-v1", num_envs=64, seed=0)
  pool = ShardedEnvPool(spec, make_mesh(devices=CPU8))
  assert len(pool._state) == 8
  for s, (sh, st) in enumerate(zip(pool._shards, pool._state)):
    assert sh._env_ids.tolist() == list(range(8 * s, 8 * s + 8))
    assert st.elapsed.shape == (8,) and st.rng.shape == (8, 2)
    assert all(v.shape[0] == 8 for v in st.env.values())
  pool._reset(np.arange(64, dtype=np.int32))
  out = pool._recv()
  np.testing.assert_array_equal(out[spec._state_keys.index("info:env_id")], np.arange(64))
  # a 2-D mesh keeps one copy per env row
  pool = ShardedEnvPool(spec, _mesh((4, 2), ("env", "model")))
  assert [sh._env_ids[0].item() for sh in pool._shards] == [0, 16, 32, 48]


def test_num_envs_not_divisible_raises():
  with pytest.raises(ValueError):
    ShardedEnvPool(envpool_torch.make_spec("CartPole-v1", num_envs=63), make_mesh(devices=CPU8))
  # divisibility by the whole mesh, as the JAX pool checks it
  with pytest.raises(ValueError):
    ShardedEnvPool(envpool_torch.make_spec("CartPole-v1", num_envs=12),
                   _mesh((4, 2), ("env", "model")))


def test_cartpole_sharded_matches_unsharded_and_jax():
  """64 envs, 20 steps, the raw protocol of ``test_parallel.py``."""
  kw = dict(num_envs=64, seed=5)
  plain, sharded = _pair("CartPole-v1", **kw)
  jspec = envpool_tpu.make_spec("CartPole-v1", **kw)
  jpool = JaxShardedEnvPool(jspec, mesh=jax_make_mesh())
  ids = np.arange(64, dtype=np.int32)
  for pool in (plain, sharded, jpool):
    pool._reset(ids)
  outs = [[tuple(p._recv())] for p in (plain, sharded, jpool)]
  for t in range(20):
    act = np.tile(np.asarray([t % 2], np.int32), 64)
    for pool, o in zip((plain, sharded, jpool), outs):
      pool._send([ids, ids, act])
      o.append(tuple(pool._recv()))
  keys = sharded.spec._state_keys
  for t, (p, s, j) in enumerate(zip(*outs)):
    assert_same(s, p, f"step {t}")
    for k, got, want in zip(keys, p, j):
      want = np.asarray(want)
      if t == 0 or not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=f"{t}/{k}")
      else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"{t}/{k}")


@pytest.mark.parametrize("sequential", [False, True])
def test_sokoban_sharded_bit_exact(sequential):
  """16 envs over 4 shards, a cap of 5 steps so that auto-resets occur;
  sequential mode advances each env's level cursor by the global
  ``num_envs`` (``sokoban.py:219``), so the levels show a shard that
  held its block's size instead."""
  kw = dict(num_envs=16, seed=3, max_episode_steps=5, levels_dir="",
            n_levels_to_load=64, load_sequentially=sequential)
  plain, sharded = _pair("Sokoban-v0", n_shards=4, **kw)
  assert_same(sharded.reset(), plain.reset(), "reset")
  rng = np.random.default_rng(0)
  levels = set()
  for t in range(14):
    act = rng.integers(-1, 4, 16).astype(np.int32)
    got, want = sharded.step(act), plain.step(act)
    assert_same(got, want, f"step {t}")
    levels.update(want[4]["level_idx"].tolist())
  assert len(levels) > 16  # auto-resets loaded further levels
  assert_same(sharded.save_state(), plain.save_state(), "state")


def test_per_shard_host_read():
  """Shard 0 all done and shard 1 all live: shard 0 runs only the reset,
  shard 1 only the step, and the result is the unsharded one."""
  plain, sharded = _pair("CartPole-v1", n_shards=2, num_envs=8, seed=2)
  plain.reset()
  for _ in range(3):
    plain.step(np.ones(8, np.int32))
  snap = plain.save_state()
  snap = snap._replace(done=np.array([True] * 4 + [False] * 4))
  plain.load_state(snap)
  sharded.load_state(snap)
  got, want = sharded.step(np.zeros(8, np.int32)), plain.step(np.zeros(8, np.int32))
  assert_same(got, want)
  np.testing.assert_array_equal(want[4]["elapsed_step"], [0] * 4 + [4] * 4)
  assert_same(sharded.save_state(), plain.save_state())


def test_async_and_masked_routing():
  """Async cohorts (batch 4 of 16 over 4 shards) keep the unsharded ids,
  order and values; a masked sync send of ids across shards in shuffled
  order returns its rows in send order."""
  plain, sharded = _pair("CartPole-v1", n_shards=4, num_envs=16, batch_size=4, seed=1)
  plain.async_reset()
  sharded.async_reset()
  rng = np.random.default_rng(1)
  for _ in range(30):
    got, want = sharded.recv(), plain.recv()
    assert_same(got, want)
    act = rng.integers(0, 2, 4).astype(np.int32)
    plain.send(act, want[4]["env_id"])
    sharded.send(act, got[4]["env_id"])
  plain, sharded = _pair("CartPole-v1", n_shards=4, num_envs=16, seed=4)
  assert_same(sharded.reset(), plain.reset())
  for t in range(12):
    ids = rng.permutation(16)[:rng.integers(1, 16)].astype(np.int32)
    act = rng.integers(0, 2, len(ids)).astype(np.int32)
    got, want = sharded.step(act, ids), plain.step(act, ids)
    np.testing.assert_array_equal(got[4]["env_id"], ids)
    assert_same(got, want, f"step {t}")
  got, want = sharded.reset(np.array([13, 2, 7], np.int32)), plain.reset(np.array([13, 2, 7], np.int32))
  assert_same(got, want)
  assert_same(sharded.save_state(), plain.save_state())


@pytest.mark.parametrize("maker,dialect", [
  (envpool_torch.make_dm, tsharded.ShardedDMEnvPool),
  (envpool_torch.make_gym, tsharded.ShardedGymEnvPool),
  (envpool_torch.make_gymnasium, tsharded.ShardedGymnasiumEnvPool),
])
def test_dialects(maker, dialect):
  plain, sharded = _pair("CartPole-v1", n_shards=4, maker=maker, dialect=dialect,
                         num_envs=8, seed=6)
  assert type(sharded.reset()) is type(plain.reset())
  for t in range(5):
    act = np.full(8, t % 2, np.int32)
    got, want = sharded.step(act), plain.step(act)
    if maker is envpool_torch.make_dm:
      got, want = tuple(got), tuple(want)
    assert_same(got, want, f"step {t}")


def test_snapshots_cross_load():
  plain, sharded = _pair("CartPole-v1", n_shards=4, num_envs=16, seed=7)
  plain.reset()
  sharded.reset()
  for _ in range(4):
    act = np.arange(16, dtype=np.int32) % 2
    plain.step(act)
    sharded.step(act)
  snap_p, snap_s = plain.save_state(), sharded.save_state()
  assert_same(snap_s, snap_p)
  plain.load_state(snap_s)
  sharded.load_state(snap_p)
  for _ in range(3):
    act = np.ones(16, np.int32)
    assert_same(sharded.step(act), plain.step(act))


def test_xla_commit_and_rollout():
  """``rollout`` (CartPole, 16 envs, 10 steps) against the unsharded
  ``xla()`` loop; then ``commit`` and one host step."""
  spec = envpool_torch.make_spec("CartPole-v1", num_envs=16, seed=1)
  sharded = ShardedEnvPool(spec, make_mesh(devices=["cpu"] * 4))
  plain = envpool_torch.make_gymnasium("CartPole-v1", num_envs=16, seed=1, device="cpu")

  def policy(pstate, states):
    return pstate + 1, (torch.arange(16, dtype=torch.int32) + pstate) % 2

  (handle, n), traj = sharded.rollout(policy, 0, num_steps=10)
  rew = spec._state_keys.index("reward")
  assert n == 10 and traj[rew].shape == (10, 16)
  h, recv, send, _ = plain.xla()
  want = []
  for t in range(10):
    _, states = recv(h)
    want.append(states)
    h = send(h, (torch.arange(16, dtype=torch.int32) + t) % 2)
  for k, got, w in zip(spec._state_keys, traj, zip(*want)):
    assert torch.equal(got, torch.stack(w)), k
  for s, (a, b) in enumerate(zip(handle.pool, (h.pool,) * 4)):
    assert torch.equal(a.rng, b.rng[4 * s:4 * s + 4])
  sharded.commit(handle)
  plain.commit(h)
  act = np.zeros(16, np.int32)
  sharded._send([np.arange(16, dtype=np.int32)] * 2 + [act])
  plain._send([np.arange(16, dtype=np.int32)] * 2 + [act])
  assert_same(tuple(sharded._recv()), tuple(plain._recv()))


def test_forward_split_matches_forward():
  """The model axis's column-parallel forward: every weight in 2 and 3
  output blocks, against the whole net's forward in float32."""
  net = SokobanCNN(channels=(8, 6), dtype=torch.float32)
  obs = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (5, 3, 10, 10), np.uint8))
  net.init(obs, 1)
  params = dict(net.state_dict())
  want = net(obs)
  for m in (2, 3):
    cols = {k: list(v.tensor_split(m, 0)) for k, v in params.items() if v.ndim >= 2}
    got = forward_split(net, params, cols, obs)
    for g, w in zip(got, want):
      torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
  assert not hasattr(net.Conv_0, "__dict__") or "forward" not in net.Conv_0.__dict__


@pytest.fixture(scope="module")
def iteration():
  """One PPO iteration on CartPole-v1, 16 envs, a float32 (16, 16) MLP:
  the JAX trainer on its 8-device env mesh, and the port's initial state
  carried from it."""
  kw = dict(num_envs=16, seed=0)
  cfg_kw = dict(num_steps=4, update_epochs=1, num_minibatches=2)
  jspec = envpool_tpu.make_spec("CartPole-v1", **kw)
  jmesh = jax_make_mesh()
  jpool = JaxShardedEnvPool(jspec, mesh=jmesh)
  jnet = JaxMLPActorCritic(num_actions=2, hidden=(16, 16), dtype=jnp.float32)
  jcfg = jppo.PPOConfig(**cfg_kw)
  jstate, jtx = jppo.ppo_init(jpool, jnet, jcfg, seed=0)
  flax0 = jax.tree.map(np.asarray, jstate.params)
  jstate2, jm = jax.jit(jppo.make_ppo_train_step(jpool, jnet, jcfg, jtx, mesh=jmesh))(jstate)
  return dict(kw=kw, cfg=PPOConfig(**cfg_kw), flax0=flax0, key=np.asarray(jstate.key),
              params=jax.tree.map(np.asarray, jstate2.params),
              metrics={k: float(v) for k, v in jm.items()},
              out=[np.asarray(o) for o in jstate2.handle.out])


def _port_iteration(it, mesh=None, model_axis=None, rows=False):
  spec = envpool_torch.make_spec("CartPole-v1", **it["kw"])
  pool = (envpool_torch.make_gymnasium("CartPole-v1", device="cpu", **it["kw"])
          if mesh is None else ShardedEnvPool(spec, mesh))
  net = MLPActorCritic(num_actions=2, hidden=(16, 16), dtype=torch.float32)
  state, tx = ppo_init(pool, net, it["cfg"], seed=0)
  np.testing.assert_array_equal(state.key.numpy(), it["key"])
  state = state._replace(params=params_from_flax(net, it["flax0"]))
  step = make_ppo_train_step(pool, net, it["cfg"], tx, mesh=mesh, model_axis=model_axis)
  state2, m = step.per_row(state) if rows else step(state)
  return net, state2, {k: float(v) for k, v in m.items()}


def _close(net, got, want):
  """Metrics rtol 1e-4 and parameters atol 1e-5, as
  ``test_one_iteration_matches_jax`` holds the port to the JAX trainer."""
  _, state, metrics = got
  want_state, want_metrics = want
  assert set(metrics) == set(want_metrics)
  for k in want_metrics:
    np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=1e-4, atol=1e-6, err_msg=k)
  for k, v in want_state.items():
    np.testing.assert_allclose(state.params[k].numpy(), np.asarray(v), rtol=0, atol=1e-5,
                               err_msg=k)


@pytest.mark.parametrize("layout", ["env", "env_model", "env_rows", "env_model_rows"])
def test_trainer_matches_unsharded_and_jax(iteration, layout):
  """8 env shards, or a (4, 2) mesh with ``model_axis="model"``: one
  iteration against the unsharded port trainer and the JAX sharded one,
  through the trainer's call (on these logical shards of the CPU, the
  unsharded iteration) and, for ``*_rows``, through the per-row path that
  a mesh over several devices runs (``per_row``: each row's block on its
  device, the model axis's column blocks)."""
  if layout.startswith("env_model"):
    mesh, model_axis = _mesh((4, 2), ("env", "model")), "model"
  else:
    mesh, model_axis = make_mesh(devices=CPU8), None
  net, plain, plain_m = _port_iteration(iteration)
  got = _port_iteration(iteration, mesh, model_axis, rows=layout.endswith("_rows"))
  _close(net, got, (plain.params, plain_m))
  want = params_from_flax(net, iteration["params"])
  _close(net, got, (want, iteration["metrics"]))
  assert got[1].opt_state["count"] == 2
  for k, g, w in zip(envpool_torch.make_spec("CartPole-v1", num_envs=16)._state_keys,
                     got[1].handle.out, iteration["out"]):
    if g.dtype.is_floating_point:
      np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5, err_msg=k)
    else:
      np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


@pytest.mark.parametrize("n_devices", [8, 2])
def test_dryrun_multichip(n_devices):
  dryrun_multichip(n_devices, device="cpu")


# ------------------------------------------------- what the card captures


def test_sharded_rollout_reads_nothing_back():
  """``ShardedEnvPool.rollout`` (one ``graph.CapturedScan`` when the mesh
  is one card) under ``tests/test_torch_graph.py``'s host-read guard, on 4
  logical shards of the CPU: no host read, and the trajectory bit for bit
  against the unsharded ``xla()`` loop."""
  from test_torch_graph import HostReadGuard

  spec = envpool_torch.make_spec("CartPole-v1", num_envs=16, seed=1)
  sharded = ShardedEnvPool(spec, make_mesh(devices=["cpu"] * 4))
  plain = envpool_torch.make_gymnasium("CartPole-v1", num_envs=16, seed=1, device="cpu")
  obs = spec._state_keys.index("obs")

  def policy(t, states):
    return t + 1, (states[obs][:, 2] > 0).to(torch.int32)

  sharded.rollout(policy, torch.zeros((), dtype=torch.int64), 2)  # constants made once
  with HostReadGuard() as guard:
    (_, t), traj = sharded.rollout(policy, torch.zeros((), dtype=torch.int64), 8)
  assert guard.found == [], guard.found
  assert int(t) == 8
  h, recv, send, _ = plain.xla()
  (_, _), want = _unsharded_loop(recv, send, policy, h)
  for k, g, w in zip(spec._state_keys, traj, want):
    assert torch.equal(g, w), k


def _unsharded_loop(recv, send, policy, handle, steps=8):
  """The same rollout over an unsharded pool, step by step."""
  rows, t = [], torch.zeros((), dtype=torch.int64)
  for _ in range(steps):
    _, states = recv(handle)
    t, action = policy(t, states)
    handle = send(handle, action)
    rows.append(states)
  return (handle, t), [torch.stack(r) for r in zip(*rows)]


@pytest.mark.parametrize("model_axis", [None, "model"])
def test_sharded_trainer_reads_nothing_back(iteration, model_axis):
  """``ShardedPPOTrainStep``'s rollout and update on one device (what the
  card captures: the unsharded rollout step and update, the trajectory cut
  into rows) under the host-read guard, on the 8-shard env mesh and a (4, 2)
  env x model mesh of the CPU."""
  from test_torch_graph import HostReadGuard

  mesh = (make_mesh(devices=CPU8) if model_axis is None
          else _mesh((4, 2), ("env", "model")))
  spec = envpool_torch.make_spec("CartPole-v1", **iteration["kw"])
  pool = ShardedEnvPool(spec, mesh)
  net = MLPActorCritic(num_actions=2, hidden=(16, 16), dtype=torch.float32)
  state, tx = ppo_init(pool, net, iteration["cfg"], seed=0)
  step = make_ppo_train_step(pool, net, iteration["cfg"], tx, mesh=mesh,
                             model_axis=model_axis)
  assert step.one_device
  state, _ = step(state)  # constants and the bias table made once
  with HostReadGuard() as guard:
    rollout = step.rollout(state)
    new, metrics = step.update(state, rollout)
  assert guard.found == [], guard.found
  assert all(torch.isfinite(v) for v in metrics.values())
  assert new.opt_state["count"] == 4


def test_rows_update_matches_one_device_update(iteration):
  """The update of a mesh over several devices (``update_rows``: eager,
  each minibatch split by row) on the 8-shard CPU mesh, against the
  one-device update of the same rollout: the same sums in another
  grouping, within ``_close``'s tolerances."""
  spec = envpool_torch.make_spec("CartPole-v1", **iteration["kw"])
  net = MLPActorCritic(num_actions=2, hidden=(16, 16), dtype=torch.float32)
  runs = []
  for rows in (False, True):
    mesh = make_mesh(devices=CPU8)
    pool = ShardedEnvPool(spec, mesh)
    state, tx = ppo_init(pool, net, iteration["cfg"], seed=0)
    state = state._replace(params=params_from_flax(net, iteration["flax0"]))
    step = make_ppo_train_step(pool, net, iteration["cfg"], tx, mesh=mesh)
    assert step.one_device
    rollout = step.rollout(state)
    new, m = step.update_rows(state, rollout) if rows else step.update(state, rollout)
    runs.append((net, new, {k: float(v) for k, v in m.items()}))
  _close(net, runs[1], (runs[0][1].params, runs[0][2]))
  assert torch.equal(runs[0][1].key, runs[1][1].key)


def test_one_device_env_mesh_equals_unsharded():
  """On one device the rows share parameters and device, so the sharded
  trainer runs the policy and each minibatch whole (what the card
  captures): on the env axis two iterations equal the unsharded
  trainer's bit for bit."""
  cfg = PPOConfig(num_steps=4, update_epochs=1, num_minibatches=2)
  spec = envpool_torch.make_spec("CartPole-v1", num_envs=16, seed=0)
  runs = []
  for mesh in (None, make_mesh(devices=CPU8)):
    pool = (envpool_torch.make_gymnasium("CartPole-v1", num_envs=16, seed=0, device="cpu")
            if mesh is None else ShardedEnvPool(spec, mesh))
    net = MLPActorCritic(num_actions=2, hidden=(16, 16), dtype=torch.float32)
    state, tx = ppo_init(pool, net, cfg, seed=0)
    step = make_ppo_train_step(pool, net, cfg, tx, mesh=mesh)
    for _ in range(2):
      state, metrics = step(state)
    runs.append((state, metrics))
  (want, want_m), (got, got_m) = runs
  for k in want.params:
    assert torch.equal(got.params[k], want.params[k]), k
    assert torch.equal(got.opt_state["mu"][k], want.opt_state["mu"][k]), k
  assert torch.equal(got.key, want.key)
  assert {k: float(v) for k, v in got_m.items()} == {k: float(v) for k, v in want_m.items()}


def test_one_device_model_mesh_equals_unsharded():
  """On one device the model axis's blocks share the device, so the
  trainer runs each layer whole: on a (4, 2) env x model mesh two
  iterations equal the unsharded trainer's bit for bit, through the call
  and through ``eager``. ``one_device`` is derived from the mesh and cannot
  be set."""
  cfg = PPOConfig(num_steps=4, update_epochs=1, num_minibatches=2)
  spec = envpool_torch.make_spec("CartPole-v1", num_envs=16, seed=0)
  runs = {}
  for name in ("unsharded", "call", "eager"):
    mesh = None if name == "unsharded" else _mesh((4, 2), ("env", "model"))
    pool = (envpool_torch.make_gymnasium("CartPole-v1", num_envs=16, seed=0, device="cpu")
            if mesh is None else ShardedEnvPool(spec, mesh))
    net = MLPActorCritic(num_actions=2, hidden=(16, 16), dtype=torch.float32)
    state, tx = ppo_init(pool, net, cfg, seed=0)
    step = make_ppo_train_step(pool, net, cfg, tx, mesh=mesh,
                               model_axis=None if mesh is None else "model")
    if mesh is not None:
      assert step.one_device
      with pytest.raises(AttributeError):
        step.one_device = False
    run = step.eager if name == "eager" else step
    for _ in range(2):
      state, metrics = run(state)
    runs[name] = (net, state, {k: float(v) for k, v in metrics.items()})
  _, want, want_m = runs["unsharded"]
  for name in ("call", "eager"):
    _, got, got_m = runs[name]
    for k in want.params:
      assert torch.equal(got.params[k], want.params[k]), (name, k)
      assert torch.equal(got.opt_state["nu"][k], want.opt_state["nu"][k]), (name, k)
    assert torch.equal(got.key, want.key) and got_m == want_m, name
