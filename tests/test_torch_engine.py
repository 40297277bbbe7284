"""The port's pool engine on CartPole-v1 and Dummy-v0 (CPU): twins of
``tests/test_engine.py``, ``test_multiplayer.py`` and ``test_container.py``;
CartPole-v1 step for step against ``envpool_tpu``; ``prng.uniform``
against ``jax.random.uniform``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu
from envpool_torch.core import prng
from envpool_torch.core.spec import ArraySpec, ContainerSpec

# the suite runs in several worker processes that share the cores: one
# intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)


def _gymnasium(task_id, **kw):
  return envpool_torch.make_gymnasium(task_id, device="cpu", **kw)


# --------------------------------------------------------- test_engine twins


def test_auto_reset_and_truncation() -> None:
  """A done env's next step is FIRST with elapsed 0 / reward 0."""
  num_envs = 4
  max_steps = 10
  env = _gymnasium(
    "CartPole-v1", num_envs=num_envs, seed=0, max_episode_steps=max_steps
  )
  env.reset()
  seen_done = False
  prev_done = np.zeros(num_envs, np.bool_)
  rng = np.random.default_rng(0)
  for _ in range(3 * max_steps):
    obs, rew, term, trunc, info = env.step(
      rng.integers(0, 2, num_envs).astype(np.int32)
    )
    done = term | trunc
    if prev_done.any():
      seen_done = True
      np.testing.assert_array_equal(info["elapsed_step"][prev_done], 0)
      np.testing.assert_array_equal(rew[prev_done], 0.0)
      np.testing.assert_array_equal(done[prev_done], False)
    assert (info["elapsed_step"] <= max_steps).all()
    at_cap = info["elapsed_step"] == max_steps
    np.testing.assert_array_equal(trunc[at_cap], True)
    prev_done = done
  assert seen_done


def test_dm_step_type_cycle() -> None:
  env = envpool_torch.make_dm(
    "CartPole-v1", num_envs=2, seed=0, max_episode_steps=3, device="cpu"
  )
  ts = env.reset()
  np.testing.assert_array_equal(ts.step_type, 0)
  types = []
  for _ in range(4):
    ts = env.step(np.zeros(2, np.int32))
    types.append(np.asarray(ts.step_type).copy())
  # elapsed: 1(MID) 2(MID) 3(LAST,cap) 0(FIRST after auto-reset)
  np.testing.assert_array_equal(types[0], 1)
  np.testing.assert_array_equal(types[1], 1)
  np.testing.assert_array_equal(types[2], 2)
  np.testing.assert_array_equal(types[3], 0)
  ts = env.step(np.zeros(2, np.int32))
  np.testing.assert_array_equal(ts.step_type, 1)
  np.testing.assert_array_equal(np.asarray(ts.discount), 1.0)


def test_partial_batch_sync() -> None:
  """Sending a subset of env_id steps only those envs."""
  num_envs = 8
  env = _gymnasium("CartPole-v1", num_envs=num_envs, seed=0)
  env.reset()
  env.step(np.zeros(num_envs, np.int32))
  sub = np.array([1, 3, 5], np.int32)
  obs, rew, term, trunc, info = env.step(np.zeros(3, np.int32), env_id=sub)
  assert obs.shape == (3, 4)
  np.testing.assert_array_equal(info["env_id"], sub)
  np.testing.assert_array_equal(info["elapsed_step"], 2)
  rest = np.array([0, 2, 4, 6, 7], np.int32)
  obs, rew, term, trunc, info = env.step(np.zeros(5, np.int32), env_id=rest)
  np.testing.assert_array_equal(info["env_id"], rest)
  np.testing.assert_array_equal(info["elapsed_step"], 2)


def test_async_cohorts() -> None:
  """async mode: recv cohorts, send exactly those env_ids back."""
  num_envs = 8
  batch = 4
  env = _gymnasium("CartPole-v1", num_envs=num_envs, batch_size=batch, seed=0)
  assert env.is_async
  env.async_reset()
  stepped = {i: 0 for i in range(num_envs)}
  for _ in range(20):
    obs, rew, term, trunc, info = env.recv()
    env_id = info["env_id"]
    assert len(env_id) == batch
    for i in env_id:
      stepped[int(i)] += 1
    env.send(np.zeros(batch, np.int32), env_id=env_id)
  counts = np.array(list(stepped.values()))
  assert counts.sum() == 20 * batch
  assert counts.max() - counts.min() <= 1


def test_interleaved_env_id_sets() -> None:
  num_envs = 6
  env = _gymnasium("CartPole-v1", num_envs=num_envs, seed=0)
  env.reset()
  a = np.array([0, 1, 2], np.int32)
  b = np.array([3, 4, 5], np.int32)
  env.send(np.zeros(3, np.int32), env_id=a)
  env.send(np.ones(3, np.int32), env_id=b)
  _, _, _, _, info1 = env.recv()
  _, _, _, _, info2 = env.recv()
  np.testing.assert_array_equal(info1["env_id"], a)
  np.testing.assert_array_equal(info2["env_id"], b)


def test_xla_jit_loop() -> None:
  """A rollout through the functional ``xla()`` interface equals the same
  rollout through the host API, bit for bit (the JAX twin jits the loop;
  here the steps run one by one, as ``graph.scan`` runs them on the CPU; on
  the card it captures them as a CUDA graph, tests/test_torch_graph.py and
  chip_smoke.py phase 18)."""
  num_envs = 5
  env = _gymnasium("CartPole-v1", num_envs=num_envs, seed=7)
  env.reset()
  handle, recv, send, step = env.xla()
  for _ in range(100):
    handle, states = recv(handle)
    handle = send(handle, torch.zeros(num_envs, dtype=torch.int32))
  _, states = recv(handle)
  obs_xla = states[env.spec._state_keys.index("obs")].numpy()
  env2 = _gymnasium("CartPole-v1", num_envs=num_envs, seed=7)
  env2.reset()
  for _ in range(100):
    obs_eager, *_ = env2.step(np.zeros(num_envs, np.int32))
  np.testing.assert_array_equal(obs_xla, obs_eager)


def test_xla_commit_folds_rollout_into_host_pool() -> None:
  num_envs = 4
  env = _gymnasium("CartPole-v1", num_envs=num_envs, seed=3)
  env.reset()
  handle, recv, send, step = env.xla()
  for _ in range(10):
    handle = send(handle, torch.zeros(num_envs, dtype=torch.int32))
  env.commit(handle)
  obs_a, *_ = env.step(np.zeros(num_envs, np.int32))
  env2 = _gymnasium("CartPole-v1", num_envs=num_envs, seed=3)
  env2.reset()
  for _ in range(10):
    env2.step(np.zeros(num_envs, np.int32))
  obs_b, *_ = env2.step(np.zeros(num_envs, np.int32))
  np.testing.assert_array_equal(obs_a, obs_b)


def test_checkpoint_restore() -> None:
  env = _gymnasium("CartPole-v1", num_envs=4, seed=0)
  env.reset()
  for _ in range(5):
    env.step(np.zeros(4, np.int32))
  snap = env.save_state()
  obs_a, *_ = env.step(np.zeros(4, np.int32))
  env.load_state(snap)
  obs_b, *_ = env.step(np.zeros(4, np.int32))
  np.testing.assert_array_equal(obs_a, obs_b)


# ---------------------------------------------------- test_multiplayer twins


def _multi(num_envs=4, max_players=3, **kw):
  return _gymnasium(
    "Dummy-v0", num_envs=num_envs, max_num_players=max_players,
    **dict(dict(state_num=5), **kw),
  )


def test_player_counts_and_compaction() -> None:
  env = _multi()
  # env e has (e % 3) + 1 live players: 1, 2, 3, 1 -> 7 rows total
  env._reset(np.arange(4, dtype=np.int32))
  out = dict(zip(env.spec._state_keys, env._recv()))
  np.testing.assert_array_equal(
    out["info:players.env_id"], [0, 1, 1, 2, 2, 2, 3]
  )
  assert out["reward"].shape == (7,)
  np.testing.assert_array_equal(out["reward"], 0.0)
  assert out["done"].shape == (4,)
  np.testing.assert_array_equal(out["info:players.id"].ravel()[:3], [0, 0, 1])


def test_per_player_actions_and_rewards() -> None:
  env = _multi()
  env._reset(np.arange(4, dtype=np.int32))
  env._recv()
  players_env_id = np.asarray([0, 1, 1, 2, 2, 2, 3], np.int32)
  action_rows = np.asarray([5, 1, 2, 3, 4, 5, 2], np.int32)
  env._send([np.arange(4, dtype=np.int32), players_env_id, action_rows])
  out = dict(zip(env.spec._state_keys, env._recv()))
  # rewards echo each player's action, in the same row order
  np.testing.assert_array_equal(out["reward"], action_rows.astype(np.float32))
  np.testing.assert_array_equal(out["info:players.env_id"], players_env_id)
  np.testing.assert_array_equal(out["discount"], 1.0)


def test_multiplayer_guards() -> None:
  env = _multi()
  with pytest.raises(RuntimeError):
    env.xla()  # same gate as the reference (py_envpool.h:220-238)
  with pytest.raises(ValueError):
    _gymnasium("CartPole-v1", num_envs=2, max_num_players=2)


def test_async_multiplayer_cohorts() -> None:
  env = _multi(batch_size=2, state_num=50)
  env.async_reset()
  seen = set()
  for _ in range(2):
    out = dict(zip(env.spec._state_keys, env._recv()))
    cohort = np.asarray(out["info:env_id"])
    assert cohort.shape == (2,)
    seen.update(int(e) for e in cohort)
    expect_players = np.concatenate(
      [np.full(int(e) % 3 + 1, e, np.int32) for e in cohort]
    )
    np.testing.assert_array_equal(out["info:players.env_id"], expect_players)
  assert seen == {0, 1, 2, 3}
  # step cohort {1, 3}: rewards echo each player's action rows
  players_env_id = np.asarray([1, 1, 3], np.int32)  # env1: 2p, env3: 1p
  action_rows = np.asarray([7, 8, 9], np.int32)
  env._send([np.asarray([1, 3], np.int32), players_env_id, action_rows])
  out = dict(zip(env.spec._state_keys, env._recv()))
  np.testing.assert_array_equal(out["info:env_id"], [1, 3])
  np.testing.assert_array_equal(out["info:players.env_id"], players_env_id)
  np.testing.assert_array_equal(out["reward"], action_rows.astype(np.float32))
  np.testing.assert_array_equal(out["elapsed_step"], [1, 1])


def test_async_multiplayer_interleaved_progress() -> None:
  env = _multi(max_players=2, batch_size=2, state_num=50)
  env.async_reset()
  elapsed = {e: 0 for e in range(4)}
  for _ in range(8):
    out = dict(zip(env.spec._state_keys, env._recv()))
    cohort = np.asarray(out["info:env_id"])
    for pos, e in enumerate(cohort):
      assert int(out["elapsed_step"][pos]) == elapsed[int(e)]
      elapsed[int(e)] += 1
    rows = np.concatenate(
      [np.full(int(e) % 2 + 1, int(e) + 1, np.int32) for e in cohort]
    )
    env._send([
      cohort.astype(np.int32),
      np.asarray(out["info:players.env_id"], np.int32),
      rows,
    ])
  assert sum(elapsed.values()) == 16


# ------------------------------------------------------ test_container twins


def test_container_spec_surface() -> None:
  spec = envpool_torch.make_spec("Dummy-v0", num_envs=4, container_obs=True)
  cs = spec.state_array_spec["obs:dyn"]
  assert isinstance(cs, ContainerSpec)
  assert cs.inner.shape == (-1, 10)
  assert cs.max_shape == (4, 10)
  assert cs.dtype == np.int32
  with pytest.raises(ValueError):
    ContainerSpec(ArraySpec(np.int32, (-1,)), max_shape=(3, 4))


def test_container_ragged_round_trip() -> None:
  env = _gymnasium("Dummy-v0", num_envs=6, container_obs=True)
  env._reset(np.arange(6, dtype=np.int32))
  out = dict(zip(env.spec._state_keys, env._recv()))
  dyn = out["obs:dyn"]
  assert dyn.dtype == object
  for e in range(6):
    assert dyn[e].shape == (e % 4 + 1, 10)
    np.testing.assert_array_equal(dyn[e], e)
  assert out["obs:raw"].shape == (6, 2)


def test_container_through_dialect_step() -> None:
  env = _gymnasium("Dummy-v0", num_envs=3, container_obs=True)
  env.reset()
  obs, rew, term, trunc, info = env.step(np.zeros(3, np.int32))
  assert obs["dyn"].dtype == object
  assert obs["dyn"][2].shape == (3, 10)


def test_container_async_cohorts() -> None:
  env = _gymnasium(
    "Dummy-v0", num_envs=6, batch_size=3, container_obs=True, state_num=50
  )
  env.async_reset()
  seen = {}
  for _ in range(4):
    out = dict(zip(env.spec._state_keys, env._recv()))
    ids = np.asarray(out["info:env_id"])
    for pos, e in enumerate(ids):
      assert out["obs:dyn"][pos].shape == (int(e) % 4 + 1, 50)
      np.testing.assert_array_equal(out["obs:dyn"][pos], int(e))
      seen[int(e)] = seen.get(int(e), 0) + 1
    env._send([ids.astype(np.int32), ids.astype(np.int32),
               np.zeros(3, np.int32)])
  assert len(seen) == 6


def test_container_gates() -> None:
  env = _gymnasium("Dummy-v0", num_envs=2, container_obs=True)
  with pytest.raises(RuntimeError):
    env.xla()
  # multiplayer + container stays a documented static-shape gate
  with pytest.raises(NotImplementedError):
    _gymnasium("Dummy-v0", num_envs=2, max_num_players=3, container_obs=True)


# ------------------------------------------------- against the JAX package


def test_cartpole_step_for_step_parity() -> None:
  """CartPole-v1, 8 envs, 200 steps with auto-resets: integer and bool
  fields and rewards exact, observations to 1e-5 absolute (float32 state
  below 5 in magnitude; XLA contracts multiply-adds and its trig may differ
  by an ulp, and the pole's instability grows that over an episode)."""
  kw = dict(num_envs=8, seed=1, max_episode_steps=40)
  want_env = envpool_tpu.make_gymnasium("CartPole-v1", **kw)
  got_env = _gymnasium("CartPole-v1", **kw)
  w, g = want_env.reset(), got_env.reset()
  np.testing.assert_array_equal(g[0], w[0])  # uniform() is bit-exact
  rng = np.random.default_rng(0)
  resets = 0
  for _ in range(200):
    act = rng.integers(0, 2, 8).astype(np.int32)
    w, g = want_env.step(act), got_env.step(act)
    np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-5)
    for i in (1, 2, 3):
      np.testing.assert_array_equal(g[i], w[i])
    for k in ("env_id", "elapsed_step"):
      np.testing.assert_array_equal(g[4][k], w[4][k])
    resets += int((g[4]["elapsed_step"] == 0).sum())
  assert resets >= 8


@pytest.mark.parametrize("lo,hi", [(-0.05, 0.05), (0.0, 1.0), (-3.0, 0.5)])
def test_uniform_matches_jax_bit_for_bit(lo, hi) -> None:
  """float32 ``uniform`` equals ``jax.random.uniform`` bit for bit (the
  port rounds the fused scale-and-shift once, as XLA's FMA does)."""
  n = 512
  keys = prng.fold_in(prng.prng_key(3).expand(n, 2), torch.arange(n))
  jk = jnp.asarray(keys.numpy().astype(np.uint32))
  want = np.asarray(
    jax.vmap(lambda k: jax.random.uniform(k, (4,), jnp.float32, lo, hi))(jk)
  )
  got = prng.uniform(keys, (4,), lo, hi).numpy()
  assert got.dtype == np.float32 and got.shape == (n, 4)
  np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ------------------------------------------ pool faults held to the reference


def test_commit_refuses_multiplayer() -> None:
  """``commit()`` has the JAX package's multi-player gate."""
  kw = dict(num_envs=2, max_num_players=3)
  want = envpool_tpu.make_gymnasium("Dummy-v0", **kw)
  got = _gymnasium("Dummy-v0", **kw)
  for env in (want, got):
    with pytest.raises(RuntimeError, match="commit\\(\\) does not support multi-player"):
      env.commit(None)


class _JaxCountdown(envpool_tpu.core.env.FuncEnv):
  """An env-side auto-reset family that reports no ``elapsed_step``: each
  step takes 1 + action from a budget of 3 and, at 0, ends the episode and
  restarts it within the step."""

  name = "Countdown"
  env_resets = True

  @staticmethod
  def state_spec(cfg):
    return {"obs": envpool_tpu.core.spec.ArraySpec(np.int32, ())}

  @staticmethod
  def action_spec(cfg):
    return {"action": envpool_tpu.core.spec.ArraySpec(np.int32, (-1,), 0, 1)}

  @staticmethod
  def reset(cfg, state, key):
    left = jnp.int32(3)
    return {"left": left}, left, {}

  @staticmethod
  def step(cfg, state, action, key):
    left = state["left"] - 1 - action
    done = left <= 0
    left = jnp.where(done, 3, left)
    return {"left": left}, left, action.astype(jnp.float32), done, jnp.bool_(False), {}


class _TorchCountdown(envpool_torch.core.env.FuncEnv):
  """The port's twin of ``_JaxCountdown``, batched."""

  name = "Countdown"
  env_resets = True
  state_spec = _JaxCountdown.state_spec

  @staticmethod
  def action_spec(cfg):
    return {"action": ArraySpec(np.int32, (-1,), 0, 1)}

  @staticmethod
  def reset(cfg, state, keys):
    left = torch.full((keys.shape[0],), 3, dtype=torch.int32)
    return {"left": left}, left, {}

  @staticmethod
  def step(cfg, state, action, keys):
    left = state["left"] - 1 - action
    done = left <= 0
    left = torch.where(done, 3, left).to(torch.int32)
    return ({"left": left}, left, action.to(torch.float32), done,
            torch.zeros_like(done), {})


def test_env_resets_family_without_elapsed_step() -> None:
  """The ``env_resets`` branch counts ``ps.elapsed + 1`` when the family
  reports no ``elapsed_step``, as the JAX pool does: every output of 8
  steps equal."""
  from envpool_torch.core.envpool_api import py_env as torch_py_env
  from envpool_tpu.core.envpool_api import py_env as jax_py_env

  pools = []
  for py_env, cls, extra in ((jax_py_env, _JaxCountdown, ()),
                             (torch_py_env, _TorchCountdown, ("cpu",))):
    spec_cls, _, _, gymnasium_cls = py_env(cls)
    pools.append(gymnasium_cls(spec_cls(spec_cls.gen_config(num_envs=4, seed=0)), *extra))
  want, got = pools
  w, g = want.reset(), got.reset()
  np.testing.assert_array_equal(g[0], w[0])
  rng = np.random.default_rng(0)
  for _ in range(8):
    act = rng.integers(0, 2, 4).astype(np.int32)
    w, g = want.step(act), got.step(act)
    for i in range(4):
      np.testing.assert_array_equal(g[i], w[i])
    for k in ("env_id", "elapsed_step"):
      np.testing.assert_array_equal(g[4][k], w[4][k], err_msg=k)
  assert w[4]["elapsed_step"].tolist() == [8] * 4
