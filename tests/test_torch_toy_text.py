"""The port's toy text family (CPU): every registered id against
``envpool_tpu`` from the same seed and actions over 200 steps with
auto-resets, every output field bit for bit; Blackjack's bounded dealer
loop (its bound by exhaustive search, its draws against the JAX package's
``while_loop``, no host read); twins of ``tests/test_toy_text.py`` and
``tests/test_align_toy_text.py``."""

import gymnasium
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu
from _torch_parity import assert_same, assert_same_config, jax_rollout, port_rollout
from envpool_torch.envs import toy_text
from envpool_torch.envs.toy_text import blackjack
from envpool_tpu.envs.toy_text import BlackjackEnv as JaxBlackjackEnv

torch.set_num_threads(1)

# (task id, action count, kwargs); the caps of Taxi, NChain and CliffWalking
# are cut so that every lane auto-resets within the run
TASKS = [
  ("Catch-v0", 3, {}),
  ("FrozenLake-v1", 4, {}),
  ("FrozenLake8x8-v1", 4, {}),
  ("Taxi-v3", 6, dict(max_episode_steps=30)),
  ("NChain-v0", 2, dict(max_episode_steps=30)),
  ("CliffWalking-v0", 4, dict(max_episode_steps=30)),
  ("Blackjack-v1", 2, {}),
]


def _port(task_id, **kw):
  return envpool_torch.make_gymnasium(task_id, device="cpu", **kw)


@pytest.mark.parametrize("task_id,n_act,kw", TASKS)
def test_parity_with_jax_package(task_id, n_act, kw):
  kw = dict(num_envs=16, seed=3, **kw)
  assert_same_config(task_id, kw)
  acts = np.random.default_rng(0).integers(0, n_act, (200, 16)).astype(np.int32)
  keys, got, g_st = port_rollout(task_id, kw, acts)
  want_keys, want, w_st = jax_rollout(task_id, kw, acts)
  assert keys == want_keys
  for t, (g, w) in enumerate(zip(got, want)):
    assert_same(g, w, f"step {t}")
  assert_same(g_st.env, w_st.env, "state")
  np.testing.assert_array_equal(g_st.rng, w_st.rng)
  elapsed = np.stack([g[keys.index("elapsed_step")] for g in got[1:]])
  assert (elapsed == 0).any(0).all()   # every lane auto-reset


def test_ids_in_jax_package_order():
  ids = envpool_torch.list_all_envs()
  assert [t for t, _, _ in TASKS] == [t for t in ids if t in {x[0] for x in TASKS}]
  assert ids == [t for t in envpool_tpu.list_all_envs() if t in set(ids)]


@pytest.mark.parametrize("task_id,n_act,kw", TASKS)
def test_every_dialect_steps(task_id, n_act, kw):
  for make in (envpool_torch.make_gym, envpool_torch.make_dm):
    env = make(task_id, num_envs=2, seed=0, device="cpu")
    env.reset()
    out = env.step(np.ones(2, np.int32))
    assert out is not None


# ------------------------------------------------------------ Blackjack


def test_dealer_draw_bound_is_exhaustive():
  """The most cards a dealer draws before standing, over every opening
  pair and every card sequence (cards 1..10, an ace counts 11 while the
  total stays at or below 21), is the loop's bound."""
  memo = {}

  def longest(raw, ace):
    if (raw, ace) not in memo:
      total = raw + 10 if ace and raw + 10 <= 21 else raw
      memo[raw, ace] = 0 if total >= 17 else 1 + max(
        longest(raw + c, ace or c == 1) for c in range(1, 11)
      )
    return memo[raw, ace]

  most = max(
    longest(a + b, a == 1 or b == 1) for a in range(1, 11) for b in range(1, 11)
  )
  assert most == blackjack.MAX_DEALER_DRAWS


def test_dealer_draws_match_while_loop():
  """Stick on every opening dealer hand, 16 lanes each with their own
  keys: the bounded, masked loop gives the JAX package's ``while_loop``
  result lane for lane."""
  cards = np.arange(1, 11)
  d1, d2 = (np.repeat(x.ravel(), 16) for x in np.meshgrid(cards, cards))
  n = len(d1)
  state = {
    "p_raw": np.full(n, 15, np.int32), "p_ace": np.zeros(n, bool),
    "p_nat": np.zeros(n, bool), "d_raw": (d1 + d2).astype(np.int32),
    "d_ace": (d1 == 1) | (d2 == 1), "d_nat": np.zeros(n, bool),
    "d_first": d1.astype(np.int32),
  }
  keys = np.asarray(jax.random.split(jax.random.PRNGKey(5), n))
  cfg = envpool_tpu.make_spec("Blackjack-v1").config
  want = jax.jit(jax.vmap(
    lambda s, k: JaxBlackjackEnv.step(cfg, s, jnp.int32(0), k)[:3]
  ))({k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(keys))
  got = blackjack.BlackjackEnv.step(
    cfg, {k: torch.from_numpy(v) for k, v in state.items()},
    torch.zeros(n, dtype=torch.int32), torch.from_numpy(keys.astype(np.int64)),
  )[:3]
  assert_same(tuple(
    {k: v.numpy() for k, v in x.items()} if isinstance(x, dict) else x.numpy()
    for x in got
  ), want)
  assert int(got[0]["d_raw"].max()) > 21   # some dealers bust


@pytest.mark.parametrize("env_cls", [
  toy_text.BlackjackEnv, toy_text.CatchEnv, toy_text.CliffWalkingEnv,
  toy_text.FrozenLakeEnv, toy_text.NChainEnv, toy_text.TaxiEnv,
])
def test_steps_without_reading_the_device(env_cls):
  """reset and step on the meta device, where a tensor has no data: any
  read of a value on the host (``item``, ``bool``, ``tolist``) raises."""
  spec = envpool_torch.make_spec(
    {"Blackjack": "Blackjack-v1", "Catch": "Catch-v0",
     "CliffWalking": "CliffWalking-v0", "FrozenLake": "FrozenLake8x8-v1",
     "NChain": "NChain-v0", "Taxi": "Taxi-v3"}[env_cls.name]
  )
  keys = torch.zeros(8, 2, dtype=torch.int64, device="meta")
  state, obs, _ = env_cls.reset(spec.config, None, keys)
  out = env_cls.step(spec.config, state, torch.zeros(8, dtype=torch.int32, device="meta"), keys)
  assert out[2].shape == (8,) and out[3].shape == (8,) and out[2].device.type == "meta"


# ------------------------------------------------- twins of test_toy_text.py


def test_catch_board_and_episode():
  h, w, n = 10, 5, 8
  env = _port("Catch-v0", num_envs=n, seed=0)
  obs, _ = env.reset()
  assert obs.shape == (n, h, w)
  assert (obs[:, 0, :].sum(-1) == 1).all()
  assert (obs[:, h - 1, w // 2] == 1).all()
  rewards = []
  for _ in range(h - 1):
    obs, rew, term, trunc, info = env.step(np.ones(n, np.int32))
    rewards.append(rew.copy())
  assert term.all()
  assert set(np.unique(rewards[-1])) <= {-1.0, 1.0}
  assert all((r == 0).all() for r in rewards[:-1])
  obs, rew, term, trunc, info = env.step(np.ones(n, np.int32))
  np.testing.assert_array_equal(info["elapsed_step"], 0)
  assert (obs[:, 0, :].sum(-1) == 1).all()


def test_frozen_lake_bounds():
  env = _port("FrozenLake-v1", num_envs=16, seed=0)
  obs, _ = env.reset()
  np.testing.assert_array_equal(obs, 0)
  rng = np.random.default_rng(0)
  for _ in range(100):
    obs, rew, term, trunc, _ = env.step(rng.integers(0, 4, 16).astype(np.int32))
    assert ((obs >= 0) & (obs <= 15)).all()
    assert set(np.unique(rew)) <= {0.0, 1.0}
  env8 = _port("FrozenLake8x8-v1", num_envs=4, seed=0)
  assert env8.observation_space.n == 64


def test_cliffwalking_cliff_penalty():
  env = _port("CliffWalking-v0", num_envs=2, seed=0)
  obs, _ = env.reset()
  np.testing.assert_array_equal(obs, 36)
  obs, rew, term, trunc, _ = env.step(np.full(2, 1, np.int32))
  np.testing.assert_array_equal(rew, -100.0)
  np.testing.assert_array_equal(obs, 36)
  assert not term.any()
  obs, rew, term, trunc, _ = env.step(np.zeros(2, np.int32))
  np.testing.assert_array_equal(rew, -1.0)
  np.testing.assert_array_equal(obs, 24)


def test_cliffwalking_goal():
  env = _port("CliffWalking-v0", num_envs=1, seed=0)
  env.reset()
  env.step(np.array([0], np.int32))
  for _ in range(11):
    env.step(np.array([1], np.int32))
  obs, rew, term, trunc, _ = env.step(np.array([2], np.int32))
  assert term.all()
  np.testing.assert_array_equal(obs, 47)


def test_blackjack_obs_and_end():
  n = 64
  env = _port("Blackjack-v1", num_envs=n, seed=0)
  obs, _ = env.reset()
  assert obs.shape == (n, 3)
  assert ((obs[:, 0] >= 4) & (obs[:, 0] <= 21)).all()
  assert ((obs[:, 1] >= 1) & (obs[:, 1] <= 10)).all()
  assert set(np.unique(obs[:, 2])) <= {0, 1}
  obs, rew, term, trunc, _ = env.step(np.zeros(n, np.int32))
  assert term.all()
  assert set(np.unique(rew)) <= {-1.0, 0.0, 1.0}
  assert len(np.unique(rew)) > 1


def test_blackjack_hit_bust():
  n = 256
  env = _port("Blackjack-v1", num_envs=n, seed=1)
  env.reset()
  busted = np.zeros(n, np.bool_)
  rew_at_bust = np.zeros(n)
  for _ in range(15):
    obs, rew, term, trunc, info = env.step(np.ones(n, np.int32))
    fresh = term & ~busted & (info["elapsed_step"] > 0)
    rew_at_bust[fresh] = rew[fresh]
    busted |= fresh
  assert busted.mean() > 0.95
  np.testing.assert_array_equal(rew_at_bust[busted], -1.0)


def test_taxi_structure():
  n = 32
  env = _port("Taxi-v3", num_envs=n, seed=0)
  obs, _ = env.reset()
  assert ((obs >= 0) & (obs <= 499)).all()
  obs, rew, term, trunc, _ = env.step(np.full(n, 4, np.int32))
  assert set(np.unique(rew)) <= {-10.0, -1.0}
  assert (rew == -10).sum() > 0
  obs, rew, term, trunc, _ = env.step(np.zeros(n, np.int32))
  np.testing.assert_array_equal(rew, -1.0)


def test_nchain_rewards():
  n = 16
  env = _port("NChain-v0", num_envs=n, seed=0)
  obs, _ = env.reset()
  np.testing.assert_array_equal(obs, 0)
  tot = np.zeros(n)
  for _ in range(50):
    obs, rew, term, trunc, _ = env.step(np.zeros(n, np.int32))
    assert set(np.unique(rew)) <= {0.0, 2.0, 10.0}
    tot += rew
    assert ((obs >= 0) & (obs <= 4)).all()
  assert (tot > 0).all()


@pytest.mark.parametrize(
  "task,nspace", [("FrozenLake-v1", 16), ("CliffWalking-v0", 48),
                  ("Taxi-v3", 500), ("NChain-v0", 5)]
)
def test_discrete_obs_spaces(task, nspace):
  env = _port(task, num_envs=2)
  assert env.observation_space.n == nspace


# -------------------------------------------- twins of test_align_toy_text.py


def test_cliffwalking_alignment():
  ref = gymnasium.make("CliffWalking-v1").unwrapped
  ours = _port("CliffWalking-v0", num_envs=1, seed=0)
  robs, _ = ref.reset(seed=0)
  oobs, _ = ours.reset()
  assert int(oobs[0]) == int(robs)
  rng = np.random.default_rng(3)
  for t in range(120):
    a = int(rng.integers(0, 4))
    robs, rrew, rterm, rtrunc, _ = ref.step(a)
    oobs, orew, oterm, otrunc, _ = ours.step(np.asarray([a], np.int32))
    assert int(oobs[0]) == int(robs), f"step {t}"
    assert float(orew[0]) == float(rrew), f"step {t}"
    assert bool(oterm[0]) == bool(rterm), f"step {t}"
    if rterm:
      robs, _ = ref.reset()


def test_taxi_transition_alignment():
  ref = gymnasium.make("Taxi-v3").unwrapped
  ours = _port("Taxi-v3", num_envs=8, seed=1)
  obs, _ = ours.reset()
  rng = np.random.default_rng(0)
  prev_done = np.zeros(8, bool)
  for t in range(60):
    acts = rng.integers(0, 6, 8)
    prev = obs.copy()
    obs, rew, term, trunc, info = ours.step(acts.astype(np.int32))
    for i in range(8):
      if prev_done[i]:
        continue
      _, s2, r, done = ref.P[int(prev[i])][int(acts[i])][0]
      assert int(obs[i]) == s2, (t, i)
      assert float(rew[i]) == float(r), (t, i)
      assert bool(term[i]) == bool(done), (t, i)
    prev_done = np.asarray(term | trunc)


def test_frozen_lake_map_holes():
  ref = gymnasium.make("FrozenLake-v1", is_slippery=False).unwrapped
  desc = np.asarray([[c for c in row] for row in ref.desc.astype(str)])
  ours = _port("FrozenLake-v1", num_envs=64, seed=0)
  ours.reset()
  rng = np.random.default_rng(1)
  for t in range(200):
    obs, rew, term, trunc, _ = ours.step(rng.integers(0, 4, 64).astype(np.int32))
    for i in np.nonzero(term & ~trunc)[0]:
      cell = desc[divmod(int(obs[i]), 4)]
      assert cell in ("H", "G"), (t, i, cell)
      assert (rew[i] == 1.0) == (cell == "G")
