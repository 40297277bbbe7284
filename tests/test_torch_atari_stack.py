"""The port's Atari wrapper stack (``envpool_torch/envs/atari/atari_env.py``)
over the scripted emulator of ``tests/test_atari_stack.py`` on the CPU: the
twins of that file's 5 tests, the port's ``AtariEnv`` against the JAX
package's on the same emulator (frame stack, info and ``_override`` fields
bit for bit), and both through their ``HostEnvPool``s, with the common
fields' override rules checked after every life loss and game over."""

from collections import namedtuple

import numpy as np
import pytest

from envpool_torch.core.env import COMMON_CONFIG
from envpool_torch.envs import atari as port_atari
from envpool_torch.envs.atari import atari_env as A
from envpool_tpu.envs import atari as jax_atari
from envpool_tpu.envs.atari import atari_env as JA

from _torch_host import assert_outputs_equal, host_rollout
from test_atari_stack import FakeALE


def make_cfg(**kw):
  merged = dict(COMMON_CONFIG)
  merged.update(A.AtariEnv.default_config())
  merged.update(kw)
  Config = namedtuple("Config", [k.replace(".", "_") for k in merged])
  return Config(*merged.values())


@pytest.fixture
def patched(monkeypatch):
  """Both packages' ``_make_ale`` build scripted emulators; the list holds
  the port's, in construction order."""
  ales = []

  def fake_make(task, seed, rap):
    ale = FakeALE()
    ales.append(ale)
    return ale

  monkeypatch.setattr(A, "_make_ale", fake_make)
  monkeypatch.setattr(JA, "_make_ale", lambda task, seed, rap: FakeALE())
  yield ales
  A._action_set_size.cache_clear()
  JA._action_set_size.cache_clear()


# ------------------------------------------- twins of test_atari_stack.py


def test_noop_and_fire_reset(patched):
  env = A.AtariEnv(make_cfg(noop_max=30, seed=0), 0)
  obs, info = env.reset()
  ale = patched[0]
  # noop+fire: all noops (0) then exactly one FIRE (1) at the end
  assert ale.acts[-1] == 1
  assert all(a == 0 for a in ale.acts[:-1])
  assert 1 <= len(ale.acts) <= 30
  assert obs.shape == (4, 84, 84)
  # push_all on reset: all stack frames identical
  assert np.array_equal(obs[0], obs[1]) and np.array_equal(obs[1], obs[3])


def test_frame_skip_and_maxpool(patched):
  env = A.AtariEnv(make_cfg(noop_max=1, use_fire_reset=False, seed=0), 0)
  env.reset()
  ale = patched[0]
  t0 = ale.t
  obs, rew, term, info = env.step(2)  # action index 2 -> act value 3
  assert ale.t == t0 + 4              # frame_skip acts
  assert rew == 4 * 3.0               # reward accumulates over the skip
  # maxpool of the last two frames; the screen is constant, so the resize
  # keeps its value
  assert obs[-1].max() == (t0 + 4) % 256


def test_stack_rolls(patched):
  env = A.AtariEnv(make_cfg(noop_max=1, use_fire_reset=False, seed=0), 0)
  env.reset()
  frames = []
  for _ in range(5):
    obs, *_ = env.step(0)
    frames.append(obs.copy())
  # each step shifts the stack by one frame
  assert np.array_equal(frames[1][0:3], frames[0][1:4])


def test_episodic_life_and_reward_clip(patched):
  env = A.AtariEnv(
    make_cfg(noop_max=1, use_fire_reset=False, episodic_life=True,
             reward_clip=True, seed=0), 0
  )
  env.reset()
  done_at = None
  for i in range(40):
    obs, rew, term, info = env.step(3)  # act value 4 -> clipped to 1
    assert rew == 1.0
    assert info["reward"] == 4 * 4.0    # unclipped in info
    if term:
      done_at = i
      break
  assert done_at is not None            # life lost around act 36
  assert info["terminated"] == 0        # life loss is not game over
  # an episodic-life reset does not reset the real game
  ale_t_before = env.ale.t
  env.reset()
  assert env.ale.t > 0 and env.ale.t >= ale_t_before


def test_full_action_space(patched):
  env = A.AtariEnv(make_cfg(full_action_space=True, seed=0), 0)
  assert len(env.action_set) == 18


# ---------------------------------------------------- against the JAX env

CONFIGS = [
  {},
  dict(episodic_life=True, reward_clip=True),
  dict(gray_scale=False, stack_num=2, img_height=64, img_width=48,
       zero_discount_on_life_loss=True, episodic_life=True),
  dict(use_fire_reset=False, frame_skip=3, noop_max=5, full_action_space=True),
]


def _same(got, want, tag):
  if isinstance(want, dict):
    assert sorted(got) == sorted(want), tag
    for k in want:
      _same(got[k], want[k], f"{tag}/{k}")
  elif isinstance(want, tuple):
    assert len(got) == len(want), tag
    for i, (g, w) in enumerate(zip(got, want)):
      _same(g, w, f"{tag}/{i}")
  else:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (tag, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=tag)


@pytest.mark.parametrize("kw", CONFIGS)
def test_env_matches_jax_env(patched, kw):
  """Reset, then 120 steps of seeded actions through both envs on their
  own scripted emulators; a done step is followed by a reset, as the pool
  does."""
  cfg = make_cfg(seed=4, max_episode_steps=60, **kw)
  got_env, want_env = A.AtariEnv(cfg, 1), JA.AtariEnv(cfg, 1)
  assert got_env.action_set == want_env.action_set
  _same(got_env.reset(), want_env.reset(), "reset")
  acts = np.random.default_rng(5).integers(0, len(got_env.action_set), 120)
  for t, a in enumerate(acts.tolist()):
    got, want = got_env.step(a), want_env.step(a)
    _same(got, want, f"step {t}")
    if got[2]:
      _same(got_env.reset(), want_env.reset(), f"reset after {t}")
  assert got_env.ale.t == want_env.ale.t and got_env.ale.acts == want_env.ale.acts


def _spec(module, **kw):
  return module.AtariEnvSpec(module.AtariEnvSpec.gen_config(**kw))


@pytest.mark.parametrize("kw", CONFIGS[:2])
def test_pool_matches_jax_pool(patched, kw):
  """Both ``HostEnvPool``s over the emulator, 6 envs x 150 steps: every
  output field bit for bit, and the common fields' override rules: a step
  after a done step is a FIRST step with reward 0; ``elapsed_step`` counts
  the real game's steps, restarts at 0 only after a game over and goes on
  after an episodic life loss; LAST exactly at done."""
  n, steps = 6, 150
  config = dict(num_envs=n, seed=6, max_episode_steps=1000, num_threads=3, **kw)
  got_env = port_atari.AtariGymnasiumEnvPool(_spec(port_atari, **config), "cpu")
  want_env = jax_atari.AtariGymnasiumEnvPool(_spec(jax_atari, **config))
  keys = got_env.spec._state_keys
  assert keys == want_env.spec._state_keys
  acts = np.random.default_rng(7).integers(0, 4, (steps, n)).astype(np.int32)
  got = host_rollout(got_env, acts)
  assert_outputs_equal(keys, got, host_rollout(want_env, acts), str(kw))

  col = {k: np.stack([np.asarray(o[keys.index(k)]) for o in got]) for k in (
    "done", "step_type", "elapsed_step", "reward", "info:lives",
    "info:terminated",
  )}
  after_done = col["done"][:-1]
  nxt = slice(1, None)
  assert np.all(col["step_type"][nxt][after_done] == 0)
  assert np.all(col["reward"][nxt][after_done] == 0)
  assert np.all((col["step_type"] == 2) == col["done"])
  game_over = col["info:terminated"][:-1] == 1
  assert game_over.any(axis=0).all(), "every lane ends a game"
  assert (col["info:lives"] < 3).any(axis=0).all(), "every lane loses a life"
  assert np.all(col["elapsed_step"][nxt][game_over] == 0)
  live = ~after_done
  assert np.all(col["elapsed_step"][nxt][live] == col["elapsed_step"][:-1][live] + 1)
  life_lost = after_done & ~game_over
  if kw.get("episodic_life"):
    assert life_lost.any()
    assert np.all(col["elapsed_step"][nxt][life_lost] == col["elapsed_step"][:-1][life_lost])
  else:
    assert not life_lost.any()
