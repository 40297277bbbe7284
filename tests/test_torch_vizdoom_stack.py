"""The port's ViZDoom env (``envpool_torch/envs/vizdoom/vizdoom_env.py``) over
the scripted DoomGame of ``tests/test_vizdoom_stack.py`` on the CPU: the
twins of that file's 7 tests, the port's ``VizdoomEnv`` against the JAX
package's on the same script (every output field bit for bit, through
episode ends, empty screens and the resets after them), and both through
their ``HostEnvPool``s in sync and async mode and the port's ``xla()`` on
the CPU, in both action modes, with the action's dtype and shape checked
where it reaches the workers."""

import sys
import types
from collections import namedtuple

import numpy as np
import pytest
import torch

from envpool_torch.core.env import COMMON_CONFIG
from envpool_torch.core.envpool_api import py_env
from envpool_torch.core.host_pool import HostEnvPool
from envpool_torch.envs.vizdoom import vizdoom_env as V
from envpool_tpu.core.envpool_api import py_env as jax_py_env
from envpool_tpu.core.host_pool import HostEnvPool as JaxHostEnvPool
from envpool_tpu.envs.vizdoom import vizdoom_env as JV

from _torch_host import (
  assert_outputs_equal,
  assert_sequences_equal,
  async_sequences,
  host_rollout,
)
from test_vizdoom_stack import BUTTONS, RAW_H, RAW_W, FakeDoomGame, _State


class EmptyAtEndDoomGame(FakeDoomGame):
  """As ``FakeDoomGame``, but a finished episode has no screen (what
  ``DoomGame.get_state()`` gives then)."""

  def get_state(self):
    return None if self.is_episode_finished() else super().get_state()


class GrayDoomGame(FakeDoomGame):
  """One screen channel, the buffer a 2-D array; ARMOR and HITCOUNT move."""

  def get_screen_channels(self):
    return 1

  def get_state(self):
    buf = np.arange(RAW_H * RAW_W, dtype=np.int64).reshape(RAW_H, RAW_W)
    return _State(((buf + 7 * self.tic) % 256).astype(np.uint8))

  def get_game_variable(self, gv):
    if gv == "ARMOR":
      return float((self.tic * 3) % 17)
    if gv == "HITCOUNT":
      return float(self.tic // 3)
    return super().get_game_variable(gv)


def _clear_caches():
  for m in (V, JV):
    m._screen_channels.cache_clear()
    m._available_buttons.cache_clear()


def _install(monkeypatch, game_cls):
  game_cls.instances = []
  FakeDoomGame.instances = game_cls.instances
  fake = types.ModuleType("vizdoom")
  fake.DoomGame = game_cls
  fake.Mode = types.SimpleNamespace(PLAYER=0)
  # GameVariable attrs resolve to their own names (the fake's convention)
  fake.GameVariable = types.SimpleNamespace(
    **{v: v for v in ("HEALTH", "KILLCOUNT", "FRAGCOUNT", "DEATHCOUNT",
                      "HITCOUNT", "DAMAGECOUNT", "ARMOR")}
  )
  monkeypatch.setitem(sys.modules, "vizdoom", fake)
  return game_cls.instances


@pytest.fixture
def patched(monkeypatch):
  """The scripted ``vizdoom`` module in place, both packages' spec caches
  cleared before and after (they are keyed by cfg_path alone)."""
  _clear_caches()
  yield _install(monkeypatch, FakeDoomGame)
  _clear_caches()


def make_cfg(**kw):
  merged = dict(COMMON_CONFIG)
  merged.update(V.VizdoomEnv.default_config())
  merged.update(kw)
  Config = namedtuple("Config", [k.replace(".", "_") for k in merged])
  return Config(*merged.values())


# ------------------------------------------- twins of test_vizdoom_stack.py


def test_reset_frame_pipeline(patched) -> None:
  env = V.VizdoomEnv(make_cfg(seed=3), 2)
  game = patched[0]
  assert game.seed == 5  # seed + env_id
  obs, info = env.reset()
  # stack_num * channels planes, resized to 84x84
  assert obs.shape == (12, 84, 84) and obs.dtype == np.uint8
  # push_all on reset: all stack frames identical
  assert np.array_equal(obs[:3], obs[9:])
  assert "HEALTH" in info and info["HEALTH"] == 100.0


def test_frame_skip_and_stack_roll(patched) -> None:
  env = V.VizdoomEnv(make_cfg(frame_skip=4), 0)
  env.reset()
  game = patched[0]
  obs1, *_ = env.step(np.asarray([1.0, 0.0, 0.0, 0.0]))
  assert game.acts[-1] == ((1.0, 0.0, 0.0, 0.0), 4)
  assert obs1[-1].max() == 4  # newest frame painted with tic=4
  obs2, *_ = env.step(np.asarray([0.0, 0.0, 0.0, 0.0]))
  # stack rolled by one frame (one channel group)
  assert np.array_equal(obs2[6:9], obs1[9:12])


def test_reward_shaping_deltas(patched) -> None:
  """reward = pos*max(d,0) + neg*max(-d,0) per variable per step
  (vizdoom_env.h:52-66): HEALTH -10 and KILLCOUNT +1."""
  env = V.VizdoomEnv(make_cfg(frame_skip=5), 0)
  env.reset()
  obs, rew, done, info = env.step(np.zeros(4))
  # tic 0 -> 5: HEALTH 100->90 (delta -10, neg coef -0.003 -> 0.03 loss)
  # KILLCOUNT 0->1 (pos coef 1)
  assert rew == pytest.approx(1.0 - 0.03)


def test_episodic_life_and_episode_end(patched) -> None:
  env = V.VizdoomEnv(make_cfg(frame_skip=10, episodic_life=True), 0)
  env.reset()
  dones = []
  for _ in range(6):
    _, _, done, _ = env.step(np.zeros(4))
    dones.append(bool(done))
  # dead from tic 40 (episodic life) and true end at 60
  assert dones == [False, False, False, True, True, True]


def test_lmp_recording_paths(tmp_path, patched) -> None:
  env = V.VizdoomEnv(make_cfg(lmp_save_dir=str(tmp_path)), 4)
  env.reset()
  env.reset()
  game = patched[0]
  assert len(game.lmp_paths) == 2
  assert game.lmp_paths[0].endswith("env_4_ep_1.lmp")
  assert game.lmp_paths[1].endswith("env_4_ep_2.lmp")


def test_combined_action_mapping(patched) -> None:
  """use_combined_action: discrete id -> button row via build_action_set."""
  from envpool_torch.envs.vizdoom.action_set import build_action_set
  env = V.VizdoomEnv(make_cfg(use_combined_action=True), 0)
  env.reset()
  expected = build_action_set(BUTTONS, False, {})
  env.step(np.int32(1))
  game = patched[0]
  assert list(game.acts[-1][0]) == list(expected[1])


def test_through_host_pool(patched) -> None:
  spec_cls, _, _, gymnasium_cls = py_env(V.VizdoomEnv, pool_base=HostEnvPool)
  spec = spec_cls(spec_cls.gen_config(
    num_envs=2, seed=0, max_episode_steps=100, cfg_path="__fake__"
  ))
  env = gymnasium_cls(spec, "cpu")
  obs, info = env.reset()
  assert obs.shape == (2, 12, 84, 84)
  obs, rew, term, trunc, info = env.step(
    np.zeros((2, 4), np.float64)
  )
  assert obs.shape == (2, 12, 84, 84)
  assert info["HEALTH"].shape == (2,)


# ---------------------------------------------------- against the JAX env

GAMES = {"rgb": FakeDoomGame, "empty_at_end": EmptyAtEndDoomGame,
         "gray": GrayDoomGame}
CONFIGS = [
  ("rgb", {}),
  ("rgb", dict(use_combined_action=True)),
  ("empty_at_end", dict(frame_skip=10, episodic_life=True)),
  ("empty_at_end", dict(stack_num=2, img_height=60, img_width=80, frame_skip=3)),
  ("gray", dict(use_combined_action=True, force_speed=True, stack_num=3,
                img_height=30, img_width=40)),
  ("gray", dict(frame_skip=7, lmp_save_dir="LMP")),
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
    assert type(got) is type(want), (tag, type(got), type(want))
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (tag, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=tag)


def _actions(cfg, steps, seed):
  rng = np.random.default_rng(seed)
  if cfg.use_combined_action:
    n = len(V.build_action_set(BUTTONS, bool(cfg.force_speed), {}))
    return list(rng.integers(0, n, steps).astype(np.int32))
  return list(rng.uniform(-1, 1, (steps, len(BUTTONS))))


@pytest.mark.parametrize("game,kw", CONFIGS, ids=lambda x: str(x))
def test_env_matches_jax_env(monkeypatch, tmp_path, game, kw):
  """Reset, then 45 steps of seeded actions through both envs on their own
  scripted games; a done step is followed by a reset, as the pool does.
  Every output equal in type, dtype and value; the games saw the same
  button rows, skips and .lmp paths."""
  _clear_caches()
  games = _install(monkeypatch, GAMES[game])
  try:
    if kw.get("lmp_save_dir"):
      kw = dict(kw, lmp_save_dir=str(tmp_path))
    cfg = make_cfg(seed=4, **kw)
    got_env, want_env = V.VizdoomEnv(cfg, 1), JV.VizdoomEnv(cfg, 1)
    assert games == [got_env.dg, want_env.dg]
    got_spec, want_spec = V.VizdoomEnv.state_spec(cfg), JV.VizdoomEnv.state_spec(cfg)
    assert list(got_spec) == list(want_spec)
    for k, s in got_spec.items():
      assert (s.dtype, s.shape) == (want_spec[k].dtype, want_spec[k].shape), k
    sa, wa = (e.action_spec(cfg)["action"] for e in (V.VizdoomEnv, JV.VizdoomEnv))
    assert (sa.dtype, sa.shape, sa.minimum, sa.maximum) == (
      wa.dtype, wa.shape, wa.minimum, wa.maximum)
    _same(got_env.reset(), want_env.reset(), "reset")
    ends = 0
    for t, a in enumerate(_actions(cfg, 45, 5)):
      got, want = got_env.step(a), want_env.step(a)
      _same(got, want, f"step {t}")
      if got[2]:
        ends += 1
        if game == "empty_at_end" and got_env.dg.is_episode_finished():
          # the newest frame of an ended episode is blank
          assert not got[0][-got_env.ch:].any()
        _same(got_env.reset(), want_env.reset(), f"reset after {t}")
        np.testing.assert_array_equal(got_env.stack, want_env.stack)
    assert ends >= 2
    for attr in ("acts", "lmp_paths", "tic", "episode", "seed"):
      assert getattr(got_env.dg, attr) == getattr(want_env.dg, attr), attr
  finally:
    _clear_caches()


# ---------------------------------------------------- through the pools


def _port_pool(**config):
  """The port's ``HostEnvPool`` (gymnasium dialect) on the CPU."""
  spec_cls, _, _, gym_cls = py_env(V.VizdoomEnv, pool_base=HostEnvPool)
  return gym_cls(spec_cls(spec_cls.gen_config(**config)), "cpu")


def _pools(**config):
  """A port and a JAX ``HostEnvPool`` of the same config."""
  jspec_cls, _, _, jgym_cls = jax_py_env(JV.VizdoomEnv, pool_base=JaxHostEnvPool)
  got = _port_pool(**config)
  want = jgym_cls(jspec_cls(jspec_cls.gen_config(**config)))
  assert got.spec._state_keys == want.spec._state_keys
  return got, want


def _pool_actions(pool, shape, seed):
  """Seeded actions of the pool's action spec, ``shape`` rows of them:
  int32 ids over the combined set, or float64 buttons in [-1, 1]."""
  a = pool.spec.action_array_spec["action"]
  rng = np.random.default_rng(seed)
  if a.dtype == np.int32:
    return rng.integers(0, int(a.maximum) + 1, shape).astype(np.int32)
  return rng.uniform(-1, 1, (*shape, *a.static_shape))


def _spy_sends(pool):
  """Record the dtype and shape of every action array that ``_send``
  hands to the workers."""
  seen = []
  send = pool._send

  def spy(action_list):
    adict = dict(zip(pool._action_keys, action_list))
    a = np.asarray(adict["action"])
    seen.append((a.dtype, a.shape))
    return send(action_list)

  pool._send = spy
  return seen


MODES = [("rgb", {}), ("rgb", dict(use_combined_action=True)),
         ("empty_at_end", dict(episodic_life=True))]


@pytest.mark.parametrize("game,kw", MODES, ids=lambda x: str(x))
def test_pool_matches_jax_pool(monkeypatch, game, kw):
  """Both ``HostEnvPool``s, 6 envs x 40 steps: every output field bit for
  bit, the info columns float64; the action reaches the workers as float64
  ``[6, 4]`` buttons or int32 ``[6]`` ids; a step after a done step is a
  FIRST step with reward 0 and elapsed_step 0."""
  _clear_caches()
  _install(monkeypatch, GAMES[game])
  try:
    n, steps = 6, 40
    got_env, want_env = _pools(num_envs=n, seed=6, max_episode_steps=100,
                               num_threads=3, **kw)
    keys = got_env.spec._state_keys
    acts = _pool_actions(got_env, (steps, n), seed=7)
    seen = _spy_sends(got_env)
    got = host_rollout(got_env, acts)
    assert_outputs_equal(keys, got, host_rollout(want_env, acts), str(kw))
    want_act = (np.dtype(np.int32), (n,)) if kw.get("use_combined_action") else (
      np.dtype(np.float64), (n, len(BUTTONS)))
    assert seen == [want_act] * steps
    for v in V.INFO_VARS:
      assert got[0][keys.index(f"info:{v}")].dtype == np.float64, v
    col = {k: np.stack([o[keys.index(k)] for o in got])
           for k in ("done", "step_type", "elapsed_step", "reward")}
    after = col["done"][:-1]
    assert after.sum() >= n
    assert (col["step_type"][1:][after] == 0).all()
    assert (col["reward"][1:][after] == 0).all()
    assert (col["elapsed_step"][1:][after] == 0).all()
  finally:
    _clear_caches()


@pytest.mark.parametrize("kw", [{}, dict(use_combined_action=True)], ids=str)
def test_async_sequences_match_jax_pool(monkeypatch, kw):
  """An async pool (batch 3 of 8): each env's own sequence equal."""
  _clear_caches()
  _install(monkeypatch, FakeDoomGame)
  try:
    num_envs, batch, rounds = 8, 3, 40
    got_env, want_env = _pools(num_envs=num_envs, batch_size=batch,
                               num_threads=4, seed=9, max_episode_steps=100, **kw)
    table = _pool_actions(got_env, (num_envs, rounds * batch), seed=10)
    got = async_sequences(got_env, rounds, table)
    want = async_sequences(want_env, rounds, table)
    assert_sequences_equal(got_env.spec._state_keys, got, want, min_len=2)
  finally:
    _clear_caches()


@pytest.mark.parametrize("kw", [{}, dict(use_combined_action=True)], ids=str)
def test_xla_bridge_matches_host_api(monkeypatch, kw):
  """The port's ``xla()`` on a CPU pool, the actions as torch tensors
  (float64 buttons or int32 ids): outputs equal to a twin's host API, the
  float64 info columns kept float64."""
  _clear_caches()
  _install(monkeypatch, FakeDoomGame)
  try:
    n = 4
    env, twin = (_port_pool(num_envs=n, seed=11, max_episode_steps=100, **kw)
                 for _ in range(2))
    keys = env.spec._state_keys
    acts = _pool_actions(env, (25, n), seed=12)
    seen = _spy_sends(env)
    handle, _, _, step = env.xla()
    got, want = [], []
    for act in acts:
      handle, out = step(handle, torch.from_numpy(act))
      got.append([o.numpy() for o in out])
      twin.send(act)
      want.append(twin._recv())
    assert_outputs_equal(keys, got, want, str(kw))
    assert seen == [(acts.dtype, acts.shape[1:])] * len(acts)
    assert got[0][keys.index("info:HEALTH")].dtype == np.float64
  finally:
    _clear_caches()
