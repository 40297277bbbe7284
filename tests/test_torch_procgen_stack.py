"""The port's procgen env (``envpool_torch/envs/procgen/procgen_env.py``) over
the scripted gym3 game of ``tests/test_procgen_stack.py`` on the CPU: the
twins of that file's 4 tests, the port's ``ProcgenEnv`` against the JAX
package's on the same script (every output field bit for bit, through
gym3's ``first`` steps and the observing resets after them), and both
through their ``HostEnvPool``s in sync and async mode and the port's
``xla()`` on the CPU."""

import sys
import types
from collections import namedtuple

import numpy as np
import pytest
import torch

from envpool_torch.core.env import COMMON_CONFIG
from envpool_torch.core.envpool_api import py_env
from envpool_torch.core.host_pool import HostEnvPool
from envpool_tpu.core.envpool_api import py_env as jax_py_env
from envpool_tpu.core.host_pool import HostEnvPool as JaxHostEnvPool

from _torch_host import (
  assert_outputs_equal,
  assert_sequences_equal,
  async_sequences,
  host_rollout,
)
from test_procgen_stack import RES, FakeProcgenGame


@pytest.fixture
def patched(monkeypatch):
  FakeProcgenGame.instances = []
  fake = types.ModuleType("procgen")
  fake.ProcgenGym3Env = FakeProcgenGame
  monkeypatch.setitem(sys.modules, "procgen", fake)
  yield FakeProcgenGame.instances


def _env_classes():
  """The port's and the JAX package's ``ProcgenEnv`` (their packages gate
  on ``procgen``, so they are imported under the fake)."""
  from envpool_torch.envs.procgen.procgen_env import ProcgenEnv
  from envpool_tpu.envs.procgen.procgen_env import ProcgenEnv as JaxProcgenEnv
  return ProcgenEnv, JaxProcgenEnv


def make_cfg(**kw):
  ProcgenEnv, _ = _env_classes()
  merged = dict(COMMON_CONFIG)
  merged.update(ProcgenEnv.default_config())
  merged.update(kw)
  Config = namedtuple("Config", [k.replace(".", "_") for k in merged])
  return Config(*merged.values())


# ------------------------------------------- twins of test_procgen_stack.py


def test_reset_step_and_info_plumbing(patched) -> None:
  ProcgenEnv, _ = _env_classes()
  env = ProcgenEnv(make_cfg(seed=7), 3)
  game = patched[0]
  assert game.rand_seed == 10  # seed + env_id (procgen_env.h:71-89)
  obs, info = env.reset()
  assert obs.shape == (3, RES, RES) and obs.dtype == np.uint8
  assert info["level_seed"] == 10
  assert info["prev_level_seed"] == -1
  obs, rew, first, info = env.step(np.int32(5))
  assert rew == 5.0
  assert not first
  # channel_first transpose: painted counter appears on every channel
  assert obs[1, 5, 5] == 1


def test_channel_last(patched) -> None:
  ProcgenEnv, _ = _env_classes()
  env = ProcgenEnv(make_cfg(channel_first=False), 0)
  obs, _ = env.reset()
  assert obs.shape == (RES, RES, 3)


def test_gym3_autoreset_first_flag_is_done(patched) -> None:
  """gym3's 'first' on the post-step observe marks episode end; level
  seeds roll to the next level (procgen_env.h:150-210)."""
  ProcgenEnv, _ = _env_classes()
  env = ProcgenEnv(make_cfg(), 0)
  env.reset()
  firsts = []
  for t in range(10):
    obs, rew, first, info = env.step(np.int32(1))
    firsts.append(bool(first))
  assert firsts.count(True) == 1 and firsts[8]
  assert env._info()["prev_level_complete"] == 1
  assert env._info()["level_seed"] != env._info()["prev_level_seed"]


def test_through_host_pool(patched) -> None:
  """Full HostEnvPool round trip: batched obs/reward/done, auto-reset."""
  ProcgenEnv, _ = _env_classes()
  spec_cls, _, _, gymnasium_cls = py_env(ProcgenEnv, pool_base=HostEnvPool)
  spec = spec_cls(spec_cls.gen_config(
    num_envs=3, seed=0, max_episode_steps=100
  ))
  env = gymnasium_cls(spec, "cpu")
  obs, info = env.reset()
  assert obs.shape == (3, 3, RES, RES)
  np.testing.assert_array_equal(sorted(info["env_id"]), [0, 1, 2])
  for t in range(12):
    acts = np.full(3, 2, np.int32)
    obs, rew, term, trunc, info = env.step(acts)
    if t < 8:
      np.testing.assert_array_equal(rew, 2.0)
  # each env saw exactly one episode end within 12 steps (ep_len 9)
  assert all(g.prev_complete == 1 for g in patched[:3])


# ---------------------------------------------------- against the JAX env


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


CONFIGS = [{}, dict(channel_first=False, env_name="coinrun", distribution_mode=0),
           dict(distribution_mode=10, num_levels=5, start_level=3,
                use_sequential_levels=True, seed=2**31 - 2)]


@pytest.mark.parametrize("kw", CONFIGS, ids=str)
def test_env_matches_jax_env(patched, kw):
  """The spec, then reset and 30 steps of seeded actions through both envs
  on their own scripted games; a done step is followed by a reset, as the
  pool does. Every output equal in type, dtype and value; the games were
  built with the same arguments and saw the same acts."""
  ProcgenEnv, JaxProcgenEnv = _env_classes()
  cfg = make_cfg(**{"seed": 4, **kw})
  for name in ("state_spec", "action_spec"):
    got_spec, want_spec = getattr(ProcgenEnv, name)(cfg), getattr(JaxProcgenEnv, name)(cfg)
    assert list(got_spec) == list(want_spec)
    for k, s in got_spec.items():
      w = want_spec[k]
      assert (s.dtype, s.shape, s.minimum, s.maximum) == (
        w.dtype, w.shape, w.minimum, w.maximum), k
  got_env, want_env = ProcgenEnv(cfg, 5), JaxProcgenEnv(cfg, 5)
  got_game, want_game = patched
  assert (got_game.env_name, got_game.rand_seed, got_game.kwargs) == (
    want_game.env_name, want_game.rand_seed, want_game.kwargs)
  _same(got_env.reset(), want_env.reset(), "reset")
  acts = np.random.default_rng(3).integers(0, 15, 30).astype(np.int32)
  ends = 0
  for t, a in enumerate(acts):
    got, want = got_env.step(a), want_env.step(a)
    _same(got, want, f"step {t}")
    if got[2]:
      ends += 1
      _same(got_env.reset(), want_env.reset(), f"reset after {t}")
  assert ends == 3
  assert (got_game.t, got_game.level_seed) == (want_game.t, want_game.level_seed)


# ---------------------------------------------------- through the pools


def _port_pool(**config):
  ProcgenEnv, _ = _env_classes()
  spec_cls, _, _, gym_cls = py_env(ProcgenEnv, pool_base=HostEnvPool)
  return gym_cls(spec_cls(spec_cls.gen_config(**config)), "cpu")


def _pools(**config):
  _, JaxProcgenEnv = _env_classes()
  jspec_cls, _, _, jgym_cls = jax_py_env(JaxProcgenEnv, pool_base=JaxHostEnvPool)
  got = _port_pool(**config)
  want = jgym_cls(jspec_cls(jspec_cls.gen_config(**config)))
  assert got.spec._state_keys == want.spec._state_keys
  return got, want


@pytest.mark.parametrize("kw", [{}, dict(channel_first=False, max_episode_steps=7)],
                         ids=str)
def test_pool_matches_jax_pool(patched, kw):
  """Both ``HostEnvPool``s, 6 envs x 40 steps: every output field bit for
  bit. The step after a done step is the pool's reset, which only observes
  the game: reward 0, elapsed_step 0, a FIRST step, and the level seed
  the game rolled to (a time limit rolls none)."""
  n, steps = 6, 40
  got_env, want_env = _pools(**{"num_envs": n, "seed": 6, "max_episode_steps": 100,
                                "num_threads": 3, **kw})
  keys = got_env.spec._state_keys
  acts = np.random.default_rng(7).integers(0, 15, (steps, n)).astype(np.int32)
  got = host_rollout(got_env, acts)
  assert_outputs_equal(keys, got, host_rollout(want_env, acts), str(kw))
  col = {k: np.stack([o[keys.index(k)] for o in got]) for k in (
    "done", "trunc", "step_type", "elapsed_step", "reward", "info:level_seed",
    "info:prev_level_seed", "info:prev_level_complete",
  )}
  after = col["done"][:-1]
  assert after.sum() >= n
  assert (col["step_type"][1:][after] == 0).all()
  assert (col["reward"][1:][after] == 0).all()
  assert (col["elapsed_step"][1:][after] == 0).all()
  # a level's end rolls the seed on the done step itself; the reset row
  # repeats it
  rolled = after & ~col["trunc"][:-1]
  assert (col["info:level_seed"][1:][after] == col["info:level_seed"][:-1][after]).all()
  assert (col["info:prev_level_complete"][:-1][rolled] == 1).all()
  assert (col["info:prev_level_seed"][:-1][rolled] + 100
          == col["info:level_seed"][:-1][rolled]).all()
  if kw.get("max_episode_steps") == 7:
    assert (col["trunc"] & col["done"]).any()


def test_async_sequences_match_jax_pool(patched):
  """An async pool (batch 3 of 8): each env's own sequence equal."""
  num_envs, batch, rounds = 8, 3, 40
  got_env, want_env = _pools(num_envs=num_envs, batch_size=batch, num_threads=4,
                             seed=9, max_episode_steps=100)
  table = np.random.default_rng(10).integers(
    0, 15, (num_envs, rounds * batch)).astype(np.int32)
  got = async_sequences(got_env, rounds, table)
  want = async_sequences(want_env, rounds, table)
  assert_sequences_equal(got_env.spec._state_keys, got, want, min_len=2)


def test_xla_bridge_matches_host_api(patched):
  """The port's ``xla()`` on a CPU pool, the actions as int32 tensors:
  outputs equal to a twin's host API."""
  n = 4
  env, twin = (_port_pool(num_envs=n, seed=11, max_episode_steps=100) for _ in range(2))
  keys = env.spec._state_keys
  acts = np.random.default_rng(12).integers(0, 15, (25, n)).astype(np.int32)
  handle, _, _, step = env.xla()
  got, want = [], []
  for act in acts:
    handle, out = step(handle, torch.from_numpy(act))
    got.append([o.numpy() for o in out])
    twin.send(act)
    want.append(twin._recv())
  assert_outputs_equal(keys, got, want)
