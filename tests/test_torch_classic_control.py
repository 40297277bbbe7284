"""The port's Pendulum, Acrobot and MountainCar families (CPU): step for
step against ``envpool_tpu`` from the same seed and actions across
auto-resets, and twins of their ``tests/test_align_classic_control.py``
cases against the float64 re-derivations of the reference formulas.

Tolerances. Resets draw with the bit-exact ``prng.uniform``, so the reset
state is exact; observations that pass it through cos/sin agree to 1e-7.
Steps: integer and bool fields exact; observations and ``info:state`` to
1e-5 absolute and rewards to 5e-5 absolute (float32 values below 17 in
magnitude: XLA contracts multiply-adds and its trig may differ by an ulp,
and Pendulum's and Acrobot's dynamics grow that over an episode).
"""

import math
from collections import namedtuple

import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu
from envpool_torch.envs.classic_control.acrobot import AcrobotEnv
from envpool_torch.envs.classic_control.mountain_car import (
  MountainCarContinuousEnv,
  MountainCarEnv,
)
from envpool_torch.envs.classic_control.pendulum import PendulumEnv

torch.set_num_threads(1)

# (task id, continuous, discrete action count); max_episode_steps is cut so
# that every lane auto-resets within the run
FAMILIES = [
  ("Pendulum-v0", True, 0),
  ("Pendulum-v1", True, 0),
  ("Acrobot-v1", False, 3),
  ("MountainCar-v0", False, 3),
  ("MountainCarContinuous-v0", True, 0),
]


@pytest.mark.parametrize("task_id,continuous,n_act", FAMILIES)
def test_step_for_step_parity(task_id, continuous, n_act):
  kw = dict(num_envs=8, seed=1, max_episode_steps=25)
  want_env = envpool_tpu.make_gymnasium(task_id, **kw)
  got_env = envpool_torch.make_gymnasium(task_id, device="cpu", **kw)
  w, g = want_env.reset(), got_env.reset()
  np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-7)
  w_st, g_st = want_env.save_state(), got_env.save_state()
  for k in w_st.env:   # the reset state: uniform() draws, bit-exact
    np.testing.assert_array_equal(g_st.env[k], np.asarray(w_st.env[k]), k)
  rng = np.random.default_rng(0)
  resets = 0
  for _ in range(60):
    if continuous:
      act = rng.uniform(-2.5, 2.5, (8, 1)).astype(np.float32)
    else:
      act = rng.integers(0, n_act, 8).astype(np.int32)
    w, g = want_env.step(act), got_env.step(act)
    assert g[0].dtype == np.float32 and g[0].shape == w[0].shape
    np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g[1], w[1], rtol=0, atol=5e-5)
    for i in (2, 3):
      np.testing.assert_array_equal(g[i], w[i])
    for k in ("env_id", "elapsed_step"):
      np.testing.assert_array_equal(g[4][k], w[4][k])
    if "state" in w[4]:
      np.testing.assert_allclose(g[4]["state"], w[4]["state"], rtol=0, atol=1e-5)
    resets += int((g[4]["elapsed_step"] == 0).sum())
  assert resets >= 16


# ------------------------------------ twins of test_align_classic_control.py


def _step(env_cls, cfg, state, action):
  return env_cls.step(cfg, state, action, torch.zeros(len(action), 2, dtype=torch.int64))


@pytest.mark.parametrize("version", [0, 1])
def test_pendulum_align(version):
  cfg = namedtuple("C", ["version"])(version)
  rng = np.random.RandomState(0)
  theta = rng.uniform(-math.pi, math.pi, 50)
  theta_dot = rng.uniform(-1, 1, 50)
  u = rng.uniform(-2, 2, 50)
  state = {
    "theta": torch.tensor(theta, dtype=torch.float32),
    "theta_dot": torch.tensor(theta_dot, dtype=torch.float32),
  }
  _, obs, rew, term, _ = _step(
    PendulumEnv, cfg, state, torch.tensor(u[:, None], dtype=torch.float32)
  )
  # float64 reference (``envpool/classic_control/pendulum.h:84-103``)
  cost = theta**2 + 0.1 * theta_dot**2 + 0.001 * u**2
  new_td = theta_dot + 3 * (10.0 / 2 * np.sin(theta) + u) * 0.05
  td2 = np.clip(new_td, -8, 8)
  theta2 = theta + (new_td if version == 0 else td2) * 0.05
  theta2 = (theta2 + math.pi) % (2 * math.pi) - math.pi
  ref = np.stack([np.cos(theta2), np.sin(theta2), td2], 1)
  np.testing.assert_allclose(obs.numpy(), ref, rtol=1e-4, atol=1e-5)
  np.testing.assert_allclose(rew.numpy(), -cost, rtol=1e-4, atol=1e-5)
  assert not term.any()


@pytest.mark.parametrize("act", [0, 1, 2])
def test_mountain_car_align(act):
  rng = np.random.RandomState(1)
  pos = rng.uniform(-1.2, 0.6, 50)
  vel = rng.uniform(-0.07, 0.07, 50)
  state = {
    "pos": torch.tensor(pos, dtype=torch.float32),
    "vel": torch.tensor(vel, dtype=torch.float32),
  }
  _, obs, rew, term, _ = _step(
    MountainCarEnv, None, state, torch.full((50,), act, dtype=torch.int32)
  )
  v = np.clip(vel + (act - 1) * 0.001 - np.cos(3 * pos) * 0.0025, -0.07, 0.07)
  p = np.clip(pos + v, -1.2, 0.6)
  v = np.where((p == -1.2) & (v < 0), 0.0, v)
  np.testing.assert_allclose(obs.numpy(), np.stack([p, v], 1), rtol=1e-4, atol=1e-6)
  np.testing.assert_array_equal(rew.numpy(), -1.0)
  np.testing.assert_array_equal(term.numpy(), (p >= 0.5) & (v >= 0))


def test_mountain_car_continuous_reward():
  state = {"pos": torch.tensor([0.44]), "vel": torch.tensor([0.05])}
  _, obs, rew, term, _ = _step(
    MountainCarContinuousEnv, None, state, torch.tensor([[0.5]])
  )
  assert bool(term[0])  # crosses 0.45 easily with +vel
  np.testing.assert_allclose(float(rew[0]), 100 - 0.1 * 0.25, rtol=1e-5)


def test_acrobot_rk4_sanity():
  """Small-step behaviour and the terminal condition: hanging nearly
  straight down stays near down; links pointing up from the pivot
  (theta1 = pi: -cos(pi) - cos(pi) = 2 > 1) is terminal with reward 0."""
  s = torch.tensor([[0.05, -0.02, 0.01, 0.03, 0.0],
                    [math.pi, 0.0, 0.0, 0.0, 0.0]], dtype=torch.float32)
  _, obs, rew, term, info = _step(
    AcrobotEnv, None, {"s": s}, torch.tensor([1, 1], dtype=torch.int32)
  )
  assert not bool(term[0]) and float(rew[0]) == -1.0
  assert abs(float(info["state"][0, 0])) < 0.5
  assert bool(term[1]) and float(rew[1]) == 0.0
  assert obs.shape == (2, 6) and info["state"].shape == (2, 2)
