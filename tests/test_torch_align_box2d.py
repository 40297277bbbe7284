"""The port's twins of ``tests/test_align_lunar_lander.py`` and
``tests/test_align_bipedal_walker.py`` (CPU pools): measured agreement
with gymnasium's Box2D environments (ballistics, engine and motor
authority, terrain statistics, lidar geometry, outcome regimes), with the
same bounds. They run where ``Box2D`` is installed; the port itself never
imports it.
"""

import numpy as np
import pytest
import torch

import envpool_torch
from envpool_torch.core import prng
from envpool_torch.envs.box2d.bipedal_walker import _terrain_heights

pytest.importorskip("Box2D")
gymnasium = pytest.importorskip("gymnasium")

torch.set_num_threads(1)

FPS = 50.0
SPEED_HIP = 4.0


def _split(seed, n):
  """``jax.random.split(jax.random.PRNGKey(seed), n)``, as ``[n, 2]`` keys."""
  return prng.split(prng.prng_key(seed), n)



def _vy_slope(obs_list):
  vy = np.asarray([o[3] for o in obs_list])
  return np.mean(np.diff(vy))


def _ll_ref_rollout(action, steps, seed=0):
  env = gymnasium.make("LunarLander-v3").unwrapped
  obs, _ = env.reset(seed=seed)
  out = [obs]
  for _ in range(steps):
    obs, *_ , = env.step(action)
    out.append(obs)
  return out


def _ll_our_rollout(action, steps, seed=0, num_envs=8):
  env = envpool_torch.make_gymnasium(
    "LunarLander-v2", num_envs=num_envs, seed=seed, device="cpu"
  )
  obs, _ = env.reset()
  out = [obs]
  acts = np.full(num_envs, action, np.int32)
  for _ in range(steps):
    obs, rew, term, trunc, _ = env.step(acts)
    out.append(obs)
  return out


def test_lunar_lander_freefall_gravity_slope_matches_box2d() -> None:
  ref = [_ll_ref_rollout(0, 10, seed=s) for s in range(4)]
  ours = _ll_our_rollout(0, 10)
  slope_ref = np.mean([_vy_slope(r) for r in ref])
  ours_arr = np.stack(ours)            # [T, n, 8]
  slope_ours = np.mean(np.diff(ours_arr[:, :, 3], axis=0))
  # same gravity, same dt, same obs scaling -> slopes agree closely
  assert abs(slope_ours - slope_ref) < 0.15 * abs(slope_ref), (
    slope_ours, slope_ref
  )


def test_lunar_lander_main_engine_authority_matches_box2d() -> None:
  ref_off = np.mean([_vy_slope(_ll_ref_rollout(0, 10, seed=s))
                     for s in range(4)])
  ref_on = np.mean([_vy_slope(_ll_ref_rollout(2, 10, seed=s))
                    for s in range(4)])
  ours_off = np.mean(np.diff(
    np.stack(_ll_our_rollout(0, 10))[:, :, 3], axis=0
  ))
  ours_on = np.mean(np.diff(
    np.stack(_ll_our_rollout(2, 10))[:, :, 3], axis=0
  ))
  lift_ref = ref_on - ref_off
  lift_ours = ours_on - ours_off
  # engine thrust effect within 25% (dispersion noise + different RNG)
  assert lift_ref > 0 and lift_ours > 0
  assert abs(lift_ours - lift_ref) < 0.25 * lift_ref, (
    lift_ours, lift_ref
  )


def test_lunar_lander_random_policy_outcomes_same_regime() -> None:
  # reference: fraction of no-control episodes ending in crash (-100)
  ref_crashes = 0
  n_ref = 10
  for s in range(n_ref):
    env = gymnasium.make("LunarLander-v3").unwrapped
    env.reset(seed=100 + s)
    for _ in range(300):
      _, r, term, trunc, _ = env.step(0)
      if term or trunc:
        ref_crashes += float(r) < -50
        break
  env = envpool_torch.make_gymnasium(
    "LunarLander-v2", num_envs=32, seed=9, device="cpu"
  )
  env.reset()
  done = np.zeros(32, bool)
  crashed = np.zeros(32, bool)
  for _ in range(300):
    _, r, term, trunc, _ = env.step(np.zeros(32, np.int32))
    newly = (term | trunc) & ~done
    crashed |= newly & (r < -50)
    done |= term | trunc
  ref_rate = ref_crashes / n_ref
  our_rate = crashed.sum() / max(done.sum(), 1)
  assert abs(our_rate - ref_rate) < 0.4, (our_rate, ref_rate)



def _ref_env(seed=0, hardcore=False):
  name = "BipedalWalkerHardcore-v3" if hardcore else "BipedalWalker-v3"
  env = gymnasium.make(name).unwrapped
  obs, _ = env.reset(seed=seed)
  return env, obs


def _our_env(num_envs=8, seed=0, task="BipedalWalker-v3"):
  env = envpool_torch.make_gymnasium(
    task, num_envs=num_envs, seed=seed, device="cpu"
  )
  obs, _ = env.reset()
  return env, obs


def test_bipedal_walker_terrain_statistics_match_box2d() -> None:
  """Grass random-walk heightfield: same mean / roughness as Box2D's.

  The reference terrain generator (`bipedal_walker_env.cc:109-200`) is the
  gym state machine; ours reproduces the recurrence exactly, so mean and
  std of terrain_y must agree across seeds.
  """
  ref_means, ref_stds = [], []
  for s in range(6):
    env, _ = _ref_env(seed=s)
    ty = np.asarray(env.terrain_y if hasattr(env, "terrain_y") else
                    [p[1] for p in env.terrain_poly])
    ref_means.append(ty.mean())
    ref_stds.append(ty.std())
  ours = _terrain_heights(_split(0, 16), False).numpy()
  assert abs(ours.mean() - np.mean(ref_means)) < 0.1, (
    ours.mean(), np.mean(ref_means)
  )
  assert abs(ours.std(1).mean() - np.mean(ref_stds)) < 0.06, (
    ours.std(1).mean(), np.mean(ref_stds)
  )


def test_bipedal_walker_reset_lidar_geometry_matches_box2d() -> None:
  """The 10 lidar fractions at reset trace the same ray geometry.

  Standing on near-flat startpad terrain, each ray's hit fraction is a
  deterministic function of hull height and the ray table
  (`bipedal_walker_env.cc:317-321`); per-ray agreement within 0.1.
  """
  ref = np.mean(
    [_ref_env(seed=s)[1][14:24] for s in range(4)], axis=0
  )
  _, obs = _our_env(num_envs=16)
  ours = obs[:, 14:24].mean(0)
  assert np.all(np.abs(ours - ref) < 0.1), (ours, ref)
  # both saturate (no hit) on the most-backward rays
  assert ref[-1] == 1.0 and ours[-1] == 1.0
  # monotone increasing profile in both (rays sweep from down to back)
  assert np.all(np.diff(ref) > -1e-6) and np.all(np.diff(ours) > -1e-6)


def test_bipedal_walker_standing_stability_matches_box2d() -> None:
  """Zero action for 20 steps: neither walker falls; hull stays level."""
  env, obs = _ref_env(seed=0)
  term = False
  for _ in range(20):
    obs, r, term, trunc, _ = env.step(np.zeros(4, np.float32))
    assert not term
  ref_hull_angle = abs(obs[0])

  env, obs = _our_env(num_envs=8)
  for _ in range(20):
    obs, r, term, trunc, _ = env.step(np.zeros((8, 4), np.float32))
    assert not np.any(term)
  assert np.all(np.abs(obs[:, 0]) < 0.2)
  assert ref_hull_angle < 0.2


def test_bipedal_walker_hip_motor_speed_control_matches_box2d() -> None:
  """Full hip1 action: joint tracks SPEED_HIP under speed control.

  The reference clamps motor speed to ``SPEED_HIP * sign(a)`` with torque
  budget ``MOTORS_TORQUE * |a|`` (`bipedal_walker_env.cc:287-300`), so the
  hip angle advances ~SPEED_HIP/FPS = 0.08 rad/step once saturated; our
  speed-controlled torque law must land in the same band.
  """
  env, _ = _ref_env(seed=1)
  a = np.array([1, 0, 0, 0], np.float32)
  ref_ang, ref_vel = [], []
  for _ in range(12):
    obs, *_ = env.step(a)
    ref_ang.append(obs[4])
    ref_vel.append(obs[5])
  ref_slope = np.mean(np.diff(ref_ang[3:]))

  env, _ = _our_env(num_envs=8, seed=1)
  aa = np.tile(a, (8, 1))
  our_ang, our_vel = [], []
  for _ in range(12):
    obs, *_ = env.step(aa)
    our_ang.append(obs[:, 4].mean())
    our_vel.append(obs[:, 5].mean())
  our_slope = np.mean(np.diff(our_ang[3:]))

  # saturated advance rate within 35% of Box2D's (0.08 rad/step nominal)
  assert ref_slope > 0 and our_slope > 0
  assert abs(our_slope - ref_slope) < 0.35 * ref_slope, (
    our_slope, ref_slope
  )
  # normalized joint speed near saturation (=1.0) in both
  assert np.mean(ref_vel[3:]) > 0.6
  assert np.mean(our_vel[3:]) > 0.6


def test_bipedal_walker_torque_cost_scale_matches_box2d() -> None:
  """Per-step reward for pure torque (no progress) has the same scale.

  Reward = shaping delta - 0.00035 * 80 * sum|a| (:332-339). Standing
  still with zero action must cost ~0 in both; the first steps' rewards
  are small and not -100.
  """
  env, _ = _ref_env(seed=0)
  ref_r = [env.step(np.zeros(4, np.float32))[1] for _ in range(10)]
  env, _ = _our_env(num_envs=4)
  our_r = np.stack(
    [env.step(np.zeros((4, 4), np.float32))[1] for _ in range(10)]
  )
  assert np.all(np.abs(ref_r) < 1.0)
  assert np.all(np.abs(our_r) < 1.0)


def test_bipedal_walker_random_policy_outcome_regime_matches_box2d() -> None:
  """Random actions make the walker fall (-100) well before 300 steps."""
  rng = np.random.default_rng(0)
  falls = 0
  n_ref = 6
  for s in range(n_ref):
    env, _ = _ref_env(seed=20 + s)
    for t in range(300):
      a = rng.uniform(-1, 1, 4).astype(np.float32)
      _, r, term, trunc, _ = env.step(a)
      if term:
        falls += r < -50
        break
  ref_rate = falls / n_ref

  env, _ = _our_env(num_envs=32, seed=7)
  done = np.zeros(32, bool)
  fell = np.zeros(32, bool)
  for t in range(300):
    a = rng.uniform(-1, 1, (32, 4)).astype(np.float32)
    _, r, term, trunc, _ = env.step(a)
    newly = term & ~done
    fell |= newly & (r < -50)
    done |= term | trunc
  our_rate = fell.sum() / 32
  # both in the "mostly falls" regime
  assert ref_rate > 0.5 and our_rate > 0.5, (ref_rate, our_rate)


def test_bipedal_walker_hardcore_terrain_rougher_in_both() -> None:
  """Hardcore obstacles raise terrain variance vs normal in both."""
  env, _ = _ref_env(seed=0, hardcore=True)
  ty_hc = np.asarray(env.terrain_y if hasattr(env, "terrain_y") else
                     [p[1] for p in env.terrain_poly])
  env, _ = _ref_env(seed=0, hardcore=False)
  ty_n = np.asarray(env.terrain_y if hasattr(env, "terrain_y") else
                    [p[1] for p in env.terrain_poly])
  keys = _split(3, 8)
  ours_hc = _terrain_heights(keys, True).numpy()
  ours_n = _terrain_heights(keys, False).numpy()
  assert ty_hc.std() > ty_n.std()
  assert ours_hc.std(1).mean() > ours_n.std(1).mean()
