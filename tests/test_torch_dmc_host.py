"""The port's dm_control host tier (``envpool_torch/envs/mujoco/dmc/
domains.py`` over ``base.py`` on the ``HostEnvPool``) on the CPU: the twins
of ``tests/test_dmc.py``, the port's host ``tolerance`` against the JAX
package's, and all 37 host ids against the JAX package, 2 envs x 5 steps,
every output field bit for bit (the same numpy code over the same
``mj_step``)."""

import math

import numpy as np
import pytest

import envpool_torch
import envpool_tpu
from envpool_torch.envs.mujoco.dmc import rewards
from envpool_torch.envs.mujoco.dmc.rewards import (
  COSINE,
  GAUSSIAN,
  LINEAR,
  LONG_TAIL,
  QUADRATIC,
  tolerance,
)
from envpool_tpu.envs.mujoco.dmc import rewards as jax_rewards

from _torch_host import assert_outputs_equal, host_rollout, uniform_actions

DMC_TASKS = [
  ("PendulumSwingup-v1", 1),
  ("CartpoleBalance-v1", 1),
  ("CartpoleBalanceSparse-v1", 1),
  ("CartpoleSwingup-v1", 1),
  ("CartpoleSwingupSparse-v1", 1),
  ("CartpoleTwoPoles-v1", 1),
  ("CartpoleThreePoles-v1", 1),
  ("PointMassEasy-v1", 2),
  ("PointMassHard-v1", 2),
  ("ReacherEasy-v1", 2),
  ("ReacherHard-v1", 2),
  ("CheetahRun-v1", 6),
  ("AcrobotSwingup-v1", 1),
  ("AcrobotSwingupSparse-v1", 1),
  ("BallInCupCatch-v1", 2),
  ("HopperStand-v1", 4),
  ("HopperHop-v1", 4),
  ("WalkerStand-v1", 6),
  ("WalkerWalk-v1", 6),
  ("WalkerRun-v1", 6),
  ("FingerSpin-v1", 2),
  ("FingerTurnEasy-v1", 2),
  ("FingerTurnHard-v1", 2),
  ("SwimmerSwimmer6-v1", 5),
  ("SwimmerSwimmer15-v1", 14),
  ("FishUpright-v1", 5),
  ("FishSwim-v1", 5),
  ("HumanoidStand-v1", 21),
  ("HumanoidWalk-v1", 21),
  ("HumanoidRun-v1", 21),
  ("HumanoidRunPureState-v1", 21),
  ("HumanoidCMUStand-v1", 56),
  ("HumanoidCMURun-v1", 56),
  ("ManipulatorBringBall-v1", 5),
  ("ManipulatorBringPeg-v1", 5),
  ("ManipulatorInsertBall-v1", 5),
  ("ManipulatorInsertPeg-v1", 5),
]

# the JAX package's dm_control host ids, in its order
HOST_IDS = [
  t for t, (path, _, _) in envpool_tpu.registration.registry.specs.items()
  if path == "envpool_tpu.envs.mujoco.dmc" and "Jax" not in t
]


def test_the_37_host_ids():
  assert len(HOST_IDS) == 37
  assert sorted(HOST_IDS) == sorted(t for t, _ in DMC_TASKS)
  assert [t for t in envpool_torch.list_all_envs() if t in HOST_IDS] == HOST_IDS


# --------------------------------------------------- twins of test_dmc.py


def test_tolerance_exact():
  # inside bounds -> 1; no margin -> 0 outside
  assert tolerance(0.5, 0.0, 1.0) == 1.0
  assert tolerance(1.5, 0.0, 1.0) == 0.0
  # gaussian: value_at_margin reached exactly at distance margin
  assert math.isclose(tolerance(2.0, 0, 1, 1.0, 0.1, GAUSSIAN), 0.1)
  for sig in (GAUSSIAN, LONG_TAIL, COSINE, LINEAR, QUADRATIC):
    v = tolerance(2.0, 0, 1, 1.0, 0.25, sig)
    assert math.isclose(v, 0.25, rel_tol=1e-9), sig


@pytest.mark.parametrize("task,act_n", DMC_TASKS)
def test_reset_step_reward_range(task, act_n):
  env = envpool_torch.make_dm(task, num_envs=2, seed=0, device="cpu")
  ts = env.reset()
  assert np.all(ts.step_type == 0)
  for _ in range(3):
    ts = env.step({"action": np.zeros((2, act_n))})
  r = np.asarray(ts.reward)
  assert np.all((r >= 0.0) & (r <= 1.0)), task
  assert np.all(np.asarray(ts.discount) == 1.0)


def test_determinism():
  def traj(seed):
    env = envpool_torch.make_gymnasium(
      "CartpoleSwingup-v1", num_envs=3, seed=seed, device="cpu"
    )
    obs, _ = env.reset()
    out = [np.concatenate([obs["position"], obs["velocity"]], -1)]
    for _ in range(10):
      obs, *_ = env.step(np.full((3, 1), 0.3))
      out.append(np.concatenate([obs["position"], obs["velocity"]], -1))
    return np.stack(out)

  np.testing.assert_array_equal(traj(3), traj(3))
  assert not np.array_equal(traj(3), traj(4))


def test_pendulum_swingup_reward_semantics():
  """Hanging pendulum: reward 0; reward 1 requires the pole within 8 deg
  of vertical (pendulum.h:106-108)."""
  env = envpool_torch.make_gymnasium("PendulumSwingup-v1", num_envs=8, seed=1,
                                     device="cpu")
  env.reset()
  rewards_seen = []
  for _ in range(20):
    _, rew, *_ = env.step(np.zeros((8, 1)))
    rewards_seen.append(rew)
  rewards_seen = np.stack(rewards_seen)
  assert np.all((rewards_seen >= 0) & (rewards_seen <= 1))
  assert rewards_seen.mean() < 0.5


def test_time_limit_gives_discount_one():
  env = envpool_torch.make_dm("PointMassEasy-v1", num_envs=1, seed=0,
                              max_episode_steps=5, device="cpu")
  env.reset()
  for _ in range(4):
    ts = env.step({"action": np.zeros((1, 2))})
  ts = env.step({"action": np.zeros((1, 2))})
  assert ts.step_type[0] == 2
  # dm_control: time-limit termination keeps discount 1 (control.py:94)
  assert ts.discount[0] == 1.0


def test_humanoid_cmu_structure():
  """CMU skeleton invariants (humanoid_CMU.h:48-63): 56 joint angles, 62
  velocities, 12 extremity coords; episodes start from random poses."""
  env = envpool_torch.make_dm("HumanoidCMUStand-v1", num_envs=2, seed=0,
                              device="cpu")
  ts = env.reset()
  o = ts.observation
  assert o.joint_angles.shape == (2, 56)
  assert o.velocity.shape == (2, 62)
  assert o.extremities.shape == (2, 12)
  assert o.head_height.shape == (2,)
  assert o.torso_vertical.shape == (2, 3)
  assert o.com_velocity.shape == (2, 3)
  assert not np.allclose(o.joint_angles[0], o.joint_angles[1])


def test_humanoid_cmu_reward_prefers_standing():
  env = envpool_torch.make_dm("HumanoidCMUStand-v1", num_envs=1, seed=2,
                              device="cpu")
  env.reset()
  seen = []
  for _ in range(30):
    ts = env.step({"action": np.zeros((1, 56))})
    seen.append(float(ts.reward[0]))
  assert min(seen) >= 0.0 and max(seen) <= 1.0


# ---------------------------------------------------- against the JAX package


def test_tolerance_matches_jax_package():
  rng = np.random.default_rng(0)
  sigmoids = [getattr(rewards, n) for n in (
    "GAUSSIAN", "HYPERBOLIC", "LONG_TAIL", "RECIPROCAL", "COSINE", "LINEAR",
    "QUADRATIC", "TANH_SQUARED",
  )]
  for x in rng.uniform(-3, 3, 64).tolist():
    for sig in sigmoids:
      for margin, vam in ((0.0, 0.1), (0.7, 0.1), (2.0, 0.25)):
        args = (x, -0.5, 0.5, margin, vam, sig)
        assert tolerance(*args) == jax_rewards.tolerance(*args), args
  with pytest.raises(ValueError):
    tolerance(9.0, 0.0, 1.0, 1.0, 0.1, "nope")


@pytest.mark.parametrize("task_id", HOST_IDS)
def test_host_id_matches_jax_package(task_id):
  kw = dict(num_envs=2, seed=3)
  got_env = envpool_torch.make_gymnasium(task_id, device="cpu", **kw)
  want_env = envpool_tpu.make_gymnasium(task_id, **kw)
  assert got_env.spec.config._replace(base_path="") == \
    want_env.spec.config._replace(base_path="")
  keys = got_env.spec._state_keys
  assert keys == want_env.spec._state_keys
  acts = uniform_actions(got_env.spec, 2, 5, seed=4)
  assert_outputs_equal(keys, host_rollout(got_env, acts),
                       host_rollout(want_env, acts), task_id)
