"""The port's twin of ``tests/test_determinism.py`` (CPU pools), with the
Box2D and the on-device MuJoCo ids added (of the contact ids HalfCheetah,
Hopper and Pusher; of the dm_control ids CheetahJaxRun-v1,
BallInCupJaxCatch-v1, ManipulatorJaxInsertPeg-v1 and
HumanoidCMUJaxStand-v1, whose observations are dicts, compared key by key):
the same seed gives identical trajectories, another seed a different one.
Mirrors ``envpool/box2d/box2d_deterministic_test.py:28-44``.
"""

import numpy as np
import pytest
import torch

import envpool_torch

torch.set_num_threads(1)

# (task id, steps): the Box2D walkers and the MuJoCo ids take fewer steps,
# their eager steps are the slowest on the CPU
TASKS = [
  ("CartPole-v1", 200), ("Pendulum-v1", 200), ("MountainCar-v0", 200),
  ("MountainCarContinuous-v0", 200), ("Acrobot-v1", 200),
  ("LunarLander-v2", 200), ("LunarLanderContinuous-v2", 200),
  ("BipedalWalker-v3", 60), ("BipedalWalkerHardcore-v3", 60),
  ("ReacherJax-v4", 20), ("InvertedPendulumJax-v4", 20),
  ("InvertedDoublePendulumJax-v4", 20), ("SwimmerJax-v4", 20),
  ("HalfCheetahJax-v4", 10), ("HopperJax-v4", 10),
  ("CheetahJaxRun-v1", 10), ("BallInCupJaxCatch-v1", 10),
  ("PusherJax-v4", 10), ("ManipulatorJaxInsertPeg-v1", 3),
  ("HumanoidCMUJaxStand-v1", 2),
]


def _rollout(task: str, seed: int, steps: int) -> np.ndarray:
  num_envs = 4
  env = envpool_torch.make_gymnasium(task, num_envs=num_envs, seed=seed, device="cpu")
  env.reset()
  act_space = env.action_space
  rng = np.random.RandomState(0)
  obs_sum = []
  for _ in range(steps):
    if hasattr(act_space, "n"):
      act = rng.randint(0, act_space.n, num_envs).astype(np.int32)
    else:
      act = rng.uniform(
        act_space.low, act_space.high, (num_envs, *act_space.shape)
      ).astype(np.float32)
    obs, rew, term, trunc, info = env.step(act)
    if isinstance(obs, dict):
      obs = np.concatenate([obs[k].reshape(num_envs, -1) for k in sorted(obs)], 1)
    obs_sum.append(obs.copy())
  return np.stack(obs_sum)


@pytest.mark.parametrize("task,steps", TASKS)
def test_deterministic(task: str, steps: int) -> None:
  t0 = _rollout(task, seed=0, steps=steps)
  t1 = _rollout(task, seed=0, steps=steps)
  t2 = _rollout(task, seed=1, steps=steps)
  np.testing.assert_array_equal(t0, t1)
  assert np.abs(t0 - t2).sum() > 0
