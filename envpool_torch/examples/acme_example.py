"""dm-acme integration over the port (the port's ``examples/acme_example.py``,
the counterpart of the reference's ``examples/acme_examples/ppo_continuous.py``).

Acme consumes single ``dm_env.Environment`` objects; the reference's
helpers slice its batched pool into per-index views
(``acme_examples/helpers.py``). ``BatchedToSingleDmEnv`` does the same over
a port dm-dialect pool: index i's view steps only env i through the
engine's masked path and returns scalar TimeSteps, its observation
squeezed by the port's ``graph.tree_map`` (the JAX script uses
``jax.tree_util``). The dm dialect needs the ``dm_env`` package. With
``dm-acme`` installed the script runs the view through acme's
``EnvironmentLoop`` with a fixed-action ``acme.core.Actor`` of its own
(acme's agents build their networks on jax or TensorFlow, which the port
does not import); without it, it drives the view through the same
episodes on its own.

Run:  python -m envpool_torch.examples.acme_example --task CartPole-v1
"""

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np

import envpool_torch
from envpool_torch.core.graph import tree_map


class BatchedToSingleDmEnv:
  """One env's dm_env.Environment view over a batched dm-dialect pool."""

  def __init__(self, pool, index: int):
    self.pool = pool
    self.index = np.asarray([index], np.int32)

  def reset(self):
    return self._squeeze(self.pool.reset(self.index))

  def step(self, action):
    ts = self.pool.step({"action": np.asarray(action)[None]}, env_id=self.index)
    return self._squeeze(ts)

  def observation_spec(self):
    return self.pool.observation_spec()

  def action_spec(self):
    return self.pool.action_spec()

  def reward_spec(self):
    return self.pool.reward_spec()

  def discount_spec(self):
    return self.pool.discount_spec()

  @staticmethod
  def _squeeze(ts):
    import dm_env

    return dm_env.TimeStep(
      step_type=dm_env.StepType(int(np.asarray(ts.step_type)[0])),
      reward=float(np.asarray(ts.reward)[0]),
      discount=float(np.asarray(ts.discount)[0]),
      observation=tree_map(lambda x: np.asarray(x)[0], ts.observation),
    )

  def close(self):
    pass


def noop_episodes(env, episodes: int) -> List[Tuple[float, int]]:
  """``episodes`` episodes of the fixed action 0 -> (return, steps) each."""
  import dm_env

  out = []
  for _ in range(episodes):
    ts = env.reset()
    assert ts.step_type == dm_env.StepType.FIRST
    total, steps = 0.0, 0
    while not ts.last():
      ts = env.step(np.int32(0))
      total += ts.reward
      steps += 1
    out.append((total, steps))
  return out


def acme_episodes(env, episodes: int) -> List[Tuple[float, int]]:
  """The same episodes through ``acme.EnvironmentLoop``."""
  import acme
  from acme import core

  class NoopActor(core.Actor):
    """Action 0 at every step; it learns nothing."""

    def select_action(self, observation):
      return np.int32(0)

    def observe_first(self, timestep):
      pass

    def observe(self, action, next_timestep):
      pass

    def update(self, wait: bool = False):
      pass

  loop = acme.EnvironmentLoop(env, NoopActor())
  results = [loop.run_episode() for _ in range(episodes)]
  return [(float(r["episode_return"]), int(r["episode_length"])) for r in results]


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
  p = argparse.ArgumentParser()
  p.add_argument("--task", type=str, default="CartPole-v1")
  p.add_argument("--episodes", type=int, default=3)
  p.add_argument("--device", type=str, default="cuda",
                 help="the pool's device (the view hands acme numpy)")
  args = p.parse_args(argv)

  pool = envpool_torch.make_dm(args.task, num_envs=4, seed=0, device=args.device)
  env = BatchedToSingleDmEnv(pool, 0)
  try:
    import acme  # noqa: F401
  except ImportError as e:
    print(f"dm-acme is not installed ({e}); driving the adapter on its own")
    results = noop_episodes(env, args.episodes)
  else:
    print("dm-acme's EnvironmentLoop over the adapter, a fixed-action actor")
    results = acme_episodes(env, args.episodes)
  for episode, (total, steps) in enumerate(results):
    print(f"episode {episode}: return (noop policy) {total}, {steps} steps")
  return [total for total, _ in results]


if __name__ == "__main__":
  main()
