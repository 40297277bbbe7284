"""Tianshou integration over the port (the port's
``examples/tianshou_example.py``, the counterpart of the reference's
``examples/tianshou_examples/cartpole_ppo.py``).

Tianshou's ``BaseVectorEnv`` protocol is the batched gymnasium dialect:
``reset`` / ``step(actions, ids)`` over env-id subsets. The adapter maps it
onto a port pool (partial ``env_id`` steps use the engine's masked
path), so tianshou's trainers run unchanged. With ``tianshou`` installed
the script trains its PPO; without it, it drives the adapter on its own:
a reset, steps of every env and of the subset ``id=[1, 3]``.

Run:  python -m envpool_torch.examples.tianshou_example --task CartPole-v1
"""

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

import envpool_torch


class TianshouVectorEnvAdapter:
  """Port pool -> tianshou ``BaseVectorEnv`` duck type."""

  def __init__(self, env):
    self.env = env
    self.env_num = len(env)
    self.is_async = False

  def __len__(self):
    return self.env_num

  def reset(self, id=None, **kwargs):
    if id is None:
      return self.env.reset()
    return self.env.reset(np.asarray(id, np.int32))

  def step(self, action, id=None):
    if id is None:
      return self.env.step(np.asarray(action))
    return self.env.step(np.asarray(action), env_id=np.asarray(id, np.int32))

  @property
  def observation_space(self):
    return self.env.observation_space  # needs gymnasium, as the library does

  @property
  def action_space(self):
    return self.env.action_space

  def close(self):
    pass


def drive(envs: TianshouVectorEnvAdapter, steps: int) -> Dict[str, float]:
  """The adapter alone: every env for ``steps`` steps, then the subset
  ``[1, 3]`` reset and stepped."""
  rng = np.random.default_rng(0)
  spec = envs.env.spec.action_array_spec["action"]
  n_act = int(spec.maximum) - int(spec.minimum) + 1
  obs, info = envs.reset()
  total = 0.0
  for _ in range(steps):
    obs, rew, term, trunc, info = envs.step(
      rng.integers(0, n_act, len(envs)).astype(np.int32))
    total += float(np.sum(rew))
  ids = [1, 3]
  sub_obs, sub_info = envs.reset(ids)
  assert list(sub_info["env_id"]) == ids, sub_info["env_id"]
  sub_obs, rew, term, trunc, sub_info = envs.step(np.zeros(len(ids), np.int32), ids)
  assert list(sub_info["env_id"]) == ids and sub_obs.shape[0] == len(ids)
  return {"mean_reward": total / (steps * len(envs)), "subset_rows": sub_obs.shape[0]}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
  p = argparse.ArgumentParser()
  p.add_argument("--task", type=str, default="CartPole-v1")
  p.add_argument("--num-envs", type=int, default=10)
  p.add_argument("--epochs", type=int, default=3)
  p.add_argument("--steps", type=int, default=50,
                 help="steps of the standalone drive, without tianshou")
  p.add_argument("--device", type=str, default="cuda",
                 help="the pool's device (the adapter hands tianshou numpy)")
  args = p.parse_args(argv)

  envs = TianshouVectorEnvAdapter(envpool_torch.make_gymnasium(
    args.task, num_envs=args.num_envs, seed=0, device=args.device))
  try:
    import torch
    from tianshou.data import Collector, VectorReplayBuffer
    from tianshou.policy import PPOPolicy
    from tianshou.trainer import OnpolicyTrainer
    from tianshou.utils.net.common import ActorCritic, Net
    from tianshou.utils.net.discrete import Actor, Critic
  except ImportError as e:
    res = drive(envs, args.steps)
    print(f"tianshou is not installed ({e}); the adapter alone: {args.steps} "
          f"steps of {len(envs)} envs, mean reward {res['mean_reward']:.4f}; the "
          f"subset reset and stepped, {res['subset_rows']} rows")
    return res

  obs_shape = envs.observation_space.shape
  act_n = envs.action_space.n
  net = Net(obs_shape, hidden_sizes=[64, 64])
  actor = Actor(net, act_n)
  critic = Critic(Net(obs_shape, hidden_sizes=[64, 64]))
  optim = torch.optim.Adam(ActorCritic(actor, critic).parameters(), lr=3e-4)
  policy = PPOPolicy(
    actor=actor, critic=critic, optim=optim,
    dist_fn=torch.distributions.Categorical, action_space=envs.action_space,
  )
  collector = Collector(policy, envs, VectorReplayBuffer(20000, args.num_envs))
  result = OnpolicyTrainer(
    policy=policy, train_collector=collector, max_epoch=args.epochs,
    step_per_epoch=10000, repeat_per_collect=4, episode_per_test=0,
    batch_size=256, step_per_collect=2000,
  ).run()
  print(result)
  return {}


if __name__ == "__main__":
  main()
