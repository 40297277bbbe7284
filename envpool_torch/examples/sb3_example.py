"""Stable-Baselines3 integration over the port (the port's
``examples/sb3_example.py``, the counterpart of the reference's
``examples/sb3_examples``): the batched pool wrapped as an SB3 ``VecEnv``.

``step_wait`` returns one info dict per env, as SB3 expects. The pool's
info holds nested dicts (``players``, with its own per-env arrays), and
each is indexed per env too: the JAX package's script indexes ``v[i]`` on
the nested dict itself and raises ``KeyError: 0`` at its first step.

The script drives the adapter on its own; with ``stable_baselines3``
installed, ``PPO("MlpPolicy", env)`` can take it (not run here).

Run:  python -m envpool_torch.examples.sb3_example
"""

import argparse
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

import envpool_torch


def env_info(info: Dict[str, Any], i: int) -> Dict[str, Any]:
  """Env ``i``'s info: every array indexed at ``i``, nested dicts too."""
  return {k: env_info(v, i) if isinstance(v, dict) else v[i] for k, v in info.items()}


class EnvPoolVecAdapter:
  """Minimal SB3 VecEnv adapter over a gymnasium-dialect pool."""

  def __init__(self, env):
    self.env = env
    self.num_envs = len(env)
    self._actions = None

  def reset(self):
    obs, _ = self.env.reset()
    return obs

  def step_async(self, actions):
    self._actions = actions

  def step_wait(self):
    obs, rew, term, trunc, info = self.env.step(np.asarray(self._actions))
    done = term | trunc
    infos: List[Dict[str, Any]] = [env_info(info, i) for i in range(self.num_envs)]
    return obs, rew, done, infos

  @property
  def observation_space(self):
    return self.env.observation_space  # needs gymnasium, as the library does

  @property
  def action_space(self):
    return self.env.action_space

  def close(self):
    pass


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
  p = argparse.ArgumentParser()
  p.add_argument("--task", type=str, default="CartPole-v1")
  p.add_argument("--num-envs", type=int, default=16)
  p.add_argument("--steps", type=int, default=100)
  p.add_argument("--device", type=str, default="cuda",
                 help="the pool's device (the adapter hands SB3 numpy)")
  args = p.parse_args(argv)

  env = EnvPoolVecAdapter(envpool_torch.make_gymnasium(
    args.task, num_envs=args.num_envs, seed=0, device=args.device))
  rng = np.random.default_rng(0)
  spec = env.env.spec.action_array_spec["action"]
  n_act = int(spec.maximum) - int(spec.minimum) + 1
  obs = env.reset()
  total, dones = 0.0, 0
  for _ in range(args.steps):
    env.step_async(rng.integers(0, n_act, env.num_envs).astype(np.int32))
    obs, rew, done, infos = env.step_wait()
    total += float(np.sum(rew))
    dones += int(np.sum(done))
  assert len(infos) == env.num_envs and all(
    infos[i]["env_id"] == i for i in range(env.num_envs)), infos[:2]
  res = {"steps": args.steps, "mean_reward": total / (args.steps * env.num_envs),
         "episodes_ended": dones}
  print(f"adapter round-trip OK: {args.steps} steps of {env.num_envs} envs, obs "
        f"{tuple(obs.shape)}, mean reward {res['mean_reward']:.4f}, "
        f"{dones} episodes ended, one dict per env with keys {sorted(infos[0])}")
  # with stable_baselines3 installed:
  #   from stable_baselines3 import PPO
  #   model = PPO("MlpPolicy", env); model.learn(100_000)
  return res


if __name__ == "__main__":
  main()
