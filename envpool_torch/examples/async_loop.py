"""Async send/recv loop over the port (the port's ``examples/async_loop.py``).

recv returns the first batch_size finishers; send re-queues exactly those
env ids (``envpool/python/envpool.py:122-133`` contract). ``Ant-v4`` is a
host-tier id: it needs the ``mujoco`` package.

Run:  python -m envpool_torch.examples.async_loop
"""

import argparse
from typing import Optional, Sequence

import numpy as np

import envpool_torch


def main(argv: Optional[Sequence[str]] = None) -> float:
  p = argparse.ArgumentParser()
  p.add_argument("--rounds", type=int, default=500)
  p.add_argument("--device", type=str, default="cuda",
                 help="the pool's device (the host API returns numpy)")
  args = p.parse_args(argv)

  num_envs, batch_size = 64, 16
  env = envpool_torch.make_gymnasium(
    "Ant-v4", num_envs=num_envs, batch_size=batch_size, num_threads=8,
    seed=0, device=args.device,
  )
  env.async_reset()
  returns = np.zeros(num_envs)
  for it in range(args.rounds):
    obs, rew, term, trunc, info = env.recv()
    ids = info["env_id"]
    returns[ids] += rew
    action = np.random.uniform(-1, 1, (batch_size, 8))
    env.send(action, env_id=ids)
  print("mean return so far:", returns.mean())
  return float(returns.mean())


if __name__ == "__main__":
  main()
