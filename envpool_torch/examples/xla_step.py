"""Functional env stepping over the port (the port's ``examples/xla_step.py``).

``env.xla()`` returns pure ``(handle, recv, send, step)`` functions whose
state and outputs stay on the pool's device. As the JAX script runs the loop
as one ``lax.scan`` inside a compiled program, this one runs it through
``graph.scan``: on the card one step is captured as a CUDA graph and
replayed ``--num-steps`` times; on the CPU the same step runs in a loop.
Nothing is copied to the host until the end.

Run:  python -m envpool_torch.examples.xla_step
"""

import argparse
from typing import Optional, Sequence

import torch

import envpool_torch
from envpool_torch.core import graph


def main(argv: Optional[Sequence[str]] = None) -> float:
  p = argparse.ArgumentParser()
  p.add_argument("--num-envs", type=int, default=4096)
  p.add_argument("--num-steps", type=int, default=1000)
  p.add_argument("--device", type=str, default="cuda")
  args = p.parse_args(argv)

  env = envpool_torch.make_gymnasium(
    "CartPole-v1", num_envs=args.num_envs, seed=0, device=args.device
  )
  env.reset()
  handle, recv, send, step = env.xla()
  obs_idx = env._state_keys.index("obs")
  reward_idx = env._state_keys.index("reward")

  def policy(states):
    # a trivial "policy": push right when the pole leans right
    return (states[obs_idx][:, 2] > 0).to(torch.int32)

  def body(handle):
    handle, states = recv(handle)
    handle = send(handle, policy(states))
    return handle, states[reward_idx]

  handle, rewards = graph.scan(body, handle, args.num_steps)
  mean = float(rewards.mean())
  print("mean reward per step:", mean)
  return mean


if __name__ == "__main__":
  main()
