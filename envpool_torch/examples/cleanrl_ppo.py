"""CleanRL-style PyTorch PPO on a port pool (the port's
``examples/cleanrl_ppo.py``, the counterpart of the reference's
``examples/cleanrl_examples/ppo_atari_envpool.py``).

Drop-in compatibility for torch users: the batched pool is consumed
through the gymnasium dialect exactly like envpool's (the same
``envs.step(actions)`` 5-tuple, the same ``info["env_id"]``), with a
cleanrl-style episode-statistics wrapper on top. The pool and the agent
run on ``--device`` (default: the CUDA device); the dialect hands numpy to
the agent, which moves it to its device, as cleanrl does.

Solves CartPole in ~30 iterations:

  python -m envpool_torch.examples.cleanrl_ppo --num-envs 16 --iterations 40
"""

import argparse
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.distributions.categorical import Categorical

import envpool_torch


class RecordEpisodeStatistics:
  """The cleanrl batched-episode-stats wrapper, gymnasium dialect."""

  def __init__(self, env):
    self.env = env
    self.num_envs = len(env)
    self.returns = np.zeros(self.num_envs)
    self.lengths = np.zeros(self.num_envs, dtype=np.int64)
    self.finished = deque(maxlen=100)

  def reset(self):
    obs, info = self.env.reset()
    self.returns[:] = 0.0
    self.lengths[:] = 0
    return obs, info

  def step(self, action):
    obs, rew, term, trunc, info = self.env.step(action)
    self.returns += rew
    self.lengths += 1
    done = np.asarray(term) | np.asarray(trunc)
    for i in np.flatnonzero(done):
      self.finished.append((self.returns[i], self.lengths[i]))
      self.returns[i] = 0.0
      self.lengths[i] = 0
    return obs, rew, term, trunc, info


def num_actions(env) -> int:
  """The discrete action count, from the spec (the gymnasium spaces need
  the ``gymnasium`` package, which the card's machine lacks)."""
  a = env.spec.action_array_spec["action"]
  return int(a.maximum) - int(a.minimum) + 1


def layer_init(layer, std=np.sqrt(2), bias_const=0.0):
  nn.init.orthogonal_(layer.weight, std)
  nn.init.constant_(layer.bias, bias_const)
  return layer


class Agent(nn.Module):

  def __init__(self, obs_dim, act_n):
    super().__init__()
    self.critic = nn.Sequential(
      layer_init(nn.Linear(obs_dim, 64)), nn.Tanh(),
      layer_init(nn.Linear(64, 64)), nn.Tanh(),
      layer_init(nn.Linear(64, 1), std=1.0),
    )
    self.actor = nn.Sequential(
      layer_init(nn.Linear(obs_dim, 64)), nn.Tanh(),
      layer_init(nn.Linear(64, 64)), nn.Tanh(),
      layer_init(nn.Linear(64, act_n), std=0.01),
    )

  def get_value(self, x):
    return self.critic(x)

  def get_action_and_value(self, x, action=None):
    logits = self.actor(x)
    probs = Categorical(logits=logits)
    if action is None:
      action = probs.sample()
    return action, probs.log_prob(action), probs.entropy(), self.critic(x)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
  p = argparse.ArgumentParser()
  p.add_argument("--task", type=str, default="CartPole-v1")
  p.add_argument("--num-envs", type=int, default=16)
  p.add_argument("--num-steps", type=int, default=128)
  p.add_argument("--iterations", type=int, default=40)
  p.add_argument("--lr", type=float, default=2.5e-4)
  p.add_argument("--gamma", type=float, default=0.99)
  p.add_argument("--gae-lambda", type=float, default=0.95)
  p.add_argument("--clip-coef", type=float, default=0.2)
  p.add_argument("--ent-coef", type=float, default=0.01)
  p.add_argument("--update-epochs", type=int, default=4)
  p.add_argument("--num-minibatches", type=int, default=4)
  p.add_argument("--seed", type=int, default=1)
  p.add_argument("--device", type=str, default="cuda",
                 help="the pool's and the agent's device")
  args = p.parse_args(argv)

  torch.manual_seed(args.seed)
  rng = np.random.default_rng(args.seed)
  device = torch.device(args.device)
  envs = RecordEpisodeStatistics(envpool_torch.make_gymnasium(
    args.task, num_envs=args.num_envs, seed=args.seed, device=device
  ))
  next_obs_np, _ = envs.reset()
  obs_dim = int(np.prod(next_obs_np.shape[1:]))
  act_n = num_actions(envs.env)
  agent = Agent(obs_dim, act_n).to(device)
  optimizer = torch.optim.Adam(agent.parameters(), lr=args.lr, eps=1e-5)

  n, t = args.num_envs, args.num_steps
  obs_buf = torch.zeros((t, n, obs_dim), device=device)
  act_buf = torch.zeros((t, n), dtype=torch.long, device=device)
  logp_buf = torch.zeros((t, n), device=device)
  rew_buf = torch.zeros((t, n), device=device)
  done_buf = torch.zeros((t, n), device=device)
  val_buf = torch.zeros((t, n), device=device)

  def to_device(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

  next_obs = to_device(next_obs_np).reshape(n, obs_dim)
  next_done = torch.zeros(n, device=device)
  start = time.time()
  history = []

  for it in range(args.iterations):
    for step in range(t):
      obs_buf[step] = next_obs
      done_buf[step] = next_done
      with torch.no_grad():
        action, logp, _, value = agent.get_action_and_value(next_obs)
      val_buf[step] = value.flatten()
      act_buf[step] = action
      logp_buf[step] = logp
      o, r, term, trunc, _ = envs.step(action.cpu().numpy().astype(np.int32))
      rew_buf[step] = to_device(r)
      next_obs = to_device(o).reshape(n, obs_dim)
      next_done = to_device(np.asarray(term) | np.asarray(trunc))

    with torch.no_grad():
      next_value = agent.get_value(next_obs).flatten()
      advantages = torch.zeros_like(rew_buf)
      lastgaelam = 0
      for s in reversed(range(t)):
        nextnonterm = 1.0 - (next_done if s == t - 1 else done_buf[s + 1])
        nextval = next_value if s == t - 1 else val_buf[s + 1]
        delta = rew_buf[s] + args.gamma * nextval * nextnonterm - val_buf[s]
        lastgaelam = delta + args.gamma * args.gae_lambda * nextnonterm * lastgaelam
        advantages[s] = lastgaelam
      returns = advantages + val_buf

    b_obs = obs_buf.reshape(-1, obs_dim)
    b_act = act_buf.reshape(-1)
    b_logp = logp_buf.reshape(-1)
    b_adv = advantages.reshape(-1)
    b_ret = returns.reshape(-1)
    batch = n * t
    mb = batch // args.num_minibatches
    idx = np.arange(batch)
    for _ in range(args.update_epochs):
      rng.shuffle(idx)
      for s in range(0, batch, mb):
        mbi = torch.as_tensor(idx[s:s + mb], device=device)
        _, newlogp, entropy, newval = agent.get_action_and_value(b_obs[mbi], b_act[mbi])
        ratio = (newlogp - b_logp[mbi]).exp()
        adv = b_adv[mbi]
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        pg1 = -adv * ratio
        pg2 = -adv * torch.clamp(ratio, 1 - args.clip_coef, 1 + args.clip_coef)
        pg_loss = torch.max(pg1, pg2).mean()
        v_loss = 0.5 * ((newval.flatten() - b_ret[mbi]) ** 2).mean()
        loss = pg_loss - args.ent_coef * entropy.mean() + v_loss
        optimizer.zero_grad()
        loss.backward()
        nn.utils.clip_grad_norm_(agent.parameters(), 0.5)
        optimizer.step()

    sps = (it + 1) * n * t / (time.time() - start)
    row = {"episodes": len(envs.finished), "sps": sps, "v_loss": float(v_loss.detach())}
    if envs.finished:
      row["episodic_return"] = float(np.mean([r for r, _ in envs.finished]))
      ret = f"{row['episodic_return']:7.1f}"
    else:
      ret = "    n/a"  # no episode has ended yet
    history.append(row)
    print(f"iter {it:3d}  episodic_return={ret}  episodes={row['episodes']}  "
          f"v_loss={row['v_loss']:.4f}  SPS={sps:,.0f}", flush=True)
  return history


if __name__ == "__main__":
  main()
