"""PPO on the port: rollout through the pool's ``xla()`` interface, GAE and
the minibatched clipped-surrogate update, on the pool's device.

The port of ``envpool_tpu/train/ppo.py``, with its semantics: the same
config, the same key stream (``core/prng.py`` reproduces jax's threefry
draws: ``split``, ``categorical``, ``normal``, ``permutation``), the same
loss and metrics, and ``optax.chain(clip_by_global_norm, adam)`` as
``ClipAdam``. Where the JAX package jits one program per iteration, this
runs eagerly: ``lax.scan`` becomes a Python loop over the pool's functional
``send``/``recv``, and the gradient comes from ``torch.autograd``.

Not ported yet: the ``mesh``, ``axis_name`` and ``model_axis`` arguments
(env-sharded data parallelism and tensor-parallel dense kernels); they go
with the sharding port.

Usage::

  pool = envpool_torch.make_gymnasium("Sokoban-v0", num_envs=1024, ...)
  net = SokobanCNN()
  state, tx = ppo_init(pool, net, cfg, seed=0)
  train_step = make_ppo_train_step(pool, net, cfg, tx)
  state, metrics = train_step(state)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from envpool_torch.core import prng
from envpool_torch.core.pool import TorchEnvPool, _torch_dtype

Params = Dict[str, torch.Tensor]


def _gauss_logp(x, mean, log_std):
  """Diagonal-Gaussian log-density, summed over the action dim."""
  z = (x - mean) * torch.exp(-log_std)
  return torch.sum(
    -0.5 * torch.square(z) - log_std - 0.5 * math.log(2 * math.pi), dim=-1
  )


@dataclasses.dataclass(frozen=True)
class PPOConfig:
  num_steps: int = 32          # rollout length T
  continuous: bool = False     # diagonal-Gaussian policy (net returns
                               # ((mean, log_std), value)); actions f32
  gamma: float = 0.99
  gae_lambda: float = 0.95
  clip_eps: float = 0.2
  vf_coef: float = 0.5
  ent_coef: float = 0.01
  lr: float = 2.5e-4
  update_epochs: int = 2
  num_minibatches: int = 4
  max_grad_norm: float = 0.5


class PPOState(NamedTuple):
  handle: Any                  # XlaHandle: the pool state on the device
  params: Params               # the net's state dict
  opt_state: Dict[str, Any]    # ClipAdam's state
  key: torch.Tensor            # [2] threefry key (int64-held uint32)


class ClipAdam:
  """``optax.chain(clip_by_global_norm(max_norm), adam(lr))`` over dicts of
  tensors: the gradient is scaled by ``max_norm / norm`` when its global
  norm reaches ``max_norm``, then Adam (b1 0.9, b2 0.999, eps 1e-8) with
  optax's bias correction; the step count stays on the host."""

  def __init__(self, max_norm: float, lr: float, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8) -> None:
    self.max_norm, self.lr, self.b1, self.b2, self.eps = max_norm, lr, b1, b2, eps

  def init(self, params: Params) -> Dict[str, Any]:
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

  def update(self, grads: Params, opt_state: Dict[str, Any]) -> Tuple[Params, Dict[str, Any]]:
    """-> (updates to add to the params, new state)."""
    names = list(grads)
    g = [grads[k] for k in names]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
    g = torch._foreach_mul(g, torch.clamp(self.max_norm / norm, max=1.0))
    mu = torch._foreach_add(
      torch._foreach_mul([opt_state["mu"][k] for k in names], self.b1),
      g, alpha=1 - self.b1,
    )
    nu = torch._foreach_addcmul(
      torch._foreach_mul([opt_state["nu"][k] for k in names], self.b2),
      g, g, value=1 - self.b2,
    )
    count = opt_state["count"] + 1
    # optax's bias correction, 1 - decay**count in float32
    bc1 = float(1 - np.float32(self.b1) ** np.float32(count))
    bc2 = float(1 - np.float32(self.b2) ** np.float32(count))
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), self.eps)
    upd = torch._foreach_mul(
      torch._foreach_div(torch._foreach_div(mu, bc1), denom), -self.lr
    )
    new_state = {
      "count": count, "mu": dict(zip(names, mu)), "nu": dict(zip(names, nu))
    }
    return dict(zip(names, upd)), new_state


def apply_updates(params: Params, updates: Params) -> Params:
  names = list(params)
  new = torch._foreach_add([params[k] for k in names], [updates[k] for k in names])
  return dict(zip(names, new))


def ppo_init(
  pool: TorchEnvPool, net: nn.Module, cfg: PPOConfig, seed: int = 0
) -> Tuple[PPOState, ClipAdam]:
  """Build the net's parameters (``net.init`` on a zero batch of obs, drawn
  from the threefry stream of ``seed``), the optimizer state, the key (the first
  half of ``split(PRNGKey(seed))``, as the JAX package carries), and
  capture the pool's ``xla()`` handle."""
  handle, _, _, _ = pool.xla()
  obs_spec = pool.spec.state_array_spec["obs"]
  dummy_obs = torch.zeros(
    (int(pool.config["batch_size"]) or int(pool.config["num_envs"]),
     *obs_spec.static_shape),
    dtype=_torch_dtype(obs_spec.dtype), device=pool.device,
  )
  key = prng.split(prng.prng_key(seed, pool.device), 2)[0]
  net.init(dummy_obs, seed)
  params = {k: v.detach().clone() for k, v in net.state_dict().items()}
  tx = ClipAdam(cfg.max_grad_norm, cfg.lr)
  return PPOState(handle, params, tx.init(params), key), tx


def compute_gae(traj: Dict[str, torch.Tensor], last_value: torch.Tensor,
                gamma: float, gae_lambda: float):
  """-> (advantages, returns), both [T, N]: the reverse scan of
  ``ppo.py::compute_gae`` as a loop."""
  not_done = 1.0 - traj["done"].to(torch.float32)
  gae, next_value = torch.zeros_like(last_value), last_value
  adv = []
  for t in reversed(range(traj["reward"].shape[0])):
    delta = traj["reward"][t] + gamma * next_value * not_done[t] - traj["value"][t]
    gae = delta + gamma * gae_lambda * not_done[t] * gae
    adv.append(gae)
    next_value = traj["value"][t]
  adv = torch.stack(adv[::-1])
  return adv, adv + traj["value"]


def ppo_loss(net: nn.Module, cfg: PPOConfig, params: Params,
             batch: Dict[str, torch.Tensor]):
  """-> (total loss, {"pg_loss", "v_loss", "entropy"}) of one minibatch."""
  out, value = functional_call(net, params, (batch["obs"],))
  if cfg.continuous:
    mean, log_std = out
    logp = _gauss_logp(batch["action"], mean, log_std)
    entropy = torch.sum(
      log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1
    ).mean()
  else:
    logp_all = torch.log_softmax(out, dim=-1)
    logp = logp_all.gather(-1, batch["action"][:, None])[:, 0]
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
  ratio = torch.exp(logp - batch["logp"])
  adv = batch["adv"]
  # jnp.std is the population std
  adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
  pg1 = ratio * adv
  pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
  pg_loss = -torch.minimum(pg1, pg2).mean()
  v_loss = 0.5 * torch.square(value - batch["returns"]).mean()
  total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
  return total, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy}


class PPOTrainStep:
  """One PPO iteration, ``state -> (state, metrics)``; ``rollout`` and
  ``update`` are its two phases, callable apart to time them."""

  def __init__(self, pool: TorchEnvPool, net: nn.Module, cfg: PPOConfig,
               tx: ClipAdam) -> None:
    self.net, self.cfg, self.tx = net, cfg, tx
    _, self._recv, self._send, _ = pool.xla()
    keys = pool._state_keys
    self._obs, self._rew, self._done = (
      keys.index("obs"), keys.index("reward"), keys.index("done")
    )

  def _apply(self, params: Params, obs: torch.Tensor):
    return functional_call(self.net, params, (obs,))

  def _sample(self, params: Params, obs: torch.Tensor, key: torch.Tensor):
    """-> (action, logp, value) under the configured policy family."""
    out, value = self._apply(params, obs)
    if self.cfg.continuous:
      mean, log_std = out
      action = mean + torch.exp(log_std) * prng.normal(key, mean.shape)
      logp = _gauss_logp(action, mean, log_std)
    else:
      action = prng.categorical(key, out)
      logp = torch.log_softmax(out, dim=-1).gather(-1, action[:, None])[:, 0]
    return action, logp, value

  @torch.no_grad()
  def rollout(self, state: PPOState):
    """``num_steps`` pool steps -> (handle, key, traj of [T, N, ...]
    tensors, the value of the last obs)."""
    handle, key, params = state.handle, state.key, state.params
    act_dtype = torch.float32 if self.cfg.continuous else torch.int32
    steps = []
    for _ in range(self.cfg.num_steps):
      _, states = self._recv(handle)
      obs = states[self._obs]
      key, sub = prng.split(key, 2)
      action, logp, value = self._sample(params, obs, sub)
      handle = self._send(handle, action.to(act_dtype))
      _, nxt = self._recv(handle)
      steps.append((obs, action, logp, value, nxt[self._rew], nxt[self._done]))
    traj = {
      k: torch.stack(v)
      for k, v in zip(("obs", "action", "logp", "value", "reward", "done"), zip(*steps))
    }
    # bootstrap value for the final observation
    _, states = self._recv(handle)
    _, last_value = self._apply(params, states[self._obs])
    return handle, key, traj, last_value

  def update(self, state: PPOState, rollout) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    """GAE and ``update_epochs`` x ``num_minibatches`` Adam steps."""
    cfg, tx = self.cfg, self.tx
    handle, key, traj, last_value = rollout
    with torch.no_grad():
      adv, returns = compute_gae(traj, last_value, cfg.gamma, cfg.gae_lambda)
    flat = {
      "obs": traj["obs"].flatten(0, 1),
      "action": traj["action"].flatten(0, 1),
      "logp": traj["logp"].flatten(),
      "adv": adv.flatten(),
      "returns": returns.flatten(),
    }
    n = flat["logp"].shape[0]
    mb = n // cfg.num_minibatches
    params, opt_state = state.params, state.opt_state
    aux_all = []
    for _ in range(cfg.update_epochs):
      key, sub = prng.split(key, 2)
      perm = prng.permutation(sub, n)
      shuffled = {k: v[perm] for k, v in flat.items()}
      for i in range(cfg.num_minibatches):
        batch = {k: v[i * mb:(i + 1) * mb] for k, v in shuffled.items()}
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        total, aux = ppo_loss(self.net, cfg, leaves, batch)
        grads = torch.autograd.grad(total, list(leaves.values()))
        with torch.no_grad():
          updates, opt_state = tx.update(dict(zip(leaves, grads)), opt_state)
          params = apply_updates(params, updates)
        aux_all.append({k: v.detach() for k, v in aux.items()})
    metrics = {k: torch.stack([a[k] for a in aux_all]).mean() for k in aux_all[0]}
    metrics["mean_reward"] = traj["reward"].mean()
    return PPOState(handle, params, opt_state, key), metrics

  def __call__(self, state: PPOState) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    return self.update(state, self.rollout(state))


def make_ppo_train_step(
  pool: TorchEnvPool, net: nn.Module, cfg: PPOConfig, tx: ClipAdam
) -> PPOTrainStep:
  """The one-iteration training step over ``pool`` (no sharding: see the
  module docstring)."""
  return PPOTrainStep(pool, net, cfg, tx)
