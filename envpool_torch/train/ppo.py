"""PPO on the port: rollout through the pool's ``xla()`` interface, GAE and
the minibatched clipped-surrogate update, on the pool's device.

The port of ``envpool_tpu/train/ppo.py``, with its semantics: the same
config, the same key stream (``core/prng.py`` reproduces jax's threefry
draws: ``split``, ``categorical``, ``normal``, ``permutation``), the same
loss and metrics, and ``optax.chain(clip_by_global_norm, adam)`` as
``ClipAdam``. The JAX iteration is one ``jit``; here it is two captures on
the card: the rollout step (policy forward, key split, draw, pool
``send``) runs through ``graph.CapturedScan``, captured once as a CUDA
graph and replayed ``num_steps`` times, and the update (the bootstrap
value, GAE, the permutations, every minibatch's forward, ``torch.autograd``
gradient and ``ClipAdam`` step, the metrics) through
``graph.CapturedCall``, one replay. On the CPU both run eagerly, the same
code. The pool may be a ``TorchEnvPool`` or a ``HostEnvPool``, whose
captured rollout holds its host step as a host node.

With ``mesh`` (``envpool_torch.parallel.Mesh``), ``make_ppo_train_step``
splits the batch over the mesh's ``axis_name`` axis (data parallelism:
each env shard's policy on its device, the advantage statistics and the
gradients reduced across shards) and, with ``model_axis``, every weight
over that axis along its output features (tensor parallelism); see
``ShardedPPOTrainStep``.

Usage::

  pool = envpool_torch.make_gymnasium("Sokoban-v0", num_envs=1024, ...)
  net = SokobanCNN()
  state, tx = ppo_init(pool, net, cfg, seed=0)
  train_step = make_ppo_train_step(pool, net, cfg, tx)
  state, metrics = train_step(state)
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from envpool_torch.core import graph, prng
from envpool_torch.core.pool import TorchEnvPool, _torch_dtype
from envpool_torch.models.nets import forward_split

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
  optax's bias correction. The step count stays on the host; the bias
  corrections are read from device memory (``bias_rows``), so that a
  captured update takes each replay's from its inputs."""

  def __init__(self, max_norm: float, lr: float, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8) -> None:
    self.max_norm, self.lr, self.b1, self.b2, self.eps = max_norm, lr, b1, b2, eps
    # per device: the bias corrections of counts 1..len, and the
    # page-locked host table its copy came from (never written again)
    self._tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

  def bias_rows(self, count: int, steps: int, device: Any) -> torch.Tensor:
    """``[steps, 2]`` float32: ``1 - b1**c`` and ``1 - b2**c`` for the
    counts ``c = count .. count + steps - 1``, each computed in np.float32
    as optax does (bit for bit with it). Rows of a per-device table made
    on the host at the first call and when a count outgrows it (its copy to
    the card is asynchronous); a slice costs no copy."""
    device = torch.device(device)
    need = count + steps - 1
    entry = self._tables.get(device)
    if entry is None or entry[0].shape[0] < need:
      k = max(1024, 2 * need)
      b1, b2 = np.float32(self.b1), np.float32(self.b2)
      host = np.empty((k, 2), np.float32)
      for c in range(1, k + 1):
        host[c - 1] = 1 - b1 ** np.float32(c), 1 - b2 ** np.float32(c)
      src = torch.from_numpy(host)
      if device.type == "cuda":
        src = src.pin_memory()
        table = torch.empty(src.shape, dtype=src.dtype, device=device)
        table.copy_(src, non_blocking=True)
      else:
        table = src
      entry = self._tables[device] = (table, src)
    return entry[0][count - 1:need]

  def init(self, params: Params) -> Dict[str, Any]:
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

  def update(self, grads: Params, opt_state: Dict[str, Any],
             bias: Optional[torch.Tensor] = None) -> Tuple[Params, Dict[str, Any]]:
    """-> (updates to add to the params, new state). ``bias`` is this
    step's row of ``bias_rows`` (default: read from the table here)."""
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
    if bias is None:
      bias = self.bias_rows(count, 1, g[0].device)[0]
    # optax's bias correction, 1 - decay**count in float32
    bc1, bc2 = bias[0], bias[1]
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
             batch: Dict[str, torch.Tensor], part: Any = None, apply: Any = None):
  """-> (total loss, {"pg_loss", "v_loss", "entropy"}) of one minibatch.

  ``part`` = (advantage mean, advantage std, minibatch size) makes
  ``batch`` one shard's rows of a larger minibatch: the advantages are
  normalised by the whole minibatch's statistics and each mean is this
  part's sum over the whole size, so the parts' losses and gradients add
  up to the whole's. ``apply(obs)`` replaces the net's call under
  ``params`` (the column-parallel forward of the model axis)."""
  if apply is None:
    out, value = functional_call(net, params, (batch["obs"],))
  else:
    out, value = apply(batch["obs"])
  if part is None:
    mean = torch.mean
  else:
    adv_mean, adv_std, size = part
    def mean(x):
      return x.sum() / size
  if cfg.continuous:
    mu, log_std = out
    logp = _gauss_logp(batch["action"], mu, log_std)
    entropy = mean(torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1))
  else:
    logp_all = torch.log_softmax(out, dim=-1)
    logp = logp_all.gather(-1, batch["action"][:, None])[:, 0]
    entropy = mean(-(torch.exp(logp_all) * logp_all).sum(-1))
  ratio = torch.exp(logp - batch["logp"])
  adv = batch["adv"]
  if part is None:
    # jnp.std is the population std
    adv_mean, adv_std = adv.mean(), adv.std(correction=0)
  adv = (adv - adv_mean) / (adv_std + 1e-8)
  pg1 = ratio * adv
  pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
  pg_loss = -mean(torch.minimum(pg1, pg2))
  v_loss = 0.5 * mean(torch.square(value - batch["returns"]))
  total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
  return total, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy}


class PPOTrainStep:
  """One PPO iteration, ``state -> (state, metrics)``; ``rollout`` and
  ``update`` are its two phases, callable apart to time them.

  On the card both are captured (``graph.CapturedScan`` and
  ``graph.CapturedCall``) and the returned state holds copies of the
  graphs' outputs. ``update_eager`` and ``eager`` run the same code launched
  op by op: the references that the captures are held against."""

  def __init__(self, pool: TorchEnvPool, net: nn.Module, cfg: PPOConfig,
               tx: ClipAdam) -> None:
    self.net, self.cfg, self.tx = net, cfg, tx
    _, self._recv, self._send, _ = pool.xla()
    keys = pool._state_keys
    self._obs, self._rew, self._done = (
      keys.index("obs"), keys.index("reward"), keys.index("done")
    )
    # the rollout step's graph reads the parameters from these buffers,
    # refilled before each rollout
    self._params: Optional[Params] = None
    self._scan = graph.CapturedScan(self._rollout_step, cfg.num_steps)
    self._update = graph.CapturedCall(self._update_fn)
    # the trajectory the update reads: set before each update, on the card
    # to the captured update's own buffers (``_static_traj``)
    self._traj: Any = None
    self._static_traj: Any = None

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

  def _rollout_step(self, carry):
    """One step of the rollout's scan: ``(handle, key) -> (carry, the
    step's row of the trajectory)``."""
    handle, key = carry
    act_dtype = torch.float32 if self.cfg.continuous else torch.int32
    _, states = self._recv(handle)
    obs = states[self._obs]
    key, sub = prng.split(key, 2)
    action, logp, value = self._sample(self._params, obs, sub)
    handle = self._send(handle, action.to(act_dtype))
    _, nxt = self._recv(handle)
    traj = {"obs": obs, "action": action, "logp": logp, "value": value,
            "reward": nxt[self._rew], "done": nxt[self._done]}
    return (handle, key), traj

  @torch.no_grad()
  def _run_scan(self, state: PPOState, copy: bool, eager: bool = False):
    """The rollout's scan from ``state`` -> (handle, key, trajectory); with
    ``copy=False`` the trajectory is the scan's own buffers on the card,
    with ``eager`` a loop of step calls."""
    if self._params is None:
      self._params = {k: v.detach().clone() for k, v in state.params.items()}
    else:
      for k, v in state.params.items():
        self._params[k].copy_(v)
    carry = (state.handle, state.key)
    if eager:
      (handle, key), traj = self._scan.eager(carry)
      return handle, key, traj
    (handle, key), traj = self._scan(carry, copy=copy)
    if not copy:
      handle, key = graph.tree_map(torch.clone, (handle, key))
    return handle, key, traj

  def _last_obs(self, handle) -> torch.Tensor:
    return self._recv(handle)[1][self._obs]

  def _value(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
    return self._apply(params, obs)[1]

  @torch.no_grad()
  def rollout(self, state: PPOState):
    """``num_steps`` pool steps -> (handle, key, traj of [T, N, ...]
    tensors, the value of the last obs)."""
    handle, key, traj = self._run_scan(state, copy=True)
    return handle, key, traj, self._value(state.params, self._last_obs(handle))

  def _grads(self, params: Params, batch: Dict[str, torch.Tensor]):
    """-> (loss aux, gradients by name) of one minibatch."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    total, aux = ppo_loss(self.net, self.cfg, leaves, batch)
    grads = torch.autograd.grad(total, list(leaves.values()))
    return aux, dict(zip(leaves, grads))

  def _update_fn(self, params: Params, mu: Params, nu: Params, key: torch.Tensor,
                 last_obs: torch.Tensor, bias: torch.Tensor):
    """What the update's graph holds: the bootstrap value, GAE and
    ``update_epochs`` x ``num_minibatches`` Adam steps over ``self._traj``,
    the ``k``-th with row ``k`` of ``bias``; -> (params, mu, nu, key,
    metrics)."""
    cfg, tx = self.cfg, self.tx
    traj = self._traj
    with torch.no_grad():
      last_value = self._value(params, last_obs)
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
    opt_state = {"count": 0, "mu": mu, "nu": nu}
    aux_all = []
    for _ in range(cfg.update_epochs):
      key, sub = prng.split(key, 2)
      perm = prng.permutation(sub, n)
      shuffled = {k: v[perm] for k, v in flat.items()}
      for i in range(cfg.num_minibatches):
        batch = {k: v[i * mb:(i + 1) * mb] for k, v in shuffled.items()}
        aux, grads = self._grads(params, batch)
        with torch.no_grad():
          updates, opt_state = tx.update(grads, opt_state, bias[len(aux_all)])
          params = apply_updates(params, updates)
        aux_all.append({k: v.detach() for k, v in aux.items()})
    metrics = {k: torch.stack([a[k] for a in aux_all]).mean() for k in aux_all[0]}
    metrics["mean_reward"] = traj["reward"].mean()
    return params, opt_state["mu"], opt_state["nu"], key, metrics

  def _run_update(self, state: PPOState, rollout, captured: bool
                  ) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    cfg = self.cfg
    handle, key, traj, _ = rollout
    steps = cfg.update_epochs * cfg.num_minibatches
    count = state.opt_state["count"]
    args = (state.params, state.opt_state["mu"], state.opt_state["nu"], key,
            self._last_obs(handle), self.tx.bias_rows(count + 1, steps, key.device))
    if captured and key.is_cuda:
      if self._static_traj is None:
        self._static_traj = graph.tree_map(torch.clone, traj)
      graph._copy_into(self._static_traj, traj)
      self._traj = self._static_traj
      params, mu, nu, key, metrics = self._update(*args)
    else:
      self._traj = traj
      params, mu, nu, key, metrics = self._update_fn(*args)
    self._traj = None
    opt_state = {"count": count + steps, "mu": mu, "nu": nu}
    return PPOState(handle, params, opt_state, key), metrics

  def update(self, state: PPOState, rollout) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    """GAE and ``update_epochs`` x ``num_minibatches`` Adam steps (the
    bootstrap value is recomputed from the handle, inside the update), one
    captured call on the card."""
    return self._run_update(state, rollout, captured=True)

  def update_eager(self, state: PPOState, rollout) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    """``update`` launched op by op on the card (the same code)."""
    return self._run_update(state, rollout, captured=False)

  def eager(self, state: PPOState) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    """One iteration with the rollout's steps and the update launched op by
    op on the card (the same code as ``__call__``'s)."""
    handle, key, traj = self._run_scan(state, copy=True, eager=True)
    return self._run_update(state, (handle, key, traj, None), captured=False)

  def __call__(self, state: PPOState) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    handle, key, traj = self._run_scan(state, copy=False)
    if self._static_traj is None and traj is getattr(self._scan, "_ys", None):
      # the captured update reads the rollout's own buffers: no copy
      self._static_traj = traj
    return self._run_update(state, (handle, key, traj, None), captured=True)


class _MeshLayout:
  """Where a mesh puts the trainer's work. Row r of the env axis takes the
  r-th contiguous block of the batch on ``devices[r, 0]``, with a replica
  of the parameters; with a model axis of size M, ``devices[r, m]`` holds
  block m of the output features (dim 0) of every parameter of two or more
  dimensions, and the biases stay whole on the row's device."""

  def __init__(self, mesh: Any, axis_name: str, model_axis: Optional[str]) -> None:
    if model_axis is None:
      self.devices = mesh.grid(axis_name)[:, None]
    elif model_axis == axis_name:
      raise ValueError(f"model_axis {model_axis!r} is the env axis")
    else:
      self.devices = mesh.grid(axis_name, model_axis)
    self.rows, self.cols = self.devices.shape

  def place(self, params: Params, grad: bool):
    """-> (leaves, rows): the tensors autograd differentiates, keyed by
    (name, block or None, device), one per distinct device (logical shards
    on one device share them, so autograd sums their gradients); and per
    row the (whole parameters, weight blocks) its forward uses."""
    leaves: Dict[Tuple[str, Optional[int], Any], torch.Tensor] = {}

    def leaf(k, m, d, v):
      if (k, m, d) not in leaves:
        x = v.detach().to(d)
        leaves[(k, m, d)] = x.requires_grad_() if grad else x
      return leaves[(k, m, d)]

    rows = []
    for r in range(self.rows):
      whole, columns = {}, {}
      for k, v in params.items():
        if self.cols > 1 and v.ndim >= 2:
          blocks = v.tensor_split(self.cols, 0)
          columns[k] = [leaf(k, m, self.devices[r, m], blocks[m])
                        for m in range(self.cols)]
        else:
          whole[k] = leaf(k, None, self.devices[r, 0], v)
      rows.append((whole, columns))
    return leaves, rows

  def gradients(self, params: Params, leaves, grads, device) -> Params:
    """The leaves' gradients -> the full gradient on ``device``: summed
    over the env axis, weight blocks concatenated over the model axis."""
    acc: Dict[Tuple[str, Optional[int]], List[torch.Tensor]] = {}
    for (k, m, _), g in zip(leaves, grads):
      acc.setdefault((k, m), []).append(g.to(device))
    total = {key: functools.reduce(torch.add, gs) for key, gs in acc.items()}
    return {
      k: total[(k, None)] if (k, None) in total
      else torch.cat([total[(k, m)] for m in range(self.cols)])
      for k in params
    }


class ShardedPPOTrainStep(PPOTrainStep):
  """``PPOTrainStep`` over a mesh: the JAX trainer's ``mesh`` /
  ``axis_name`` / ``model_axis`` (``envpool_tpu/train/ppo.py:78-125``).

  Data parallelism over ``axis_name``: each row of the env axis runs the
  policy on its block of the batch on its device. The draws keep the
  unsharded key stream: each is made once at the full batch shape and
  sliced per row (threefry lays a shape's counters out in two halves, so a
  row cannot draw its slice alone). In the update, the permutation picks
  each minibatch's rows as unsharded; each row takes those of its block.
  The advantage statistics of the minibatch are reduced across rows
  before any backward pass, each row's loss is its part of the minibatch
  means, and the gradients are summed across rows, so ``ClipAdam``'s norm
  sees the full gradient and every replica takes the same step (made once
  on the first device and copied out). With ``model_axis``, every
  parameter of two or more dimensions is split over that axis along its
  output features (``models.nets.forward_split``). The result equals the
  unsharded trainer's up to the order of float sums. This per-row path is
  ``rollout_rows`` / ``update_rows`` (``per_row``: one iteration), eager.

  When every device of the mesh is the same one (``one_device``:
  ``make_mesh()`` on a machine with one card, logical shards), the rows and
  the model axis's blocks share that device and the parameters, so there is
  nothing to split: the iteration is the unsharded trainer's (the policy
  and each minibatch whole, captured on the card), bit for bit, and
  ``rollout`` hands its trajectory out as per-row views. A mesh over
  several cards runs the per-row path as eager loops: no graph spans
  cards, and no machine here has two cards to hold such a capture against.
  The per-row path runs on any mesh, so that it can be held against the
  one-device path and the JAX trainer where there is one device.
  """

  def __init__(self, pool: TorchEnvPool, net: nn.Module, cfg: PPOConfig,
               tx: ClipAdam, mesh: Any, axis_name: str = "env",
               model_axis: Optional[str] = None) -> None:
    super().__init__(pool, net, cfg, tx)
    self.layout = _MeshLayout(mesh, axis_name, model_axis)
    self._one_device = len(set(self.layout.devices.ravel().tolist())) == 1
    self._rows_scan = graph.CapturedScan(self._rollout_step_rows, cfg.num_steps)
    self._rows: Any = None  # the per-row rollout's placed parameters

  @property
  def one_device(self) -> bool:
    """Whether every device of the mesh is the same one (then the
    iteration is the unsharded one)."""
    return self._one_device

  def _row_apply(self, row, obs: torch.Tensor):
    whole, columns = row
    if columns:
      return forward_split(self.net, whole, columns, obs)
    return functional_call(self.net, whole, (obs,))

  def _blocks(self, n: int) -> List[slice]:
    rows = self.layout.rows
    if n % rows:
      raise ValueError(f"a batch of {n} does not split over {rows} env shards")
    b = n // rows
    return [slice(r * b, (r + 1) * b) for r in range(rows)]

  def _rollout_step_rows(self, carry):
    """One step of the per-row rollout: each row's policy on its block on
    its device, the draws at the full batch shape and sliced, one pool
    ``send``; -> (carry, per row the step's ``_TRAJ_KEYS`` on the row's
    device)."""
    cfg, devs = self.cfg, self.layout.devices
    handle, key = carry
    act_dtype = torch.float32 if cfg.continuous else torch.int32
    _, states = self._recv(handle)
    obs = states[self._obs]
    blocks = self._blocks(obs.shape[0])
    key, sub = prng.split(key, 2)
    obs_p = [obs[sl].to(devs[r, 0]) for r, sl in enumerate(blocks)]
    outs = [self._row_apply(row, o) for row, o in zip(self._rows, obs_p)]
    head = outs[0][0][0] if cfg.continuous else outs[0][0]
    shape = (obs.shape[0], *head.shape[1:])
    noise = (prng.normal if cfg.continuous else prng.gumbel)(sub, shape)
    cols = []
    for r, (sl, o, (out, value)) in enumerate(zip(blocks, obs_p, outs)):
      z = noise[sl].to(devs[r, 0])
      if cfg.continuous:
        mean, log_std = out
        action = mean + torch.exp(log_std) * z
        logp = _gauss_logp(action, mean, log_std)
      else:
        action = torch.argmax(z + out, dim=-1)
        logp = torch.log_softmax(out, dim=-1).gather(-1, action[:, None])[:, 0]
      cols.append([o, action, logp, value])
    handle = self._send(
      handle, torch.cat([c[1].to(obs.device) for c in cols]).to(act_dtype)
    )
    _, nxt = self._recv(handle)
    ys = tuple(
      dict(zip(_TRAJ_KEYS, [*row, nxt[self._rew][sl].to(devs[r, 0]),
                            nxt[self._done][sl].to(devs[r, 0])]))
      for r, (row, sl) in enumerate(zip(cols, blocks))
    )
    return (handle, key), ys

  def _last_values(self, params: Params, obs: torch.Tensor) -> List[torch.Tensor]:
    devs, blocks = self.layout.devices, self._blocks(obs.shape[0])
    _, rows = self.layout.place(params, grad=False)
    return [self._row_apply(row, obs[sl].to(devs[r, 0]))[1]
            for r, (row, sl) in enumerate(zip(rows, blocks))]

  @torch.no_grad()
  def rollout(self, state: PPOState):
    """``num_steps`` pool steps -> (handle, key, per-row trajectories of
    ``[T, block, ...]`` tensors on the rows' devices, per-row values of the
    last obs); ``gather`` makes them the unsharded trainer's. On one device
    the unsharded rollout (captured on the card), cut into rows."""
    if not self.one_device:
      return self.rollout_rows(state)
    handle, key, traj, value = super().rollout(state)
    blocks = self._blocks(value.shape[0])
    return (handle, key, tuple({k: v[:, sl] for k, v in traj.items()} for sl in blocks),
            [value[sl] for sl in blocks])

  @torch.no_grad()
  def rollout_rows(self, state: PPOState):
    """The per-row rollout, eager on any mesh; -> as ``rollout``."""
    _, self._rows = self.layout.place(state.params, grad=False)
    (handle, key), trajs = self._rows_scan.eager((state.handle, state.key))
    self._rows = None
    return handle, key, trajs, self._last_values(state.params, self._last_obs(handle))

  @staticmethod
  def gather(trajs: Sequence[Dict[str, torch.Tensor]], device) -> Dict[str, torch.Tensor]:
    """Per-row trajectories -> one ``[T, N, ...]`` dict on ``device``."""
    return {k: torch.cat([t[k].to(device) for t in trajs], 1) for k in trajs[0]}

  def _whole(self, rollout):
    handle, key, trajs, _ = rollout
    return handle, key, self.gather(trajs, self.layout.devices[0, 0]), None

  def update(self, state: PPOState, rollout) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    """GAE and ``update_epochs`` x ``num_minibatches`` steps: on one device
    the unsharded update (captured on the card), else per row."""
    if not self.one_device:
      return self.update_rows(state, rollout)
    return super().update(state, self._whole(rollout))

  def update_eager(self, state: PPOState, rollout) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    if not self.one_device:
      return self.update_rows(state, rollout)
    return super().update_eager(state, self._whole(rollout))

  def eager(self, state: PPOState) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    if not self.one_device:
      return self.per_row(state)
    return super().eager(state)

  def __call__(self, state: PPOState) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    if not self.one_device:
      return self.per_row(state)
    return super().__call__(state)

  def per_row(self, state: PPOState) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    """One iteration through the per-row path, eager on any mesh."""
    return self.update_rows(state, self.rollout_rows(state))

  def update_rows(self, state: PPOState, rollout) -> Tuple[PPOState, Dict[str, torch.Tensor]]:
    """The per-row update (what a mesh over several devices runs, eager):
    GAE per row, then each minibatch split by the rows that hold its
    samples."""
    cfg, tx, layout = self.cfg, self.tx, self.layout
    devs = layout.devices
    handle, key, trajs, last = rollout
    dev0 = state.key.device
    flats = []
    with torch.no_grad():
      for traj, lv in zip(trajs, last):
        adv, returns = compute_gae(traj, lv, cfg.gamma, cfg.gae_lambda)
        flats.append({
          "obs": traj["obs"].flatten(0, 1), "action": traj["action"].flatten(0, 1),
          "logp": traj["logp"].flatten(), "adv": adv.flatten(),
          "returns": returns.flatten(),
        })
    t_len, b = trajs[0]["logp"].shape
    n_envs = b * layout.rows
    n = t_len * n_envs
    mb = n // cfg.num_minibatches
    params, opt_state = state.params, state.opt_state
    aux_all = []
    for _ in range(cfg.update_epochs):
      key, sub = prng.split(key, 2)
      # flat index t * N + e of the unsharded batch -> (row, t * b + e % b)
      perm = prng.permutation(sub, n).cpu().numpy()
      env = perm % n_envs
      owner, local = env // b, (perm // n_envs) * b + env % b
      for i in range(cfg.num_minibatches):
        sl = slice(i * mb, (i + 1) * mb)
        batches = []
        for r in range(layout.rows):
          idx = torch.from_numpy(local[sl][owner[sl] == r]).to(devs[r, 0])
          batches.append({k: v[idx] for k, v in flats[r].items()})
        with torch.no_grad():
          adv_mean = _sum_to([bt["adv"].sum() for bt in batches], dev0) / mb
          adv_var = _sum_to([
            torch.square(bt["adv"] - adv_mean.to(bt["adv"].device)).sum()
            for bt in batches
          ], dev0) / mb
          adv_std = torch.sqrt(adv_var)
        leaves, rows = layout.place(params, grad=True)
        totals, auxs = [], []
        for r, bt in enumerate(batches):
          if not len(bt["adv"]):
            continue
          d = devs[r, 0]
          total, aux = ppo_loss(
            self.net, cfg, None, bt, (adv_mean.to(d), adv_std.to(d), mb),
            apply=functools.partial(self._row_apply, rows[r]),
          )
          totals.append(total)
          auxs.append(aux)
        grads = torch.autograd.grad(_sum_to(totals, dev0), list(leaves.values()))
        with torch.no_grad():
          full = layout.gradients(params, leaves, grads, dev0)
          updates, opt_state = tx.update(full, opt_state)
          params = apply_updates(params, updates)
        aux_all.append({k: _sum_to([a[k].detach() for a in auxs], dev0) for k in auxs[0]})
    metrics = {k: torch.stack([a[k] for a in aux_all]).mean() for k in aux_all[0]}
    metrics["mean_reward"] = self.gather(trajs, dev0)["reward"].mean()
    return PPOState(handle, params, opt_state, key), metrics


_TRAJ_KEYS = ("obs", "action", "logp", "value", "reward", "done")


def _sum_to(xs: List[torch.Tensor], device) -> torch.Tensor:
  """The sum of ``xs``, each moved to ``device`` (an all-reduce's value)."""
  return functools.reduce(torch.add, [x.to(device) for x in xs])


def make_ppo_train_step(
  pool: TorchEnvPool, net: nn.Module, cfg: PPOConfig, tx: ClipAdam,
  mesh: Any = None, axis_name: str = "env", model_axis: Optional[str] = None,
) -> PPOTrainStep:
  """The one-iteration training step over ``pool``. With ``mesh`` (a
  ``parallel.Mesh``), the batch is split over its ``axis_name`` axis and,
  when ``model_axis`` names a second axis, every parameter of two or more
  dimensions over that one (``ShardedPPOTrainStep``)."""
  if mesh is None:
    if model_axis is not None:
      raise ValueError("model_axis needs a mesh")
    return PPOTrainStep(pool, net, cfg, tx)
  return ShardedPPOTrainStep(pool, net, cfg, tx, mesh, axis_name, model_axis)
