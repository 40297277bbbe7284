"""Entry points of a quick check: the flagship net's forward, and one PPO
iteration over a mesh of logical shards.

The port of ``__graft_entry__.py:10-85``. Run on the card:

  python -c "from envpool_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(8)"

``device="cpu"`` runs it on the CPU.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

import envpool_torch
from envpool_torch.core.pool import resolve_device
from envpool_torch.models import SokobanCNN
from envpool_torch.parallel.sharded import Mesh, ShardedEnvPool, make_mesh
from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init


def entry(device: Union[None, str, torch.device] = None) -> Tuple[Callable, Tuple[Any, ...]]:
  """``(forward, (params, obs))``: the flagship net (``SokobanCNN()``) and
  a zero batch of 256 Sokoban observations on ``device`` (the card by
  default); ``forward(params, obs) -> (logits, value)``."""
  device = resolve_device(device)
  net = SokobanCNN()
  obs = torch.zeros((256, 3, 10, 10), dtype=torch.uint8, device=device)
  net.init(obs, 0)
  params = {k: v.detach() for k, v in net.state_dict().items()}

  def forward(params, obs):
    return functional_call(net, params, (obs,))

  return forward, (params, obs)


def dryrun_multichip(n_devices: int, device: Union[None, str, torch.device] = None) -> None:
  """One full PPO iteration over a mesh of ``n_devices`` logical shards of
  ``device`` (the card by default), on tiny shapes, through the per-row
  path that a mesh over several cards runs (``ShardedPPOTrainStep.per_row``:
  on logical shards of one device the trainer's own call is the unsharded
  iteration).

  An even count of at least 4 makes a ``(n // 2, 2)`` mesh over
  ``("env", "model")``: env-axis data parallelism and the weights split
  over the model axis; any other count a 1-D env mesh. Sokoban-v0 at 2
  envs per env shard, ``SokobanCNN(channels=(8,))``, asserting a finite
  ``pg_loss``.
  """
  device = resolve_device(device)
  devices = [device] * n_devices
  if n_devices % 2 == 0 and n_devices >= 4:
    mesh = Mesh(np.array(devices, dtype=object).reshape(n_devices // 2, 2),
                ("env", "model"))
    model_axis: Optional[str] = "model"
  else:
    mesh = make_mesh(n_devices=n_devices, devices=devices)
    model_axis = None
  num_envs = 2 * mesh.shape["env"]
  spec = envpool_torch.make_spec(
    "Sokoban-v0", num_envs=num_envs, seed=0, max_episode_steps=8,
    levels_dir="", n_levels_to_load=max(num_envs, 8),
  )
  pool = ShardedEnvPool(spec, mesh=mesh)
  net = SokobanCNN(channels=(8,))
  cfg = PPOConfig(num_steps=2, update_epochs=1, num_minibatches=2)
  state, tx = ppo_init(pool, net, cfg, seed=0)
  train_step = make_ppo_train_step(pool, net, cfg, tx, mesh=mesh,
                                   model_axis=model_axis)
  state, metrics = train_step.per_row(state)
  assert math.isfinite(float(metrics["pg_loss"])), metrics
