"""Sharded env execution over a device mesh.

The port of ``envpool_tpu/parallel/sharded.py``. The JAX package shards
the ``[num_envs, ...]`` state pytree over the ``env`` axis of a
``jax.sharding.Mesh`` and compiles one SPMD program. Here a mesh position
on the env axis is a shard: one contiguous block of envs whose pool state
lives on that position's device and is advanced by its own engine (a
``TorchEnvPool`` over the block's global env ids, with the global config).
Outputs are gathered onto the mesh's first device, the view a consumer of
the JAX pool gets when it asks for a different sharding; actions are split
by shard. The results equal the unsharded pool's bit for bit: keys,
``info:env_id`` and the families' streams follow the global env ids, and
every select of the advance is per lane, so each shard may decide alone
(one host read of its own flag) whether to run the reset.

One deliberate difference from the JAX mesh: a ``Mesh`` may list the same
device more than once. Each position is then a logical shard on that
device, so that one card, or the CPU, can hold any number of shards.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from envpool_torch.core import graph
from envpool_torch.core.env_spec import EnvSpec
from envpool_torch.core.envpool_api import (
  DMConvertMixin,
  GymConvertMixin,
  GymnasiumConvertMixin,
  _dialect_class,
)
from envpool_torch.core.pool import (
  PoolState,
  TorchEnvPool,
  XlaHandle,
  resolve_device,
  state_from_numpy,
  tree_map,
)

Device = Union[str, torch.device]


def initialize_distributed(**kwargs: Any) -> None:
  """Multi-host entry: a thin wrapper over
  ``torch.distributed.init_process_group`` (the JAX package's wraps
  ``jax.distributed.initialize``). Nothing tells a process of its cluster:
  pass ``init_method`` (``tcp://host:port``), ``world_size`` and ``rank``."""
  torch.distributed.init_process_group(**kwargs)


class Mesh:
  """The surface of ``jax.sharding.Mesh`` that the callers use: ``devices``
  (an object array of ``torch.device`` shaped like the mesh),
  ``axis_names``, ``shape`` (axis name -> size) and ``size``. A device may
  stand at several positions (logical shards)."""

  def __init__(self, devices: Any, axis_names: Sequence[str]) -> None:
    arr = np.asarray(devices, dtype=object)
    flat = np.empty(arr.size, dtype=object)
    flat[:] = [torch.device(d) for d in arr.ravel()]
    self.devices = flat.reshape(arr.shape)
    self.axis_names = tuple(axis_names)
    if self.devices.ndim != len(self.axis_names):
      raise ValueError(
        f"a mesh of shape {self.devices.shape} needs {self.devices.ndim} "
        f"axis names, got {self.axis_names}"
      )

  @property
  def shape(self) -> Dict[str, int]:
    return dict(zip(self.axis_names, self.devices.shape))

  @property
  def size(self) -> int:
    return int(self.devices.size)

  def grid(self, *axis_names: str) -> np.ndarray:
    """The devices over ``axis_names`` in that order, at the first position
    of every other axis (where a block replicated over those lives)."""
    for a in axis_names:
      if a not in self.axis_names:
        raise ValueError(f"axis {a!r} is not in the mesh's {self.axis_names}")
    axes = [self.axis_names.index(a) for a in axis_names]
    moved = np.moveaxis(self.devices, axes, list(range(len(axes))))
    return moved.reshape(*moved.shape[:len(axes)], -1)[..., 0]

  def __repr__(self) -> str:
    return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def make_mesh(
  n_devices: Optional[int] = None,
  axis_name: str = "env",
  devices: Optional[Sequence[Device]] = None,
) -> Mesh:
  """A 1-D mesh with one env axis: the CUDA devices by default (raises
  without one; the CPU is never a fallback), else ``devices``, which may
  repeat a device to make logical shards (``devices=["cpu"] * 8``)."""
  if devices is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
        "make_mesh() takes the CUDA devices and none is available; pass "
        "devices (e.g. ['cpu'] * 8) to build a mesh of CPU shards"
      )
    devices = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    if n_devices is not None and n_devices > len(devices):
      raise ValueError(
        f"n_devices={n_devices} but {len(devices)} CUDA devices; pass "
        "devices=[...] to place several shards on one device"
      )
  if n_devices is not None:
    devices = list(devices)[:n_devices]
  return Mesh(list(devices), (axis_name,))


def _cat(parts: List[List[Any]], device: torch.device) -> List[Any]:
  """Per-shard output lists -> one list of full-batch outputs on
  ``device`` (container pairs included)."""
  if len(parts) == 1:
    return [tree_map(lambda o: o.to(device), o) for o in parts[0]]
  return [
    tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]), *col)
    for col in zip(*parts)
  ]


class ShardedEnvPool(TorchEnvPool):
  """A ``TorchEnvPool`` whose envs are split over a mesh's env axis.

  The mesh's size must divide ``num_envs``. The host API (send, recv,
  step, reset, the dialects through the ``Sharded*EnvPool`` classes, async
  cohorts, masked sends), ``xla()`` / ``commit()`` and ``save_state()`` /
  ``load_state()`` behave as on an unsharded pool of the same spec: the
  pool state is a tuple of per-shard ``PoolState``s, and snapshots are the
  unsharded pool's full-batch numpy trees. On a 2-D mesh a block is
  replicated along the other axes (the JAX pool shards the state as
  ``P(axis_name)``); one copy is kept, on the first device of its row.
  """

  def __init__(self, spec: EnvSpec, mesh: Optional[Mesh] = None,
               axis_name: str = "env") -> None:
    self._mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    self._axis_name = axis_name
    n_envs = int(spec.config.num_envs)
    # as the JAX pool: divisibility by the whole mesh, not the env axis
    if n_envs % self._mesh.size != 0:
      raise ValueError(
        f"num_envs={n_envs} must be divisible by the mesh size {self._mesh.size}"
      )
    rows = self._mesh.grid(axis_name)
    for d in rows:
      resolve_device(d)
    self._setup(spec, rows[0])
    b = n_envs // len(rows)
    self._block = b
    # one engine per shard; engines on one device share its banks, which
    # the families cache per device
    self._shards = [
      TorchEnvPool(spec, d, env_ids=range(s * b, (s + 1) * b))
      for s, d in enumerate(rows)
    ]
    self._pending = deque()
    self._last_out = None
    # the last rollout's scan and its (policy_fn, num_steps)
    self._rollout_scan: Tuple[Any, Optional[graph.CapturedScan]] = (None, None)

  @property
  def mesh(self) -> Mesh:
    return self._mesh

  @property
  def _state(self) -> Tuple[PoolState, ...]:
    return tuple(sh._state for sh in self._shards)

  @_state.setter
  def _state(self, states: Sequence[PoolState]) -> None:
    for sh, st in zip(self._shards, states):
      sh._state = st

  def _advance_ids(self, ps, action_b, env_id, reset):
    """Each shard advances its lanes; the outputs are gathered on the
    first device in the unsharded order (send order for an id list)."""
    shards, b, dev = self._shards, self._block, self.device
    if env_id is None:
      parts, new = [], []
      for s, sh in enumerate(shards):
        a = None if action_b is None else {
          k: v[s * b:(s + 1) * b].to(sh.device) for k, v in action_b.items()
        }
        st, outs = sh._advance_ids(ps[s], a, None, reset)
        new.append(st)
        parts.append(outs)
      return tuple(new), _cat(parts, dev)
    ids = torch.as_tensor(env_id).cpu().numpy().astype(np.int64).reshape(-1)
    owner = ids // b
    new, parts, rows = list(ps), [], []
    for s in np.unique(owner):
      sel = np.nonzero(owner == s)[0]
      sh = shards[s]
      a = None
      if action_b is not None:
        idx = torch.from_numpy(sel).to(dev)
        a = {k: v.to(dev)[idx].to(sh.device) for k, v in action_b.items()}
      new[s], outs = sh._advance_ids(ps[s], a, ids[sel] - s * b, reset)
      parts.append(outs)
      rows.append(sel)
    if not parts:  # no id: outputs of no row, no state changed
      return tuple(new), _cat([shards[0]._advance_ids(ps[0], None, ids, True)[1]], dev)
    outs = _cat(parts, dev)
    order = np.concatenate(rows)
    if not np.array_equal(order, np.arange(len(order))):
      back = torch.from_numpy(np.argsort(order, kind="stable")).to(dev)
      outs = [tree_map(lambda o: o[back], o) for o in outs]
    return tuple(new), outs

  def save_state(self) -> PoolState:
    """The unsharded pool's snapshot: full-batch numpy arrays."""
    return tree_map(
      lambda *xs: np.concatenate(xs), *(sh.save_state() for sh in self._shards)
    )

  def load_state(self, state: Any) -> None:
    """Load a full-batch snapshot (of either package, sharded or not)."""
    b = self._block
    full = state_from_numpy(state, "cpu")
    for s, sh in enumerate(self._shards):
      sh._state = tree_map(
        lambda x: x[s * b:(s + 1) * b].to(sh.device, copy=True), full
      )
    self._pending.clear()

  def rollout(
    self,
    policy_fn: Callable[[Any, Tuple[torch.Tensor, ...]], Any],
    policy_state: Any,
    num_steps: int,
  ) -> Tuple[Tuple[XlaHandle, Any], Tuple[torch.Tensor, ...]]:
    """``num_steps`` of recv -> policy -> send over ``xla()``'s functions.

    ``policy_fn(policy_state, states) -> (policy_state, action)``. Returns
    ``((handle, policy_state), traj)``, each field of ``traj`` stacked to
    ``[num_steps, num_envs, ...]`` (the JAX package's ``lax.scan``). When
    every device of the mesh is the same card, the steps run through one
    ``graph.CapturedScan``, kept for the next call with the same
    ``(policy_fn, num_steps)`` (the policy state must then be a tree of tensors); on the
    CPU, and on a mesh over several cards, which no graph spans, they run
    as a loop.
    """
    handle, recv, send, _ = self.xla()

    def body(carry):
      handle, pstate = carry
      _, states = recv(handle)
      pstate, action = policy_fn(pstate, states)
      return (send(handle, action), pstate), tuple(states)

    key, scan = self._rollout_scan
    if key != (policy_fn, num_steps):
      scan = graph.CapturedScan(body, num_steps)
      self._rollout_scan = ((policy_fn, num_steps), scan)
    if len(set(self._mesh.devices.ravel().tolist())) == 1:
      return scan((handle, policy_state))
    return scan.eager((handle, policy_state))


ShardedDMEnvPool = _dialect_class("ShardedDMEnvPool", DMConvertMixin, ShardedEnvPool)
ShardedGymEnvPool = _dialect_class("ShardedGymEnvPool", GymConvertMixin, ShardedEnvPool)
ShardedGymnasiumEnvPool = _dialect_class(
  "ShardedGymnasiumEnvPool", GymnasiumConvertMixin, ShardedEnvPool
)
