"""TorchEnvPool — the batched execution engine of the port.

Counterpart of ``envpool_tpu/core/pool.py::TpuEnvPool``. Env state is a dict
of ``[num_envs, ...]`` tensors on one device; one ``advance`` steps every
lane with the family's batched functions, auto-reset is a per-lane select
on the done flags, and partial batches are env-id masks. The three
entry points of the JAX package (full advance, masked advance, forced
reset) are plain methods over the same ``advance``; ``graph.scan`` captures
them as one CUDA graph where the JAX package jits them.

Semantics reproduced exactly (see tests/test_torch_*.py):
- auto-reset: a done env's next scheduled step becomes Reset
  (``envpool/core/env.h:162-172``), producing a FIRST timestep with
  reward 0, done False, elapsed_step 0.
- common field writes: done / discount=(1-done) / step_type FIRST=0 MID=1
  LAST=2 / trunc = done && elapsed >= max_episode_steps / info:env_id /
  elapsed_step (``envpool/core/env.h:196-222``).
- sync mode: batch_size == num_envs steps all envs in lockstep; sending a
  subset of env_id steps only those.
- async mode (batch_size < num_envs): ``send(action, env_id)`` enqueues a
  masked step for that cohort on the device stream, the result is queued,
  and ``recv`` pops in FIFO order.
- per-env RNG: key_i = fold_in(PRNGKey(seed), env_id) with the threefry
  port (``prng.py``), so both packages draw the same numbers.
- env-side auto-reset families (``FuncEnv.env_resets``, Sokoban): the step
  returns done/trunc and, on a terminal step, the next episode's state and
  obs; the pool takes ``elapsed_step`` from the step's info (or counts
  steps where the family does not report it), marks FIRST only where it
  is 0, and never schedules a reset of its own.
- static-shape multiplayer: per-player fields padded to
  ``max_num_players`` with reward/discount masks on the device, per-player
  action rows scattered on the host at ``send`` and padded rows compacted
  away at ``recv``.
- container fields: a padded ``(data, shape)`` pair on the device, a ragged
  object column at ``recv``.

Fused advance. A family with ``FuncEnv.fused_advance`` (Sokoban) does the
whole advance below, the key split, the reset select, the epilogue and the
mask, in one kernel launch for CUDA tensors; the general path is its plain
version (``_advance(..., plain=True)`` runs it on any device over the
family's ``step_plain`` / ``reset_plain``).

Auto-reset form. As ``TpuEnvPool`` (``_merge_resets``), the step always
runs and the reset runs under ``graph.cond(any(need_reset), ...)`` with its
selects: eagerly one device-to-host read of that flag per advance; inside
``graph.scan`` on the card an IF node of the captured graph. Computing the
reset every step and selecting it would render every CarRacing frame twice
and run dm_control cheetah's 200 settle substeps every step. The RNG
consumption is identical either way: step and reset share the same ``sub``
keys, as in the JAX package. A forced reset (the host API's ``reset``)
runs the reset alone. For env-side auto-reset families the flag is set
only on the first step and on forced resets.
"""

from __future__ import annotations

from collections import deque, namedtuple
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import graph, prng
from .graph import tree_map
from .env import FuncEnv
from .env_spec import EnvSpec
from .spec import ContainerSpec

# Pool-level per-env bookkeeping carried between steps. ``env`` is the
# batched env-state dict; ``rng`` the [N, 2] int64 threefry keys; ``done``
# means "this lane auto-resets on its next scheduled step".
PoolState = namedtuple("PoolState", ["env", "rng", "elapsed", "done"])

# The functional interface returned by ``xla()``: the handle carries the
# pool state plus the most recent batch of outputs, so ``recv`` is pure.
XlaHandle = namedtuple("XlaHandle", ["pool", "out"])


def _select(mask: torch.Tensor, a: Any, b: Any) -> Any:
  """Per-lane tree select: mask[i] ? a[i] : b[i] with right-broadcast."""

  def sel(x, y):
    return torch.where(mask.reshape(mask.shape + (1,) * (x.ndim - 1)), x, y)

  return tree_map(sel, a, b)


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
  """None means the card; asking for the card without one raises."""
  device = torch.device("cuda" if device is None else device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
      "envpool_torch pools run on CUDA by default and no CUDA device is "
      "available; pass device='cpu' to run on the CPU"
    )
  return device


def state_from_numpy(state: Any, device: Union[str, torch.device]) -> PoolState:
  """A host pool-state tree (``save_state()`` of either package) -> device.

  The JAX package's snapshot is a ``PoolState`` of numpy arrays with the
  same env-dict keys and uint32 ``[N, 2]`` keys; checkpointers may turn
  the namedtuple into a dict.
  """
  if isinstance(state, dict) and set(state) == set(PoolState._fields):
    state = PoolState(**state)

  def to_dev(x):
    x = np.array(x)  # a writable copy: snapshots may be read-only views
    if x.dtype == np.uint32:
      x = x.astype(np.int64)
    return torch.from_numpy(x).to(device)

  return PoolState(
    env=tree_map(to_dev, state.env),
    rng=to_dev(np.asarray(state.rng, np.uint32)),
    elapsed=to_dev(np.asarray(state.elapsed, np.int32)),
    done=to_dev(np.asarray(state.done, np.bool_)),
  )


def _to_numpy(x: torch.Tensor) -> np.ndarray:
  return x.detach().cpu().numpy()


class TorchEnvPool:
  """Batched env pool with envpool's send/recv/step/reset API on one device."""

  _spec: EnvSpec

  def __init__(
    self, spec: EnvSpec, device: Union[None, str, torch.device] = None,
    env_ids: Optional[Sequence[int]] = None,
  ) -> None:
    """``env_ids``: the global ids of this pool's lanes, all of
    ``spec.config.num_envs`` by default. A ``ShardedEnvPool`` holds one
    contiguous block per shard (``parallel/sharded.py``): the block's keys,
    ``info:env_id`` and env state follow its global ids, and the family sees
    the global config."""
    self._setup(spec, device, env_ids)
    self._state: PoolState = self._init(int(self._cfg.seed))
    # FIFO of device output lists pending recv
    self._pending: deque = deque()
    self._last_out: Optional[List[torch.Tensor]] = None

  def _setup(self, spec: EnvSpec, device: Union[None, str, torch.device],
             env_ids: Optional[Sequence[int]] = None) -> None:
    """Everything but the pool state: spec, config, keys, the lanes."""
    self._spec = spec
    self.spec = spec
    self.device = resolve_device(device)
    cfg = spec.config
    self._cfg = cfg
    self._env_cls: FuncEnv = spec._env_cls
    self._num_envs = int(cfg.num_envs) if env_ids is None else len(env_ids)
    self._batch_size = int(cfg.batch_size) or self._num_envs
    self._env_resets = bool(self._env_cls.env_resets)
    self._max_players = int(cfg.max_num_players)
    self._multi_player = self._max_players > 1
    if self._multi_player:
      if not self._env_cls.multi_player:
        raise ValueError(
          f"{self._env_cls.name} does not support max_num_players > 1"
        )
      if self._env_resets:
        raise NotImplementedError(
          "env-side auto-reset + multi-player is not supported"
        )
    self._container_keys = {
      k for k, s in zip(spec._state_keys, spec._state_spec)
      if isinstance(s, ContainerSpec)
    }
    if self._container_keys and self._multi_player:
      # the static-shape engine supports container fields for single-player
      # envs only, as the JAX package does
      raise NotImplementedError(
        "container specs are not supported with max_num_players > 1"
      )
    self._state_keys: List[str] = spec._state_keys
    self._env_state_keys = [
      k for k in self._state_keys
      if k not in (
        "info:env_id", "info:players.env_id", "elapsed_step", "done",
        "reward", "discount", "step_type", "trunc"
      )
    ]
    self._action_keys: List[str] = spec._action_keys
    self._env_action_keys = [
      k for k in self._action_keys if k not in ("env_id", "players.env_id")
    ]
    self._action_array_spec = spec.action_array_spec
    self._fused = (
      None if self._multi_player or self._container_keys
      else self._env_cls.fused_advance
    )
    n = self._num_envs
    self._env_ids = (
      torch.arange(n, dtype=torch.int32, device=self.device) if env_ids is None
      else torch.as_tensor(list(env_ids), dtype=torch.int32).to(self.device)
    )
    # per-player action fields (leading -1) get the padded player axis
    self._zero_action = {
      k: torch.zeros(
        (n, *self._action_field_shape(self._action_array_spec[k])),
        dtype=_torch_dtype(self._action_array_spec[k].dtype),
        device=self.device,
      )
      for k in self._env_action_keys
    }

  # ------------------------------------------------------------------ engine

  def _action_field_shape(self, spec) -> Tuple[int, ...]:
    if self._multi_player and spec.shape and spec.shape[0] == -1:
      return (self._max_players, *spec.static_shape)
    return spec.static_shape

  def _init(self, seed: int) -> PoolState:
    n = self._num_envs
    base = prng.prng_key(seed, self.device).expand(n, 2)
    keys = prng.fold_in(base, self._env_ids)
    keys, sub = _split_keys(keys)
    return PoolState(
      env=self._env_cls.init(self._cfg, self._env_ids, sub),
      rng=keys,
      elapsed=torch.zeros(n, dtype=torch.int32, device=self.device),
      # all envs report done so the first scheduled step auto-resets
      done=torch.ones(n, dtype=torch.bool, device=self.device),
    )

  def _unpack_action(self, action_full: Dict[str, torch.Tensor]) -> Any:
    if len(self._env_action_keys) == 1:
      return action_full[self._env_action_keys[0]]
    return action_full

  def _advance(
    self,
    ps: PoolState,
    action_full: Dict[str, torch.Tensor],
    mask: Optional[torch.Tensor],
    force_reset: bool,
    plain: bool = False,
  ) -> Tuple[PoolState, List[torch.Tensor]]:
    """One advance of every lane (a forced reset with ``force_reset``; the
    lanes outside ``mask`` keep their state). The family's fused advance
    for CUDA tensors where it has one, which launches its kernel or raises;
    the general path otherwise, or with ``plain`` (over ``step_plain`` /
    ``reset_plain`` where the family has them: the fused advance's plain
    version, on any device)."""
    if self._fused is not None and not plain and ps.rng.device.type == "cuda":
      env2, rng, elapsed, done, out = self._fused(
        self._cfg, ps, self._unpack_action(action_full), mask, force_reset
      )
      out["info:env_id"] = out["info:players.env_id"] = self._env_ids
      return (PoolState(env=env2, rng=rng, elapsed=elapsed, done=done),
              [out[k] for k in self._state_keys])
    env_cls, cfg, n = self._env_cls, self._cfg, self._num_envs
    env_step = getattr(env_cls, "step_plain", env_cls.step) if plain else env_cls.step
    env_reset = getattr(env_cls, "reset_plain", env_cls.reset) if plain else env_cls.reset
    rng, sub = _split_keys(ps.rng)
    st_trunc = None
    if force_reset:
      # every lane that matters resets: the step's values would all be
      # discarded by the selects below, so it is not computed
      need_reset = torch.ones(n, dtype=torch.bool, device=self.device)
      env2, obs, info = env_reset(cfg, ps.env, sub)
      rew_shape = (n, self._max_players) if self._multi_player else (n,)
      st_rew = torch.zeros(rew_shape, dtype=torch.float32, device=self.device)
      st_term = torch.zeros(n, dtype=torch.bool, device=self.device)
      st_trunc = st_term
    else:
      need_reset = ps.done
      res = env_step(cfg, ps.env, self._unpack_action(action_full), sub)
      if self._env_resets:
        st_env, st_obs, st_rew, st_term, st_trunc, st_info = res
      else:
        st_env, st_obs, st_rew, st_term, st_info = res

      def do_reset(st3):
        rs_env, rs_obs, rs_info = env_reset(cfg, ps.env, sub)
        return (
          _select(need_reset, rs_env, st3[0]),
          _select(need_reset, rs_obs, st3[1]),
          _select(need_reset, rs_info, st3[2]),
        )

      # the JAX package's lax.cond(jnp.any(need_reset), ...): one host read
      # eagerly, an IF node of the graph under capture
      live = need_reset if mask is None else need_reset & mask
      env2, obs, info = graph.cond(
        live, do_reset, lambda st3: st3, (st_env, st_obs, st_info)
      )
    info = dict(info)

    # st_rew is [n] single-player or [n, P] multiplayer
    nr = need_reset.reshape(need_reset.shape + (1,) * (st_rew.ndim - 1))
    reward = torch.where(nr, 0.0, st_rew).to(torch.float32)
    if self._env_resets:
      # the step already reset its terminal lanes and reports the finishing
      # episode's counter (it restarts after the in-step reset and freezes
      # on noops, which the pool cannot see); a family that does not report
      # it counts steps like any other
      if "elapsed_step" in info:
        elapsed = torch.where(need_reset, 0, info.pop("elapsed_step"))
      else:
        elapsed = torch.where(need_reset, 0, ps.elapsed + 1)
      done = torch.where(need_reset, False, st_term.to(torch.bool))
      trunc = torch.where(need_reset, False, st_trunc.to(torch.bool))
      # FIRST only right after an explicit reset; a terminal step is LAST
      # although the env has already moved on
      first = elapsed == 0
      # the carried done flag never triggers a pool auto-reset
      done_carry = torch.zeros_like(done)
    else:
      elapsed = torch.where(need_reset, 0, ps.elapsed + 1)
      cap = env_cls.episode_cap(cfg, env2)
      term = torch.where(need_reset, False, st_term.to(torch.bool))
      done = torch.where(need_reset, False, term | (elapsed >= cap))
      trunc = done & (elapsed >= cap)
      first = need_reset
      done_carry = done
    elapsed = elapsed.to(torch.int32)
    step_type = torch.where(first, 0, torch.where(done, 2, 1)).to(torch.int32)
    discount = (~done).to(torch.float32)
    if "discount" in info:
      # reserved info key: the env supplies its own discount
      discount = info.pop("discount").to(torch.float32)

    if mask is not None:
      env2 = _select(mask, env2, ps.env)
      rng = torch.where(mask[:, None], rng, ps.rng)
      elapsed2 = torch.where(mask, elapsed, ps.elapsed)
      done2 = torch.where(mask, done_carry, ps.done)
    else:
      elapsed2, done2 = elapsed, done_carry
    new_ps = PoolState(env=env2, rng=rng, elapsed=elapsed2, done=done2)

    players_env_id = self._env_ids
    if self._multi_player:
      # static-shape multiplayer: every per-player field is padded to
      # max_num_players; the env keeps the live count in
      # state["num_players"], rows past it get reward and discount 0, and
      # ``_recv`` compacts them away
      p = self._max_players
      npl = env2["num_players"]
      pmask = torch.arange(p, device=self.device)[None, :] < npl[:, None]
      reward = torch.where(pmask, reward, 0.0)
      discount = (pmask & (~done)[:, None]).to(torch.float32)
      players_env_id = self._env_ids[:, None].expand(n, p)

    out: Dict[str, Any] = {
      "info:env_id": self._env_ids,
      "info:players.env_id": players_env_id,
      "elapsed_step": elapsed,
      "done": done,
      "reward": reward,
      "discount": discount,
      "step_type": step_type,
      "trunc": trunc,
    }
    for k in self._env_state_keys:
      if k == "obs":
        out[k] = obs
      elif k.startswith("obs:"):
        out[k] = obs[k[4:]]
      elif k.startswith("info:"):
        out[k] = info[k[5:]]
      else:  # bare env-specific top-level key
        out[k] = info[k]
    outs = [out[k] for k in self._state_keys]
    if self._multi_player:
      outs.append(npl)  # live player counts, for the host-side compaction
    return new_ps, outs

  def _mask(self, env_id: torch.Tensor) -> torch.Tensor:
    mask = torch.zeros(self._num_envs, dtype=torch.bool, device=self.device)
    # a fill, not an indexed store of a host scalar (a copy to the device)
    return mask.index_fill_(0, env_id, True)

  def _advance_masked(
    self,
    ps: PoolState,
    action_b: Dict[str, torch.Tensor],
    env_id: torch.Tensor,
    plain: bool = False,
  ) -> Tuple[PoolState, List[torch.Tensor]]:
    action_full = {}
    for k in self._env_action_keys:
      action_full[k] = self._zero_action[k].clone()
      action_full[k][env_id] = action_b[k].to(action_full[k].dtype)
    new_ps, outs = self._advance(ps, action_full, self._mask(env_id), False, plain)
    return new_ps, _gather(outs, env_id)

  def _reset_masked(
    self, ps: PoolState, env_id: torch.Tensor, plain: bool = False
  ) -> Tuple[PoolState, List[torch.Tensor]]:
    # a forced reset of every lane, of which the mask keeps env_id's
    new_ps, outs = self._advance(
      ps, self._zero_action, self._mask(env_id), True, plain
    )
    return new_ps, _gather(outs, env_id)

  def _advance_ids(
    self,
    ps: Any,
    action_b: Optional[Dict[str, torch.Tensor]],
    env_id: Any,
    reset: bool,
    plain: bool = False,
  ) -> Tuple[Any, List[Any]]:
    """One advance of ``ps`` -> (new state, outputs): the entry that
    ``_send``, ``_reset`` and ``xla()``'s ``send`` share. ``env_id`` None
    steps every lane (forces every lane's reset with ``reset``); otherwise
    it lists lane ids (host or device), and the outputs are their rows in
    its order. ``action_b`` None is the zero action. ``plain`` runs the
    general path where the family has a fused advance (``_advance``)."""
    if env_id is None:
      action = self._zero_action if action_b is None else action_b
      return self._advance(ps, action, None, reset, plain)
    env_id = torch.as_tensor(env_id).to(device=self.device, dtype=torch.int64)
    if reset:
      return self._reset_masked(ps, env_id, plain)
    return self._advance_masked(ps, action_b, env_id, plain)

  # ----------------------------------------------------------- low-level API

  def _send(self, action_list: List[np.ndarray]) -> None:
    """Enqueue one masked/full step for the given action batch.

    ``action_list`` is ordered by ``_action_keys`` (env_id, players.env_id,
    *env actions), the layout produced by ``EnvPoolMixin._from``.
    """
    adict = dict(zip(self._action_keys, action_list))
    env_id = np.asarray(adict["env_id"])
    if self._multi_player:
      adict = self._scatter_player_actions(adict)
    action_b = {
      k: torch.as_tensor(np.asarray(adict[k])).to(self.device)
      for k in self._env_action_keys
    }
    full = len(env_id) == self._num_envs and np.array_equal(
      env_id, np.arange(self._num_envs, dtype=env_id.dtype)
    )
    self._state, outs = self._advance_ids(
      self._state, action_b, None if full else env_id, False
    )
    self._pending.append(outs)
    self._last_out = outs

  def _scatter_player_actions(self, adict: Dict[str, Any]) -> Dict[str, Any]:
    """[total_players, ...] per-player action rows -> [B, P, ...] padded.

    Counterpart of ``TpuEnvPool._scatter_player_actions``: rows of the same
    env fill consecutive player slots in arrival order, and the result is
    ordered by the send's env_id cohort, so it feeds both the full-batch
    path (env_id == arange) and the masked path.
    """
    players = np.asarray(adict["players.env_id"], dtype=np.int64)
    cohort = np.asarray(adict["env_id"], dtype=np.int64)
    # slot of each row within its env (stable cumulative count)
    slots = np.zeros(len(players), dtype=np.int64)
    counts: Dict[int, int] = {}
    for i, e in enumerate(players.tolist()):
      slots[i] = counts.get(e, 0)
      counts[e] = slots[i] + 1
    out = dict(adict)
    for k in self._env_action_keys:
      spec = self._action_array_spec[k]
      if spec.shape and spec.shape[0] == -1:
        full = np.zeros(
          (self._num_envs, self._max_players, *spec.static_shape),
          dtype=spec.dtype,
        )
        full[players, slots] = np.asarray(adict[k])
        out[k] = full[cohort]
    return out

  def _compact_players(self, outs: List[Any]) -> List[Any]:
    """Drop padded player rows at the host boundary: [B, P, ...] fields
    with a per-player spec become [total_players, ...]."""
    *state_vals, npl = outs
    p = self._max_players
    keep = (np.arange(p)[None, :] < npl[:, None]).ravel()
    compacted = []
    for val, spec in zip(state_vals, self._spec._state_spec):
      if spec.shape and spec.shape[0] == -1:
        val = val.reshape(val.shape[0] * p, *val.shape[2:])[keep]
      compacted.append(val)
    return compacted

  def _recv(self) -> List[Any]:
    """Pop the oldest pending batch and transfer it to host."""
    if not self._pending:
      raise RuntimeError("recv called with no pending send/reset")
    host = []
    # multiplayer appends a live-player-count column past the state keys
    outs = self._pending.popleft()
    keys = self._state_keys + [""] * (len(outs) - len(self._state_keys))
    for k, o in zip(keys, outs):
      if k in self._container_keys:
        # padded (data, shape) -> ragged object column: each env's value
        # sliced to its actual dims (the reference's container surface)
        data, shp = _to_numpy(o[0]), _to_numpy(o[1])
        col = np.empty(len(data), dtype=object)
        for i in range(len(data)):
          col[i] = data[i][tuple(slice(int(d)) for d in shp[i])]
        host.append(col)
      else:
        host.append(_to_numpy(o))
    if self._multi_player:
      host = self._compact_players(host)
    return host

  def _reset(self, env_id: np.ndarray) -> None:
    """Enqueue a forced reset for the given env ids.

    In async mode the ids are split into batch_size cohorts so each recv
    returns one batch, matching the reference's StateBufferQueue.
    """
    env_id = np.asarray(env_id, dtype=np.int32)
    if len(env_id) == self._num_envs and self._batch_size == self._num_envs:
      chunks = [None]
    else:
      bs = self._batch_size
      chunks = [env_id[i:i + bs] for i in range(0, len(env_id), bs)]
    for chunk in chunks:
      self._state, outs = self._advance_ids(self._state, None, chunk, True)
      self._pending.append(outs)
      self._last_out = outs

  # -------------------------------------------------------------- functional

  def xla(self) -> Tuple[XlaHandle, Callable, Callable, Callable]:
    """Return ``(handle, recv, send, step)``: pure functions over a handle.

    Counterpart of ``TpuEnvPool.xla``. The handle holds the pool state as
    device tensors, so a rollout loop keeps everything on the device:

      handle = send(handle, action, env_id=None)
      handle, states = recv(handle)
      handle, states = step(handle, action, env_id=None)

    The handle is a snapshot: host-API sends after ``xla()`` do not affect
    it, and its steps do not affect the host pool until ``commit``.
    """
    if self._multi_player:
      # same gate as the reference (envpool/core/py_envpool.h:220-238)
      raise RuntimeError("xla() does not support multi-player envs")
    if self._container_keys:
      # same gate as the reference (py_envpool.h:226-231)
      raise RuntimeError("xla() does not support container-type specs")
    env_action_keys = self._env_action_keys
    device = self.device

    def _adict(action: Any) -> Dict[str, torch.Tensor]:
      if not isinstance(action, dict):
        action = {env_action_keys[0]: action}
      return {
        k: torch.as_tensor(action[k]).to(device) for k in env_action_keys
      }

    def send(handle: XlaHandle, action: Any, env_id=None) -> XlaHandle:
      new_ps, outs = self._advance_ids(handle.pool, _adict(action), env_id, False)
      return XlaHandle(pool=new_ps, out=tuple(outs))

    def recv(handle: XlaHandle) -> Tuple[XlaHandle, Tuple[torch.Tensor, ...]]:
      return handle, handle.out

    def step(handle: XlaHandle, action: Any, env_id=None):
      return recv(send(handle, action, env_id))

    if self._last_out is not None and len(
      self._last_out[0]
    ) == self._batch_size:
      out0 = tuple(self._last_out)
    else:
      # zero-filled output slot shaped like one recv batch
      out0 = tuple(
        torch.zeros(
          (self._batch_size, *s.static_shape), dtype=_torch_dtype(s.dtype),
          device=device,
        )
        for s in self._spec._state_spec
      )
    pool0 = tree_map(torch.clone, self._state)
    return XlaHandle(pool=pool0, out=out0), recv, send, step

  def commit(self, handle: XlaHandle) -> None:
    """Adopt an ``xla()`` handle's pool state as the host-side state."""
    if self._multi_player:
      # same gate as the JAX package's commit()
      raise RuntimeError("commit() does not support multi-player envs")
    self._state = tree_map(torch.clone, handle.pool)
    self._pending.clear()
    self._last_out = None

  # --------------------------------------------------------------- properties

  @property
  def config(self) -> Dict[str, Any]:
    return dict(zip(self._spec._config_keys, self._spec._config_values))

  def save_state(self) -> PoolState:
    """Snapshot the pool state as numpy arrays, laid out like the JAX
    package's ``save_state()`` (uint32 keys), so either package loads it."""
    st = self._state
    return PoolState(
      env=tree_map(_to_numpy, st.env),
      rng=_to_numpy(st.rng).astype(np.uint32),
      elapsed=_to_numpy(st.elapsed),
      done=_to_numpy(st.done),
    )

  def load_state(self, state: Any) -> None:
    """Restore a snapshot produced by ``save_state`` of either package."""
    self._state = state_from_numpy(state, self.device)
    self._pending.clear()


def _gather(outs: List[Any], env_id: torch.Tensor) -> List[Any]:
  """The rows ``env_id`` of every output (container pairs included)."""
  return [tree_map(lambda o: o[env_id], o) for o in outs]


def _split_keys(rng: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """Advance a [N, 2] batch of keys, returning (carry, use)."""
  both = prng.split(rng, 2)
  return both[:, 0], both[:, 1]


def _torch_dtype(dtype: Any) -> torch.dtype:
  return torch.from_numpy(np.zeros((), dtype=dtype)).dtype
