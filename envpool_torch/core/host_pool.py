"""HostEnvPool — the port's batched engine for host-native env families.

The port's copy of ``envpool_tpu/core/host_pool.py``. Some families wrap
C libraries that run only on the host (MuJoCo's ``mj_step``, ALE's 6502
emulator): no CUDA rewrite absorbs them, and the reference runs them on
worker threads (``envpool/core/async_envpool.h:42-191``). This engine is
the port's counterpart of that tier: stateful per-env Python objects
stepped by a worker-thread pool (the wrapped C libraries release the GIL,
so threads scale as the reference's do), behind the same EnvSpec/dialect
API as the on-device ``TorchEnvPool``, plus an ``xla()`` interface whose
``send`` crosses to the card in stream order (page-locked copies around a
host function, a host node of a captured graph), the counterpart of the
reference's XLA custom-call host bridge (``envpool/core/xla.h:113-210``)
and of the JAX package's ``io_callback(..., ordered=True)``.

Execution design (mirrors the reference's, not a Python ThreadPoolExecutor
translation — the executor's per-task future machinery and per-row dict
building cost more than the env steps themselves):

- an action queue (``queue.SimpleQueue``, C-implemented, the counterpart of
  ``action_buffer_queue.h:35-85``) feeds persistent worker threads;
- results land in pre-allocated **state blocks** — one set of column arrays
  per outgoing batch, written in place by workers and handed to the
  consumer zero-copy, the counterpart of ``state_buffer.h:42-160``'s
  ``StateBuffer`` (fresh blocks are created by the producer per send, like
  the reference's stock-creator thread, so consumer-held arrays are never
  overwritten);
- per-row completion is signalled on the block's semaphore; ``recv`` waits
  for the block to fill, exactly ``StateBuffer::Wait`` (:126-131).

Semantics reproduced from the reference runtime:
- sync mode (batch_size == num_envs): recv returns all envs ordered by
  their position in the send batch (``envpool/core/state_buffer.h:94-97``)
  — workers write ``slot = order``;
- async mode (batch_size < num_envs): recv returns the first batch_size
  FINISHERS in completion order (``envpool/core/state_buffer_queue.h:
  116-130``) — workers take ``slot = next completion position`` and fill
  block ``pos // batch``;
- auto-reset: a done env's next scheduled step becomes Reset
  (``envpool/core/env.h:162-172``);
- common fields done/discount/step_type/trunc/elapsed_step/env_id exactly
  as ``envpool/core/env.h:196-222``;
- per-env RNG: numpy MT19937(seed + env_id), the same generator family as
  the reference's ``std::mt19937`` (``envpool/core/env.h:90-95``);
- worker sizing: num_threads config, default min(batch_size, cores)
  (``envpool/core/async_envpool.h:114-116``);
- teardown: poison pills, one per worker (``async_envpool.h:145-155``).

The host API (``send``/``recv``/``step``/``reset``) returns numpy and never
touches the card, except that after ``xla()`` has queued host steps on the
card it first waits for the device (``torch.cuda.synchronize``, which
releases the GIL), so that it never interleaves with a queued host step.
``device`` (default: the CUDA device; it raises without one unless the
caller asks for ``"cpu"``) is where ``xla()`` puts its outputs.
"""

from __future__ import annotations

import atexit
import itertools
import os
import queue
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import graph
from .env_spec import EnvSpec
from .pool import _torch_dtype, resolve_device
from .spec import ArraySpec


class HostEnv:
  """Base class for host-native stateful env families.

  Class-level schema hooks are identical to ``FuncEnv`` (default_config /
  state_spec / action_spec / name); instances hold per-env mutable state
  like the reference's ``Env<Spec>`` subclasses and implement:

    reset(self) -> (obs, info_dict)
    step(self, action) -> (obs, reward, term, info_dict)

  ``obs`` is an array for single-"obs" specs or a dict keyed without the
  "obs:" prefix. Time-limit truncation is handled by the pool.
  """

  name: str = "Host"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    raise NotImplementedError

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    raise NotImplementedError

  def __init__(self, cfg: Any, env_id: int) -> None:
    self.cfg = cfg
    self.env_id = env_id
    # same generator family as std::mt19937(seed + env_id)
    self.gen = np.random.Generator(np.random.MT19937(int(cfg.seed) + env_id))

  def reset(self) -> Tuple[Any, Dict[str, Any]]:
    raise NotImplementedError

  def step(self, action: Any) -> Tuple[Any, float, bool, Dict[str, Any]]:
    raise NotImplementedError


# Live pools, drained at interpreter exit: a worker still executing inside
# a wrapped C library (mj_step, ALE) while CPython finalizes is a segfault.
_live_pools: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _drain_workers_at_exit() -> None:
  for pool in list(_live_pools):
    try:
      pool._shutdown(join=True)
    except Exception:
      pass


class _StateBlock:
  """One outgoing batch's pre-allocated column arrays (a StateBuffer).

  Completion is a single semaphore release by the LAST finishing row
  (an atomic itertools.count under the GIL), not one release per row:
  per-row sem traffic was ~15 us of GIL-held time per row, a measurable
  slice of the thread-scaling budget (host tier is GIL-bound between
  mj_step calls)."""

  __slots__ = (
    "cols", "capacity", "sem", "errors", "_countdown", "common", "plan",
  )

  def __init__(
    self, layout: List[Tuple[str, Tuple[int, ...], Any]], capacity: int,
    env_plan: Optional[List[Tuple[str, int, str]]] = None,
  ) -> None:
    self.cols = {k: np.empty((capacity, *shp), dt) for k, shp, dt in layout}
    self.capacity = capacity
    # a zero-row batch has no finishing row to release the semaphore, so
    # start it released — recv of an empty send/reset must not deadlock
    self.sem = threading.Semaphore(0 if capacity else 1)
    self.errors: List[BaseException] = []
    self._countdown = itertools.count(1)
    # column refs prebound once per BLOCK so the per-ROW write path does
    # no dict hashing (the host tier is GIL-bound between env steps;
    # every per-row lookup is serialized across all workers)
    cols = self.cols
    self.common = (
      cols["info:env_id"],
      cols.get("info:players.env_id"),
      cols["elapsed_step"],
      cols["done"],
      cols["reward"],
      cols["discount"],
      cols["step_type"],
      cols["trunc"],
    )
    self.plan = (
      tuple((cols[k], kind, sub) for k, kind, sub in env_plan)
      if env_plan else ()
    )

  def row_done(self) -> None:
    if next(self._countdown) == self.capacity:
      self.sem.release()


class HostEnvPool:
  """Worker-thread batched engine with envpool's send/recv/reset protocol."""

  _spec: EnvSpec

  def __init__(
    self, spec: EnvSpec, device: Union[None, str, torch.device] = None
  ) -> None:
    self.device = resolve_device(device)
    self._spec = spec
    self.spec = spec
    cfg = spec.config
    self._cfg = cfg
    self._num_envs = int(cfg.num_envs)
    self._batch_size = int(cfg.batch_size) or self._num_envs
    if int(cfg.max_num_players) != 1:
      raise NotImplementedError("multi-player host envs not supported yet")
    self._is_sync = self._batch_size == self._num_envs
    num_threads = int(cfg.num_threads)
    if num_threads <= 0:
      num_threads = min(self._batch_size, os.cpu_count() or 1)
    self._n_workers = num_threads
    env_cls = spec._env_cls

    # parallel env construction, like the init ThreadPool in
    # AsyncEnvPool's ctor (async_envpool.h:104-113)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=num_threads) as ctor_pool:
      self._envs: List[HostEnv] = list(
        ctor_pool.map(lambda i: env_cls(cfg, i), range(self._num_envs))
      )
    self._locks = [threading.Lock() for _ in range(self._num_envs)]
    self._done = np.ones(self._num_envs, dtype=bool)   # auto-reset on first
    self._elapsed = np.zeros(self._num_envs, dtype=np.int64)
    self._max_steps = int(cfg.max_episode_steps)

    self._state_keys = spec._state_keys
    self._action_keys = spec._action_keys
    self._env_action_keys = [
      k for k in self._action_keys if k not in ("env_id", "players.env_id")
    ]
    self._env_state_keys = [
      k for k in self._state_keys
      if k not in (
        "info:env_id", "info:players.env_id", "elapsed_step", "done",
        "reward", "discount", "step_type", "trunc"
      )
    ]
    # per-key write plan resolved ONCE (kind 0=whole obs, 1=obs sub-key,
    # 2=info/bare key) — the per-row string dispatch it replaces cost
    # GIL time on every row of every step
    self._env_plan: List[Tuple[str, int, str]] = []
    for k in self._env_state_keys:
      if k == "obs":
        self._env_plan.append((k, 0, ""))
      elif k.startswith("obs:"):
        self._env_plan.append((k, 1, k[4:]))
      elif k.startswith("info:"):
        self._env_plan.append((k, 2, k[5:]))
      else:
        self._env_plan.append((k, 2, k))
    self._layout = [
      (k, tuple(s.static_shape), s.dtype)
      for k, s in zip(self._state_keys, spec._state_spec)
    ]
    # xla()'s page-locked sets and host-step requests on the card, made at
    # its first send there
    self._bridge: Optional[_Bridge] = None
    # (start, end) CUDA events and byte count of the last eager xla() send's
    # host-to-device copies, for timing them
    self.last_copy: Optional[Tuple[Any, Any, int]] = None

    # --- block bookkeeping (producer side; see module docstring) ---
    # blocks are indexed by creation order; recv consumes them in order.
    self._block_map: Dict[int, _StateBlock] = {}
    self._blocks_created = 0
    self._rows_capacity = 0     # total rows across created blocks
    self._rows_submitted = 0
    self._next_recv = 0
    self._inflight = 0
    # async completion-position counter (next() is atomic under the GIL)
    self._complete_pos = itertools.count()

    self._work: "queue.SimpleQueue" = queue.SimpleQueue()
    self._workers = [
      threading.Thread(target=self._worker_loop, daemon=True)
      for _ in range(num_threads)
    ]
    for w in self._workers:
      w.start()
    _live_pools.add(self)

  def _shutdown(self, join: bool = False) -> None:
    """Poison-pill the workers (``async_envpool.h:145-155``).

    ``join=True`` additionally waits for them to drain — used by the
    atexit hook so no worker is still inside a C library (mj_step etc.)
    while the interpreter tears itself down (that is a segfault).
    """
    work = getattr(self, "_work", None)
    if work is None:
      return
    for _ in getattr(self, "_workers", ()):
      work.put(None)
    if join:
      for w in getattr(self, "_workers", ()):
        w.join(timeout=5.0)

  def __del__(self) -> None:
    try:
      self._shutdown()
    except Exception:
      pass  # interpreter teardown: queue module may already be gone

  # ------------------------------------------------------------------ worker

  def _worker_loop(self) -> None:
    work = self._work
    while True:
      item = work.get()
      if item is None:
        return
      self._job(*item)

  def _job(
    self, env_id: int, order: int, block: Optional[_StateBlock],
    actions: Any, force_reset: bool,
  ) -> None:
    """One env's step/reset, writing a complete state row in place."""
    if block is None:  # async mode: first-finisher slot assignment
      pos = next(self._complete_pos)
      block = self._block_map[pos // self._batch_size]
      slot = pos % self._batch_size
    else:
      slot = order  # sync mode: ordered writes (state_buffer.h:94-97)
    try:
      with self._locks[env_id]:
        env = self._envs[env_id]
        reset = force_reset or self._done[env_id]
        if reset:
          obs, info = env.reset()
          reward = 0.0
          elapsed = 0
          term = False
        else:
          if actions is None:
            action = None
          elif isinstance(actions, dict):
            action = {k: v[order] for k, v in actions.items()}
          else:
            action = actions[order]
          obs, reward, term, info = env.step(action)
          elapsed = int(self._elapsed[env_id]) + 1
        done = bool(term) or elapsed >= self._max_steps
        self._done[env_id] = done
        self._elapsed[env_id] = elapsed
        (c_eid, c_peid, c_el, c_done, c_rew, c_disc, c_st, c_tr) = (
          block.common
        )
        c_eid[slot] = env_id
        if c_peid is not None:
          c_peid[slot] = env_id
        c_el[slot] = elapsed
        c_done[slot] = done
        c_rew[slot] = reward
        c_disc[slot] = 0.0 if done else 1.0
        c_st[slot] = 0 if elapsed == 0 else (2 if done else 1)
        c_tr[slot] = done and elapsed >= self._max_steps
        for col, kind, sub in block.plan:
          if kind == 0:
            col[slot] = obs
          elif kind == 1:
            col[slot] = obs[sub]
          else:
            col[slot] = info[sub]
        # envs may override common fields (e.g. atari's episodic-life
        # elapsed_step/trunc/discount rewrites, atari_env.h:210-250)
        override = info.get("_override") if isinstance(info, dict) else None
        if override:
          cols = block.cols
          for k, v in override.items():
            cols[k][slot] = v
          if "done" in override:
            self._done[env_id] = bool(override["done"])
          if "elapsed_step" in override:
            self._elapsed[env_id] = int(override["elapsed_step"])
    except BaseException as e:  # surface worker errors at recv
      block.errors.append(e)
    block.row_done()

  # ------------------------------------------------------------- protocol

  def _submit(
    self, env_ids: np.ndarray, actions: Any, force_reset: bool
  ) -> None:
    """Create state block(s) for n rows, then enqueue one item per env.

    Blocks are created BEFORE their rows are enqueued, so async workers
    indexing ``_block_map[pos // batch]`` always find the block.
    """
    n = len(env_ids)
    if self._is_sync:
      # one block per send, sized to it (partial sync batches allowed —
      # the phantom-done equivalent of async_envpool.h:163-175)
      block: Optional[_StateBlock] = _StateBlock(
        self._layout, n, self._env_plan
      )
      self._block_map[self._blocks_created] = block
      self._blocks_created += 1
    else:
      block = None
      self._rows_submitted += n
      while self._rows_capacity < self._rows_submitted:
        self._block_map[self._blocks_created] = _StateBlock(
          self._layout, self._batch_size, self._env_plan
        )
        self._blocks_created += 1
        self._rows_capacity += self._batch_size
    self._inflight += n
    put = self._work.put
    for order in range(n):
      put((int(env_ids[order]), order, block, actions, force_reset))

  def _await_bridge(self) -> None:
    """Before a host-API call: let the host steps that ``xla()`` queued on
    the card run first (the wait releases the GIL, which they take), then
    raise the first of their errors. A no-op inside a host step."""
    bridge = self._bridge
    if bridge is None or getattr(_in_host_step, "active", False):
      return
    if bridge.queued:
      torch.cuda.synchronize(self.device)
    bridge.raise_error()

  def _send(self, action_list: List[np.ndarray]) -> None:
    self._await_bridge()
    adict = dict(zip(self._action_keys, action_list))
    env_ids = np.asarray(adict["env_id"], dtype=np.int64)
    if len(self._env_action_keys) == 1:
      actions: Any = np.asarray(adict[self._env_action_keys[0]])
    else:
      actions = {k: np.asarray(adict[k]) for k in self._env_action_keys}
    self._submit(env_ids, actions, False)

  def _reset(self, env_id: np.ndarray) -> None:
    self._await_bridge()
    self._submit(np.asarray(env_id), None, True)

  def _recv(self) -> List[np.ndarray]:
    self._await_bridge()
    if self._inflight == 0:
      raise RuntimeError("recv called with no pending send/reset")
    # look up WITHOUT popping: async workers resolve their block from
    # _block_map at completion time, so the entry must stay visible until
    # every row has been written (the sem wait below guarantees that)
    block = self._block_map[self._next_recv]
    block.sem.acquire()  # released once, by the last finishing row
    del self._block_map[self._next_recv]
    self._next_recv += 1
    self._inflight -= block.capacity
    if not self._is_sync:
      self._rows_submitted -= block.capacity
      self._rows_capacity -= block.capacity
    if block.errors:
      raise block.errors[0]
    cols = block.cols
    return [cols[k] for k in self._state_keys]

  # ------------------------------------------------------------------ bridge

  def _host_step(self, action: Dict[str, np.ndarray], ids: np.ndarray) -> List[np.ndarray]:
    """``xla()``'s host step, ``host_step`` of the JAX package's
    ``io_callback``: ``_send`` of the action columns (by key) to the envs
    ``ids``, then ``_recv``; returns the received columns. On the CPU
    ``send`` calls it; on the card a host function does, in stream order."""
    alist = []
    for k in self._action_keys:
      if k in ("env_id", "players.env_id"):
        alist.append(np.asarray(ids, np.int32))
      else:
        alist.append(np.asarray(action[k]))
    self._send(alist)
    return self._recv()

  def _run_host_step(self, action: Dict[str, np.ndarray], ids: np.ndarray,
                     outs: List[np.ndarray]) -> None:
    """The host function's body: the host step, its columns written into
    the page-locked output set. No CUDA call; an error is kept for the
    next host-API call or ``send``, or the graph that holds the step, and
    the pool is not stepped again until it has been raised."""
    if self._bridge.errors:
      return
    _in_host_step.active = True
    try:
      for dst, col in zip(outs, self._host_step(action, ids)):
        np.copyto(dst[:len(col)], col)
    except Exception as e:  # raised later, on the caller's thread
      self._bridge.errors.append(e)
    finally:
      _in_host_step.active = False

  def xla(self) -> Tuple[Any, Callable, Callable, Callable]:
    """Return ``(handle, recv, send, step)`` with the JAX signature.

    The counterpart of the JAX package's ``io_callback(..., ordered=True)``
    bridge and of ``envpool/core/xla.h:132-209``. The handle is ``(sends
    made, outputs)``, the count an int32 tensor on the pool's device; unlike
    the on-device pool's, the env state lives in this pool, not in the
    handle. ``send(handle, action, env_id=None)`` runs ``_host_step``:

    - on the CPU, directly, the received columns wrapped without a copy;
    - on the card, in stream order on the current stream, which returns at
      once and makes no host read: the action columns and the ids are
      copied into a page-locked input set, a host function runs the host
      step and writes every column into a page-locked output set, and the
      columns are copied into fresh device tensors, so an output handed out
      is never written again. Under capture the same calls become two
      copies around a host node (``graph.launch_host_func``), so
      ``graph.scan`` and ``CapturedScan`` hold the host step; their warm-up
      call queues no host step. The sets are reused in stream order: keep
      every send of the pool on one stream, or order the streams.

    A host-API call (``send``/``recv``/``step``/``reset``) after a send on
    the card first waits for the device. A host step that fails keeps its
    error and the pool steps no further: the next ``send`` or host-API call
    raises it, and so does a captured graph that holds the step, after its
    replay (``graph.CapturedScan``/``CapturedCall`` then wait for the
    stream). Outputs of the failed send, and of any send queued behind it,
    are stale.
    """
    all_ids = torch.arange(self._num_envs, dtype=torch.int32, device=self.device)

    def send(handle, action, env_id=None):
      if not isinstance(action, dict):
        action = {self._env_action_keys[0]: action}
      if self.device.type == "cpu":
        ids = all_ids.numpy() if env_id is None else _host(env_id).astype(np.int32)
        cols = self._host_step({k: _host(action[k]) for k in self._env_action_keys}, ids)
        outs = tuple(torch.from_numpy(c) for c in cols)
      else:
        if self._bridge is None:
          self._bridge = _Bridge(self)
        self._bridge.raise_error()
        ids = all_ids if env_id is None else _on(env_id, self.device).to(torch.int32)
        outs = self._bridge.send(
          self, {k: _on(action[k], self.device) for k in self._env_action_keys},
          ids.contiguous())
      return (handle[0] + 1, outs)

    def recv(handle):
      return handle, handle[1]

    def step(handle, action, env_id=None):
      return recv(send(handle, action, env_id))

    handle0 = (torch.zeros((), dtype=torch.int32, device=self.device), tuple(
      torch.zeros(
        (self._batch_size, *s.static_shape), dtype=_torch_dtype(s.dtype),
        device=self.device,
      )
      for s in self._spec._state_spec
    ))
    return handle0, recv, send, step

  # ---------------------------------------------------------------- properties

  @property
  def config(self) -> Dict[str, Any]:
    return dict(zip(self._spec._config_keys, self._spec._config_values))


def _host(x: Any) -> np.ndarray:
  """An action or id batch as numpy on the host (CPU pools)."""
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def _on(x: Any, device: torch.device) -> torch.Tensor:
  """An action or id batch as a contiguous tensor on ``device`` (host data
  is copied there first, eagerly)."""
  if not isinstance(x, torch.Tensor):
    x = torch.as_tensor(np.asarray(x))
  return x.detach().to(device).contiguous()


# set on the thread that runs a host step, whose host-API calls must not
# wait for the device (the step itself is what the device waits for)
_in_host_step = threading.local()

# request id -> (pool, action views, id view, output views); ids are handed
# to host functions as their data and never reused, and an entry holds its
# pool weakly (a finalizer drops the pool's entries)
_requests: Dict[int, Tuple[Any, Dict[str, np.ndarray], np.ndarray, List[np.ndarray]]] = {}
_request_ids = itertools.count(1)


def _run_request(data: Optional[int]) -> None:
  """Every host function of the bridge: the request ``data``'s host step.
  It runs on CUDA's callback thread, with the GIL that ctypes takes."""
  entry = _requests.get(data or 0)
  if entry is None:
    return
  ref, action, ids, outs = entry
  pool = ref()
  if pool is not None:
    pool._run_host_step(action, ids, outs)


# the one C callback of every request, alive for the process (graphs hold it)
_RUN_REQUEST = graph.HOST_FN(_run_request)


def _drop_requests(ids: List[int]) -> None:
  for i in ids:
    _requests.pop(i, None)


class _Bridge:
  """The card side of one pool's ``xla()``: a page-locked input set (each
  action column and the env ids, ``num_envs`` rows), a page-locked output
  set (every column, ``batch_size`` rows), both reused in stream order, and
  one host-step request per shape of send (rows, action dtypes and shapes)."""

  def __init__(self, pool: HostEnvPool) -> None:
    self.device = pool.device
    self.ids = torch.empty(pool._num_envs, dtype=torch.int32, pin_memory=True)
    self.outs = [
      torch.empty((pool._batch_size, *shp), dtype=_torch_dtype(dt), pin_memory=True)
      for _, shp, dt in pool._layout
    ]
    self.ins: Dict[Tuple[str, torch.dtype, Tuple[int, ...]], torch.Tensor] = {}
    self.requests: Dict[Tuple[Any, ...], int] = {}
    self.queued = False  # a host step was queued, eagerly or into a graph
    self.errors: List[BaseException] = []
    self._request_ids: List[int] = []
    weakref.finalize(pool, _drop_requests, self._request_ids)

  def raise_error(self) -> None:
    if self.errors:
      err, self.errors = self.errors[0], []
      raise RuntimeError("a host step of xla() failed on the host") from err

  def _request(self, pool: HostEnvPool, shape: Tuple[Any, ...],
               action: Dict[str, torch.Tensor], rows: int) -> int:
    m = shape[0]
    views = {}
    for k, a in action.items():
      key = (k, a.dtype, tuple(a.shape[1:]))
      if key not in self.ins:
        self.ins[key] = torch.empty((pool._num_envs, *key[2]), dtype=a.dtype,
                                    pin_memory=True)
      views[k] = self.ins[key][:m].numpy()
    rid = next(_request_ids)
    _requests[rid] = (weakref.ref(pool), views, self.ids[:m].numpy(),
                      [o[:rows].numpy() for o in self.outs])
    self._request_ids.append(rid)
    self.requests[shape] = rid
    return rid

  def send(self, pool: HostEnvPool, action: Dict[str, torch.Tensor],
           ids: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Queue one host step on the current stream; -> its output columns."""
    dev, m = self.device, ids.shape[0]
    if ids.dim() != 1 or not 0 < m <= pool._num_envs:
      raise ValueError(f"env_id must hold 1 to {pool._num_envs} ids, got {tuple(ids.shape)}")
    for k, a in action.items():
      if a.dim() == 0 or a.shape[0] != m:
        raise ValueError(f"action {k!r} of shape {tuple(a.shape)} for {m} env ids")
    rows = m if pool._is_sync else pool._batch_size
    shape = (m, tuple((k, a.dtype, tuple(a.shape)) for k, a in action.items()))
    rid = self.requests.get(shape)
    if rid is None:
      rid = self._request(pool, shape, action, rows)
    for k, a in action.items():
      buf = self.ins[(k, a.dtype, tuple(a.shape[1:]))]
      graph.copy_async(buf.data_ptr(), a.data_ptr(), a.numel() * a.element_size(),
                       False, dev)
    graph.copy_async(self.ids.data_ptr(), ids.data_ptr(), 4 * m, False, dev)
    if not graph.is_warming():
      graph.launch_host_func(_RUN_REQUEST, rid, dev, check=self.raise_error)
      self.queued = True
    outs = tuple(torch.empty((rows, *b.shape[1:]), dtype=b.dtype, device=dev)
                 for b in self.outs)
    stream = torch.cuda.current_stream(dev)
    timed = not torch.cuda.is_current_stream_capturing()
    if timed:
      start = torch.cuda.Event(enable_timing=True)
      start.record(stream)
    n_bytes = 0
    for out, buf in zip(outs, self.outs):
      nb = out.numel() * out.element_size()
      graph.copy_async(out.data_ptr(), buf.data_ptr(), nb, True, dev)
      n_bytes += nb
    if timed:
      end = torch.cuda.Event(enable_timing=True)
      end.record(stream)
      pool.last_copy = (start, end, n_bytes)
    return outs
