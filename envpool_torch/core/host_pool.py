"""HostEnvPool — the port's batched engine for host-native env families.

The port's copy of ``envpool_tpu/core/host_pool.py``. Some families wrap
C libraries that run only on the host (MuJoCo's ``mj_step``, ALE's 6502
emulator): no CUDA rewrite absorbs them, and the reference runs them on
worker threads (``envpool/core/async_envpool.h:42-191``). This engine is
the port's counterpart of that tier: stateful per-env Python objects
stepped by a worker-thread pool (the wrapped C libraries release the GIL,
so threads scale as the reference's do), behind the same EnvSpec/dialect
API as the on-device ``TorchEnvPool``, plus an ``xla()`` interface whose
``send`` crosses to the card through page-locked staging buffers, the
counterpart of the reference's XLA custom-call host bridge
(``envpool/core/xla.h:113-210``) and of the JAX package's ``io_callback``.

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
touches the card. ``device`` (default: the CUDA device; it raises without
one unless the caller asks for ``"cpu"``) is where ``xla()`` puts its
outputs.
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
    # xla()'s page-locked staging sets, made at its first send
    self._ring: Optional[_PinnedRing] = None
    # (start, end) CUDA events and byte count of the last xla() send's
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

  def _send(self, action_list: List[np.ndarray]) -> None:
    adict = dict(zip(self._action_keys, action_list))
    env_ids = np.asarray(adict["env_id"], dtype=np.int64)
    if len(self._env_action_keys) == 1:
      actions: Any = np.asarray(adict[self._env_action_keys[0]])
    else:
      actions = {k: np.asarray(adict[k]) for k in self._env_action_keys}
    self._submit(env_ids, actions, False)

  def _reset(self, env_id: np.ndarray) -> None:
    self._submit(np.asarray(env_id), None, True)

  def _recv(self) -> List[np.ndarray]:
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

  def _to_device(self, cols: List[np.ndarray]) -> Tuple[torch.Tensor, ...]:
    """One recv's columns -> tensors on the pool's device.

    On the CPU the fresh block's arrays are wrapped without a copy: a block
    is never written again once received. On the card each column goes
    through a page-locked staging buffer and a ``non_blocking`` copy (a
    pageable ``.to(device)`` would stage and synchronise on its own), into
    a fresh device tensor, so outputs the caller holds are never
    overwritten. The staging set is reused only after the CUDA event of its
    last copy has completed.
    """
    if self.device.type == "cpu":
      return tuple(torch.from_numpy(c) for c in cols)
    if self._ring is None:
      # allocated once: pin_memory per step would be a cudaHostAlloc each
      self._ring = _PinnedRing(self._layout, self._batch_size)
    n = len(cols[0])
    stage = [buf[:n] for buf in self._ring.take()]
    for col, buf in zip(cols, stage):
      np.copyto(buf.numpy(), col)
    # allocated before the copies are queued, so that the events below
    # time the copies alone
    outs = tuple(
      torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
      for buf in stage
    )
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    for out, buf in zip(outs, stage):
      out.copy_(buf, non_blocking=True)
    end = self._ring.copied()
    self.last_copy = (start, end, sum(col.nbytes for col in cols))
    return outs

  def xla(self) -> Tuple[Any, Callable, Callable, Callable]:
    """Return ``(handle, recv, send, step)`` with the JAX signature.

    The counterpart of the JAX package's ``io_callback`` bridge and of
    ``envpool/core/xla.h:132-209``. ``send(handle, action, env_id=None)``
    copies the action to the host (the workers must see it, so a card
    tensor is read back here: that synchronisation cannot be avoided), runs
    ``_send`` and ``_recv`` on this pool, and copies every output column to
    the pool's device. The handle is ``(sends made, outputs)``; unlike the
    on-device pool's, the env state lives in this pool, not in the handle.
    """
    all_ids = np.arange(self._num_envs, dtype=np.int32)

    def send(handle, action, env_id=None):
      if not isinstance(action, dict):
        action = {self._env_action_keys[0]: action}
      ids = all_ids if env_id is None else _host(env_id).astype(np.int32)
      alist = []
      for k in self._action_keys:
        if k in ("env_id", "players.env_id"):
          alist.append(ids)
        else:
          alist.append(_host(action[k]))
      self._send(alist)
      return (handle[0] + 1, self._to_device(self._recv()))

    def recv(handle):
      return handle, handle[1]

    def step(handle, action, env_id=None):
      return recv(send(handle, action, env_id))

    handle0 = (0, tuple(
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
  """An action or id batch as numpy on the host (a card tensor is read
  back, which waits for the work queued before it)."""
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


class _PinnedRing:
  """``depth`` sets of page-locked staging tensors, one per output column
  of a full batch, used in turn by ``HostEnvPool._to_device``.

  A set's copies to the card are still in flight when the next send
  begins; the next set takes that send, and a set is reused only after the
  CUDA event recorded behind its copies has completed."""

  def __init__(
    self, layout: List[Tuple[str, Tuple[int, ...], Any]], rows: int,
    depth: int = 2,
  ) -> None:
    self.sets = [
      [
        torch.empty((rows, *shp), dtype=_torch_dtype(dt), pin_memory=True)
        for _, shp, dt in layout
      ]
      for _ in range(depth)
    ]
    self.events: List[Optional[torch.cuda.Event]] = [None] * depth
    self._next = 0

  def take(self) -> List[torch.Tensor]:
    """The next set, once the copies out of it have landed."""
    ev = self.events[self._next]
    if ev is not None:
      ev.synchronize()
    return self.sets[self._next]

  def copied(self) -> torch.cuda.Event:
    """Record the event behind the copies out of the set just taken, and
    move on to the next set."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    self.events[self._next] = ev
    self._next = (self._next + 1) % len(self.sets)
    return ev
