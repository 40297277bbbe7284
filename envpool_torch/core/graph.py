"""The compiled rollout: ``jax.jit``, ``lax.scan``, ``lax.cond`` and
``lax.while_loop`` for the port, as CUDA graphs.

The JAX package compiles a whole rollout into one XLA program
(``envpool_tpu/core/pool.py:494-505``: ``xla()`` "usable inside ``jit``").
Here a step is captured once into a ``torch.cuda.CUDAGraph`` and replayed:

- ``cond(pred, true_fn, false_fn, operands)``, for ``jax.lax.cond``. Eager
  (the CPU, or the card outside a capture), it reads ``pred`` once. Under
  capture it is an IF conditional node: a kernel sets the node's handle from
  ``pred`` on the device (``csrc/graph_cond.cu``), ``true_fn`` is captured
  into the node's body, and its results are copied into buffers allocated
  before the node. ``false_fn`` must then be the identity on the operands,
  which it is at every use in the port.
- ``while_loop(cond_fn, body_fn, init)``, for ``jax.lax.while_loop``: a
  WHILE node whose body re-sets the handle from ``cond_fn`` of the new carry.
- ``fori_loop(n, body_fn, init)``, for ``jax.lax.fori_loop(0, n, ...)`` with
  a static ``n`` whose body never reads the index: eagerly a plain loop,
  under capture a WHILE node over a device round counter that the set
  kernel's counted form advances, one launch per round.
- ``scan(body, carry, length)``, for
  ``jax.jit(lambda c: lax.scan(body, c, None, length))``; ``CapturedScan``
  keeps its graph for reuse. On the card the first call warms ``body`` up on
  a side stream, captures one call into a graph that reads static carry
  buffers, copies the new carry into them and writes ``y`` into row ``t`` of
  ``[length, ...]`` outputs through a device step counter it advances
  itself; then it replays the graph ``length`` times. On the CPU the same
  body runs eagerly ``length`` times.
- ``CapturedCall(fn)``, for ``jax.jit(fn)`` of a function run once per
  call (PPO's update): the same warm-up, capture and signature check, over
  static copies of its arguments.
- ``launch_host_func(fn, data, device)``, the device side of
  ``io_callback(..., ordered=True)``: a stream-ordered host callback
  eagerly, a host node under capture (``csrc/host_func.cu``), with
  ``copy_async`` for the page-locked copies around it. The host tier's
  ``xla()`` runs its host step through it. A host function cannot raise
  into the stream: it keeps its error, and a graph that holds host nodes
  waits for its stream after each replay and raises it.

A predicate is a bool tensor and the branch runs where any of its elements
is set (a one-element tensor is the plain ``lax.cond``): the set-handle
kernel fuses the ``any``. PyTorch's own ``CUDAGraph.begin_capture_to_if_node``
takes a one-element predicate (an ``any`` launch before it) and has no WHILE
counterpart, so both node kinds go through the one kernel and one memory
rule: every body is captured on a stream of its own (one per nesting
depth, made by ``cudaStreamCreate`` and never one of PyTorch's pooled
streams), whose allocations come from a private pool of the graph, never
from the normal pool; the pools live as long as the graph.

Every graph counts its nodes (``nodes``; conditional bodies and host nodes
included, ``host_nodes`` apart). A capture that fails raises; nothing falls
back to the eager loop.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

_IF, _WHILE = 0, 1
# the set kernel's forms (csrc/graph_cond.cu); _EMPTY launches an empty
# kernel and leaves the handle at 0, the floor of a one-launch design
_ANY, _COUNTED, _EMPTY = 0, 1, 2


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
  """Map ``fn`` over the leaves of dict/tuple/namedtuple trees of equal
  shape (a container field is a plain ``(data, shape)`` tuple)."""
  if isinstance(tree, dict):
    return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
  if isinstance(tree, tuple):
    mapped = (tree_map(fn, *xs) for xs in zip(tree, *rest))
    return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
  return fn(tree, *rest)


def _leaves(tree: Any) -> List[torch.Tensor]:
  out: List[torch.Tensor] = []
  tree_map(out.append, tree)
  return out


def _capturing(t: torch.Tensor) -> bool:
  return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _host_pred(pred: torch.Tensor) -> bool:
  """The one host read of an eager ``cond`` or ``while_loop`` round."""
  return bool(pred.any())


# ---------------------------------------------------------------- the kernel

def _lib():
  from envpool_torch import _build

  lib = _build.load("graph_cond")
  if lib.graph_cond_begin.argtypes is None:
    vp, ull = ctypes.c_void_p, ctypes.c_ulonglong
    i32 = ctypes.c_int
    lib.graph_cond_begin.argtypes = [
      vp, vp, i32, i32, vp, i32, ctypes.POINTER(ull), ctypes.POINTER(vp),
    ]
    lib.graph_cond_set.argtypes = [vp, ull, i32, vp, i32]
    lib.graph_cond_end.argtypes = [vp, vp]
    lib.graph_cond_nodes.argtypes = [vp, ctypes.POINTER(ull)]
    lib.graph_cond_stream.argtypes = [ctypes.POINTER(vp)]
    for fn in (lib.graph_cond_begin, lib.graph_cond_set, lib.graph_cond_end,
               lib.graph_cond_nodes, lib.graph_cond_stream):
      fn.restype = ctypes.c_int
    lib.graph_cond_failed.argtypes = []
    lib.graph_cond_failed.restype = ctypes.c_char_p
  return lib


def _check(err: int, what: str) -> None:
  if err != 0:
    where = _lib().graph_cond_failed().decode()
    raise RuntimeError(f"{what} failed: CUDA error {err} at {where}")


# ------------------------------------------------------ host functions

#: the C type of a host function: ``void fn(void* data)``
HOST_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def _host_lib():
  from envpool_torch import _build

  lib = _build.load("host_func")
  if lib.host_func_launch.argtypes is None:
    vp = ctypes.c_void_p
    lib.host_func_launch.argtypes = [vp, HOST_FN, vp]
    lib.host_func_copy.argtypes = [vp, vp, vp, ctypes.c_size_t, ctypes.c_int]
    for fn in (lib.host_func_launch, lib.host_func_copy):
      fn.restype = ctypes.c_int
    lib.host_func_error.argtypes = [ctypes.c_int]
    lib.host_func_error.restype = ctypes.c_char_p
  return lib


def _host_check(err: int, what: str) -> None:
  if err != 0:
    raise RuntimeError(
      f"{what} failed: CUDA error {err} ({_host_lib().host_func_error(err).decode()})")


def launch_host_func(fn: Any, data: int, device: torch.device,
                     check: Optional[Callable[[], None]] = None) -> None:
  """Queue ``fn(data)`` on the current stream of ``device``: eagerly a
  stream-ordered callback on CUDA's callback thread, under capture a host
  node. ``fn`` is a ``HOST_FN`` that the caller keeps alive while any graph
  holds it; it may make no CUDA call. ``check()`` raises what ``fn`` kept
  of its errors: a graph that holds the node calls it after each replay,
  once its stream has run the replay."""
  stream = torch.cuda.current_stream(device).cuda_stream
  _host_check(_host_lib().host_func_launch(stream, fn, data), "cudaLaunchHostFunc")
  if _active is not None and torch.cuda.is_current_stream_capturing():
    _active.host_nodes += 1
    if check is not None and check not in _active.host_checks:
      _active.host_checks.append(check)


def _wait_stream(device: torch.device) -> None:
  """Wait for the current stream of ``device`` (the wait releases the GIL,
  which a queued host function takes)."""
  torch.cuda.current_stream(device).synchronize()


def copy_async(dst: int, src: int, nbytes: int, to_device: bool,
               device: torch.device) -> None:
  """``nbytes`` from ``src`` to ``dst`` (data pointers) on the current
  stream of ``device``, host to device or device to host; the host side is
  page-locked, so the copy is asynchronous and can be captured."""
  stream = torch.cuda.current_stream(device).cuda_stream
  _host_check(_host_lib().host_func_copy(stream, dst, src, nbytes, int(to_device)),
              "cudaMemcpyAsync")


def _pred_bytes(pred: torch.Tensor) -> torch.Tensor:
  if pred.dtype != torch.bool:
    raise ValueError(f"a predicate must be a bool tensor, got {pred.dtype}")
  if pred.numel() == 0 or pred.numel() >= 2**31:
    raise ValueError("a predicate must have 1 to 2**31 - 1 elements")
  return pred.reshape(-1).contiguous()


def set_conditional(handle: int, pred: torch.Tensor) -> None:
  """Capture the kernel that sets ``handle`` to ``any(pred)``, on the
  current stream, which must be capturing. ``set_conditional.launches``
  counts the kernel's launches, the ones made by a node's begin too."""
  p = _pred_bytes(pred)
  stream = torch.cuda.current_stream(p.device).cuda_stream
  _check(_lib().graph_cond_set(stream, handle, _ANY, p.data_ptr(), p.numel()),
         "graph_cond_set")
  set_conditional.launches += 1


set_conditional.launches = 0


def set_conditional_plain(pred: torch.Tensor) -> torch.Tensor:
  """The kernel's function in plain PyTorch: the handle's value."""
  return pred.any()


def set_counted(handle: int, counter: torch.Tensor, n: int) -> None:
  """Capture the counted form at the end of a loop round, on the current
  stream, which must be capturing: the int32 ``counter`` advances, the
  handle is set to ``counter < n``, and the counter goes back to 0 when
  it reaches ``n``. ``set_counted.launches`` counts the form's launches,
  the ones made by a node's begin too."""
  stream = torch.cuda.current_stream(counter.device).cuda_stream
  _check(_lib().graph_cond_set(stream, handle, _COUNTED, counter.data_ptr(), n),
         "graph_cond_set")
  set_counted.launches += 1


set_counted.launches = 0


def set_counted_plain(counter: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """The counted form in plain PyTorch, at a round's end: the new counter
  and the handle's value."""
  c = counter + 1
  more = c < n
  return torch.where(more, c, 0), more


# ------------------------------------------------------- conditional bodies

_MAX_COUNTED_LOOPS = 64  # fori_loops captured into one graph


class _Capture:
  """What one capture adds beside the graph: the private pools of its
  bodies, their node counts and the round counters of its counted loops.

  The counters are made, zero, before the capture begins: memory that the
  graph allocates could have been written earlier in the same replay by
  a tensor freed before the counter took its place, and nothing may touch
  a counter but its loop's kernel, which leaves it at 0 when the loop
  ends."""

  def __init__(self, device: torch.device) -> None:
    self.device = device
    self.pools: List[Tuple[int, int]] = []
    self.body_nodes: List[int] = []
    self.counters = torch.zeros(_MAX_COUNTED_LOOPS, dtype=torch.int32, device=device)
    self.counted_loops = 0
    self.host_nodes = 0  # host functions captured, bodies included
    self.host_checks: List[Callable[[], None]] = []  # their error checks

  def counter(self) -> torch.Tensor:
    """The next loop's round counter, one int32."""
    if self.counted_loops == _MAX_COUNTED_LOOPS:
      raise RuntimeError(f"a capture holds at most {_MAX_COUNTED_LOOPS} fori_loops")
    self.counted_loops += 1
    return self.counters[self.counted_loops - 1:self.counted_loops]

  def release(self) -> None:
    """Return the bodies' pools; after the graph that used them is reset."""
    for pool in self.pools:
      torch._C._cuda_releasePool(self.device.index or 0, pool)
    self.pools = []


_active: Optional[_Capture] = None
_warming = False
_depth = 0  # conditional bodies entered and not yet left
_body_streams: Dict[Tuple[int, int], "torch.cuda.ExternalStream"] = {}


def _body_stream(device: torch.device, depth: int) -> "torch.cuda.ExternalStream":
  """The stream that bodies at ``depth`` are captured on: one made for it
  and kept for the process. ``torch.cuda.Stream()`` hands out the 32
  streams of PyTorch's pool in turn, so a body stream taken from it becomes
  the capturing stream of a later capture (its ``CapturedScan``'s side
  stream) and beginning a body on it then fails."""
  key = (device.index or 0, depth)
  if key not in _body_streams:
    ptr = ctypes.c_void_p()
    with torch.cuda.device(device):
      _check(_lib().graph_cond_stream(ctypes.byref(ptr)), "graph_cond_stream")
    _body_streams[key] = torch.cuda.ExternalStream(ptr.value, device=device)
  return _body_streams[key]


@contextlib.contextmanager
def _capture_into(cuda_graph: "torch.cuda.CUDAGraph", stream: "torch.cuda.Stream"):
  """Capture the block into ``cuda_graph`` on ``stream`` with conditional
  nodes enabled; yields the ``_Capture``, whose pools are released after
  the graph is reset."""
  global _active
  cap = _Capture(stream.device)
  _active = cap
  collecting = gc.isenabled()
  try:
    with torch.cuda.graph(cuda_graph, stream=stream):
      # the graph's entry collected the garbage; no collection may run
      # inside the capture: a graph freed there (the trainer's captures
      # sit in reference cycles) is reset, which invalidates the capture
      gc.disable()
      yield cap
  finally:
    _active = None
    if collecting:
      gc.enable()


def _current() -> _Capture:
  if _active is None:
    raise RuntimeError(
      "a conditional node needs a capture begun by envpool_torch.core.graph "
      "(CapturedScan or scan)"
    )
  return _active


@contextlib.contextmanager
def _conditional_body(kind: int, form: int, arg: torch.Tensor, n: int):
  """Add an IF or WHILE node at the capturing stream's frontier, behind the
  set kernel's ``form`` over ``arg`` (``_ANY``: the predicate's ``n``
  bytes; ``_COUNTED``: the round counter, ``n`` rounds), and capture what
  runs inside the block into its body; yields the node's handle."""
  global _depth
  cap = _current()
  lib = _lib()
  dev = arg.device
  outer = torch.cuda.current_stream(dev)
  body = _body_stream(dev, _depth)
  handle, graph_ptr = ctypes.c_ulonglong(), ctypes.c_void_p()
  _check(lib.graph_cond_begin(
    outer.cuda_stream, body.cuda_stream, kind, form, arg.data_ptr(), n,
    ctypes.byref(handle), ctypes.byref(graph_ptr),
  ), "graph_cond_begin")
  if form == _ANY:
    set_conditional.launches += 1
  elif form == _COUNTED:
    set_counted.launches += 1
  pool = torch._C._graph_pool_handle()
  cap.pools.append(pool)
  _depth += 1
  try:
    with torch.cuda.stream(body):
      torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, pool)
      try:
        yield handle.value
      finally:
        torch._C._cuda_endAllocateToPool(dev.index, pool)
  finally:
    _depth -= 1
    _check(lib.graph_cond_end(body.cuda_stream, graph_ptr), "graph_cond_end")
  count = ctypes.c_ulonglong()
  _check(lib.graph_cond_nodes(graph_ptr, ctypes.byref(count)), "graph_cond_nodes")
  cap.body_nodes.append(int(count.value))


@contextlib.contextmanager
def _on_body_stream(device: torch.device):
  """During warm-up: run a branch on the stream its body will be captured
  on, so that per-stream state (library workspaces) exists before capture."""
  global _depth
  outer = torch.cuda.current_stream(device)
  body = _body_stream(device, _depth)
  body.wait_stream(outer)
  _depth += 1
  try:
    with torch.cuda.stream(body):
      yield
  finally:
    _depth -= 1
    outer.wait_stream(body)


def _copy_into(dst: Any, src: Any) -> None:
  """``dst <- src`` leaf by leaf, safe where a source leaf shares memory with
  a destination leaf (a carry field passed through, or moved to another
  field): such sources are cloned before any copy."""
  pairs: List[Tuple[torch.Tensor, torch.Tensor]] = []
  tree_map(lambda d, s: pairs.append((d, s)), dst, src)  # paired by key
  dst_l = [d for d, _ in pairs]
  src_l = [s for _, s in pairs]
  ptrs = {d.untyped_storage().data_ptr() for d in dst_l}
  fresh = [
    s if s is d or s.untyped_storage().data_ptr() not in ptrs else s.clone()
    for d, s in zip(dst_l, src_l)
  ]
  for d, s in zip(dst_l, fresh):
    if s is not d:
      if s.shape != d.shape or s.dtype != d.dtype:
        raise ValueError(
          f"a branch or body changed a carry leaf: {tuple(d.shape)} {d.dtype} "
          f"-> {tuple(s.shape)} {s.dtype}"
        )
      d.copy_(s)


# ------------------------------------------------------------- control flow

def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable,
         operands: Any) -> Any:
  """``jax.lax.cond(any(pred), true_fn, false_fn, operands)``.

  Eager, one host read of ``pred``. Under capture an IF node, with
  ``false_fn`` taken to be the identity: the result is a copy of
  ``operands`` allocated before the node, overwritten by ``true_fn``'s
  result in the body."""
  if _warming and pred.is_cuda:
    with _on_body_stream(pred.device):
      return true_fn(operands)
  if not _capturing(pred):
    return true_fn(operands) if _host_pred(pred) else false_fn(operands)
  out = tree_map(torch.clone, operands)
  p = _pred_bytes(pred)
  with _conditional_body(_IF, _ANY, p, p.numel()):
    _copy_into(out, true_fn(operands))
  return out


def while_loop(cond_fn: Callable, body_fn: Callable, init: Any) -> Any:
  """``jax.lax.while_loop(lambda c: any(cond_fn(c)), body_fn, init)``.

  Eager, one host read per round. Under capture a WHILE node over a copy of
  ``init``: the body updates the copy in place and re-sets the handle."""
  if _warming and _leaves(init)[0].is_cuda:
    # one round, whatever the predicate: warm-up reads nothing back
    with _on_body_stream(_leaves(init)[0].device):
      carry = body_fn(init)
      cond_fn(carry)
    return carry
  first = cond_fn(init)
  if not _capturing(first):
    carry = init
    while _host_pred(first):
      carry = body_fn(carry)
      first = cond_fn(carry)
    return carry
  carry = tree_map(torch.clone, init)
  p = _pred_bytes(first)
  with _conditional_body(_WHILE, _ANY, p, p.numel()) as handle:
    _copy_into(carry, body_fn(carry))
    set_conditional(handle, cond_fn(carry))
  return carry


def fori_loop(n: int, body_fn: Callable, init: Any) -> Any:
  """``jax.lax.fori_loop(0, n, lambda i, c: body_fn(c), init)`` for a static
  ``n``: a Python loop eagerly (nothing read back), under capture a WHILE
  node over a copy of ``init``, so that the graph holds one round's nodes
  and not ``n`` copies of them. The round counter is an int32 of the
  capture's, zero before the capture began; the counted set kernel
  advances it at the end of each round, its one launch per round, and
  leaves it at 0 when the loop ends, for the next replay."""
  leaf = _leaves(init)[0]
  if n < 1:
    return init
  if _warming and leaf.is_cuda:
    with _on_body_stream(leaf.device):
      return body_fn(init)
  if not _capturing(leaf):
    for _ in range(n):
      init = body_fn(init)
    return init
  if n >= 2**31:
    raise ValueError("a counted loop runs at most 2**31 - 1 rounds")
  counter = _current().counter()
  carry = tree_map(torch.clone, init)
  with _conditional_body(_WHILE, _COUNTED, counter, n) as handle:
    _copy_into(carry, body_fn(carry))
    set_counted(handle, counter, n)
  return carry


# ------------------------------------------------------------ captures

def is_warming() -> bool:
  """Whether a capture's warm-up is running: its eager call on a side
  stream, whose results are thrown away. A host function is not queued
  then (the host tier's step would advance its envs once too often)."""
  return _warming


class _Captured:
  """What ``CapturedScan`` and ``CapturedCall`` share: one warm-up of the
  function on a side stream, one capture of it into a graph there, the
  leaves' signature checked at every later call, the node counts, and the
  graph and its bodies' pools released together."""

  def __init__(self) -> None:
    self._graph: Optional[torch.cuda.CUDAGraph] = None
    self._capture: Optional[_Capture] = None
    self._signature: List[Tuple[torch.Size, torch.dtype]] = []
    self._host_checks: List[Callable[[], None]] = []
    self._device: Optional[torch.device] = None
    self.capture_s = self.instantiate_s = 0.0
    self.nodes = self.conditional_nodes = self.host_nodes = 0

  def _check_signature(self, leaves: List[torch.Tensor]) -> None:
    if [(t.shape, t.dtype) for t in leaves] != self._signature:
      raise ValueError("the inputs' leaves changed shape or type since the capture")

  def _warm(self, device: torch.device, fn: Callable[[], Any]):
    """``fn()`` once on a new side stream with every conditional branch
    taken (lazily made constants and library workspaces exist before the
    capture, which reads nothing back); -> (the side stream, its result)."""
    global _warming
    _lib()  # the libraries are built and loaded before any capture
    _host_lib()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    _warming = True
    try:
      with torch.cuda.stream(side):
        out = fn()
    finally:
      _warming = False
    torch.cuda.current_stream(device).wait_stream(side)
    return side, out

  def _record(self, side: "torch.cuda.Stream", fn: Callable[[], None]) -> None:
    """Capture ``fn()`` on ``side`` and instantiate the graph."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    t0 = time.perf_counter()
    with _capture_into(graph, side) as cap:
      fn()
    t1 = time.perf_counter()
    graph.instantiate()
    self.instantiate_s = time.perf_counter() - t1
    self.capture_s = t1 - t0
    count = ctypes.c_ulonglong()
    _check(_lib().graph_cond_nodes(graph.raw_cuda_graph(), ctypes.byref(count)),
           "graph_cond_nodes")
    self.nodes = int(count.value) + sum(cap.body_nodes)
    self.conditional_nodes = len(cap.body_nodes)
    self.host_nodes = cap.host_nodes
    self._host_checks, self._device = cap.host_checks, side.device
    self._graph, self._capture = graph, cap

  def _raise_host_errors(self) -> None:
    """After a replay of a graph that holds host nodes: wait for the
    stream, then raise the first error that its host functions kept (the
    outputs of such a replay are not to be used)."""
    if self.host_nodes:
      _wait_stream(self._device)
      for check in self._host_checks:
        check()

  def __del__(self) -> None:
    graph, cap = getattr(self, "_graph", None), getattr(self, "_capture", None)
    if graph is None:
      return
    try:
      graph.reset()
      cap.release()
    except Exception:
      pass  # interpreter shutdown


class CapturedScan(_Captured):
  """``jax.jit(lambda c: lax.scan(body, c, None, length))`` with the graph
  kept: ``body(carry) -> (carry, y)``; calling the object with a carry
  returns ``(final carry, ys)``, each ``ys`` leaf ``[length, ...]``.

  On the card the first call captures, later calls copy their carry into the
  static buffers and replay (the carry's leaves must keep their shapes and
  types). Tensors that ``body`` closes over are read at replay: update them
  in place, as ``PPOTrainStep`` does with its parameters. A graph with host
  nodes waits for its stream after the replays and raises the first error
  that a host function kept. Attributes after a capture: ``capture_s``, ``instantiate_s``, ``nodes`` (the step graph's,
  conditional bodies and host nodes included), ``conditional_nodes`` and
  ``host_nodes``."""

  def __init__(self, body: Callable, length: int) -> None:
    if length < 1:
      raise ValueError("scan length must be at least 1")
    super().__init__()
    self.body, self.length = body, int(length)

  def __call__(self, carry: Any, steps: Optional[int] = None,
               copy: bool = True) -> Tuple[Any, Any]:
    """``steps`` (at most ``length``) runs only the first steps of the scan,
    with ``ys`` of that length: a rollout timed at two lengths shares one
    capture. ``copy=False`` returns the graph's own carry and ``ys``
    buffers (all ``length`` rows), which the next call overwrites."""
    steps = self.length if steps is None else int(steps)
    if not 1 <= steps <= self.length:
      raise ValueError(f"steps must lie in [1, {self.length}], got {steps}")
    leaves = _leaves(carry)
    if not leaves[0].is_cuda:
      return self.eager(carry, steps)
    if self._graph is None:
      self._build(carry)
    else:
      self._check_signature(leaves)
    _copy_into(self._carry, carry)
    self.replay(steps)
    if not copy:
      return self._carry, self._ys
    return (tree_map(torch.clone, self._carry),
            tree_map(lambda y: y[:steps].clone(), self._ys))

  def replay(self, steps: Optional[int] = None) -> None:
    """The graph alone, ``steps`` times (default ``length``) from step 0, on
    the carry its buffers hold: a call without its copies in and out, for
    timing the rollout itself. A graph with host nodes then waits for its
    stream and raises their errors."""
    self._t.zero_()
    for _ in range(self.length if steps is None else steps):
      self._graph.replay()
    self._raise_host_errors()

  def eager(self, carry: Any, steps: Optional[int] = None) -> Tuple[Any, Any]:
    """The scan as a loop of ``body`` calls, on any device (what the CPU
    runs, and a mesh over several cards, which no graph can hold)."""
    def signature(c):
      return [(t.shape, t.dtype) for t in _leaves(c) if isinstance(t, torch.Tensor)]

    first = signature(carry)
    ys = []
    for _ in range(self.length if steps is None else steps):
      carry, y = self.body(carry)
      if signature(carry) != first:
        # the graph's static buffers could not hold it: refused here too
        raise ValueError("the body changed a carry leaf's shape or type")
      ys.append(y)
    return carry, tree_map(lambda *r: torch.stack(r), *ys)

  def _step(self) -> None:
    """What the graph holds: one body call on the static buffers."""
    new, y = self.body(self._carry)
    # y may read the static carry: store it before the carry is overwritten
    for buf, leaf in zip(_leaves(self._ys), _leaves(y)):
      buf.index_copy_(0, self._t, leaf.unsqueeze(0))
    _copy_into(self._carry, new)
    self._t.add_(1)

  def _build(self, carry: Any) -> None:
    device = _leaves(carry)[0].device
    self._signature = [(t.shape, t.dtype) for t in _leaves(carry)]
    self._carry = tree_map(torch.clone, carry)
    side, (_, y) = self._warm(device, lambda: self.body(self._carry))
    self._ys = tree_map(
      lambda v: torch.empty((self.length, *v.shape), dtype=v.dtype, device=device), y
    )
    del y
    self._t = torch.zeros(1, dtype=torch.int64, device=device)
    self._record(side, self._step)


class CapturedCall(_Captured):
  """``jax.jit(fn)`` with the graph kept, for a function run once per
  call: ``fn(*args)`` over trees of tensors, returning a tree of tensors.

  On the card the first call warms ``fn`` up on a side stream and captures
  one call over static copies of ``args``; every call copies its ``args``
  into them (the leaves must keep their shapes and types), replays, and
  returns clones of the outputs (with host nodes, once they ran and raised
  no error). Tensors that ``fn`` closes over are read at replay. On the CPU
  it calls ``fn(*args)``. Attributes as ``CapturedScan``'s."""

  def __init__(self, fn: Callable) -> None:
    super().__init__()
    self.fn = fn

  def __call__(self, *args: Any) -> Any:
    leaves = _leaves(args)
    if not leaves[0].is_cuda:
      return self.fn(*args)
    if self._graph is None:
      self._build(args)
    else:
      self._check_signature(leaves)
    _copy_into(self._args, args)
    self._graph.replay()
    self._raise_host_errors()
    return tree_map(torch.clone, self._out)

  def _build(self, args: Tuple[Any, ...]) -> None:
    device = _leaves(args)[0].device
    self._signature = [(t.shape, t.dtype) for t in _leaves(args)]
    self._args = tree_map(torch.clone, args)
    side, out = self._warm(device, lambda: self.fn(*self._args))
    del out

    def record() -> None:
      self._out = self.fn(*self._args)

    self._record(side, record)


def scan(body: Callable, carry: Any, length: int) -> Tuple[Any, Any]:
  """``jax.jit(lambda c: lax.scan(body, c, None, length))(carry)``: one
  capture and ``length`` replays on the card, ``length`` eager calls on the
  CPU. Returns ``(final carry, ys)``."""
  return CapturedScan(body, length)(carry)
