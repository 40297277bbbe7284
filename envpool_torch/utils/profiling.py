"""Profiling helpers.

The port of ``envpool_tpu/utils/profiling.py``. The reference's
observability is a pair of chrono accumulators around its queue ops
(``envpool/core/async_envpool.h:56,78-80``). Here:

- ``StepTimer``: host-side send/recv duration accumulators with the same
  dur_send/dur_recv split;
- ``trace``: a context manager over ``torch.profiler`` that writes a
  Chrome trace of the enclosed block (the CPU ops, and the CUDA kernels
  when a card is in use) under a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator

import torch


class StepTimer:
  """Accumulates send/recv wall-times, like dur_send_/dur_recv_."""

  def __init__(self) -> None:
    self.dur_send = 0.0
    self.dur_recv = 0.0
    self.n_send = 0
    self.n_recv = 0

  @contextlib.contextmanager
  def send(self) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
      yield
    finally:
      self.dur_send += time.perf_counter() - t0
      self.n_send += 1

  @contextlib.contextmanager
  def recv(self) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
      yield
    finally:
      self.dur_recv += time.perf_counter() - t0
      self.n_recv += 1

  def summary(self) -> Dict[str, float]:
    return {
      "dur_send_s": self.dur_send,
      "dur_recv_s": self.dur_recv,
      "n_send": self.n_send,
      "n_recv": self.n_recv,
      "avg_send_ms": 1e3 * self.dur_send / max(self.n_send, 1),
      "avg_recv_ms": 1e3 * self.dur_recv / max(self.n_recv, 1),
    }


@contextlib.contextmanager
def trace(log_dir: str, **kwargs: Any) -> Iterator[torch.profiler.profile]:
  """Profile the enclosed block and write ``log_dir/trace_<ns>.json``, a
  Chrome trace. ``kwargs`` go to ``torch.profiler.profile``; the
  activities default to the CPU, and CUDA when a card is available.
  Yields the profiler (``key_averages()`` for a table)."""
  acts = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(torch.profiler.ProfilerActivity.CUDA)
  kwargs.setdefault("activities", acts)
  os.makedirs(log_dir, exist_ok=True)
  with torch.profiler.profile(**kwargs) as prof:
    yield prof
    if torch.cuda.is_available():
      torch.cuda.synchronize()
  prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))
