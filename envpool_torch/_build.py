"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/<name>.so`` at the root of the
checkout, at first use, then loaded with ``ctypes``. A library is rebuilt
when its source, or any ``csrc/*.cuh`` header, is newer than it: every
``.cu`` file rebuilds when any header changes, since the headers are few and
nvcc is not asked which of them a source includes. Nothing here runs at
import: the CPU tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
  "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
  "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas registers / shared memory) of the last build, by name
build_log: Dict[str, str] = {}


def _nvcc() -> str:
  for cand in (
    os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    shutil.which("nvcc"),
  ):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
  return BUILD_DIR / f"{name}.so"


def _stale(name: str) -> bool:
  """Whether ``name``'s library is missing or older than its source or any
  header of ``csrc/`` (every ``.cu`` rebuilds when any header changes)."""
  lib = _lib_path(name)
  if not lib.exists():
    return True
  sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
  return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build(names: Optional[Iterable[str]] = None) -> float:
  """Compile the named sources (default: all of ``csrc/``) that are stale,
  one ``nvcc`` per source, all started together. Returns the seconds taken."""
  t0 = time.perf_counter()
  names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
  with _lock:
    todo = [n for n in names if _stale(n)]
    if not todo:
      return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
      tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp.so"
      cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
      procs[name] = (tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
      ))
    failed = []
    for name, (tmp, proc) in procs.items():
      log, _ = proc.communicate()
      build_log[name] = log
      if proc.returncode != 0:
        failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
      else:
        os.replace(tmp, _lib_path(name))
    if failed:
      raise RuntimeError("kernel build failed: " + "\n".join(failed))
  return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
  """The built library for ``csrc/<name>.cu``, building it if needed."""
  lib = _libs.get(name)
  if lib is None:
    build([name])
    with _lock:
      lib = _libs.setdefault(name, ctypes.CDLL(str(_lib_path(name))))
  return lib
