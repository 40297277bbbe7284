"""Native (C++) components of the port, loaded via ctypes.

The port's copy of ``envpool_tpu/native``: the Sokoban level parser and A*
solver (``sokoban_native.cpp``, the same source) compiled on first use with
the system g++ into ``build/native/libsokoban.so`` at the root of the
checkout (ignored by git; rebuilt when the source is newer), and bound
through ctypes. Host-only: nothing here is on the device path. Everything
has a pure-Python fallback, so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "sokoban_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_LIB = BUILD_DIR / "libsokoban.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
  """Compile into a per-process temporary name, then rename: test workers
  in other processes may build at the same time."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = BUILD_DIR / f"libsokoban.{os.getpid()}.tmp.so"
  try:
    subprocess.run(
      ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o",
       str(tmp)],
      check=True, capture_output=True, timeout=120,
    )
  except (OSError, subprocess.SubprocessError):
    return False
  os.replace(tmp, _LIB)
  return True


def _load() -> Optional[ctypes.CDLL]:
  global _lib, _tried
  with _lock:
    if _lib is not None or _tried:
      return _lib
    _tried = True
    if not _LIB.exists() or _SRC.stat().st_mtime > _LIB.stat().st_mtime:
      if not _build():
        return None
    try:
      lib = ctypes.CDLL(str(_LIB))
    except OSError:
      return None
    lib.sokoban_parse_file.restype = ctypes.c_int
    lib.sokoban_parse_file.argtypes = [
      ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
      ctypes.c_int,
    ]
    lib.sokoban_solve.restype = ctypes.c_int
    lib.sokoban_solve.argtypes = [
      ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
      ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.sokoban_last_error.restype = ctypes.c_char_p
    _lib = lib
    return _lib


def available() -> bool:
  return _load() is not None


def parse_file(path: str, dim: int,
               max_levels: int = 100_000) -> Optional[np.ndarray]:
  """Parse a level file natively -> [n, dim, dim] uint8, or None."""
  lib = _load()
  if lib is None:
    return None
  out = np.empty((max_levels, dim, dim), dtype=np.uint8)
  n = lib.sokoban_parse_file(
    path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    max_levels, dim,
  )
  if n < 0:
    return None
  return np.copy(out[:n])


def solve(level: np.ndarray,
          node_limit: int = 1_000_000) -> Optional[List[int]]:
  """A* solve a [dim, dim] level natively -> env action list, or None."""
  lib = _load()
  if lib is None:
    return None
  level = np.ascontiguousarray(level, dtype=np.uint8)
  if level.ndim != 2 or level.shape[0] != level.shape[1]:
    raise ValueError(f"expected a square [dim, dim] level, got {level.shape}")
  dim = level.shape[0]
  max_actions = 4096
  actions = np.empty(max_actions, dtype=np.int32)
  n = lib.sokoban_solve(
    level.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dim,
    node_limit, actions.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    max_actions,
  )
  if n < 0:
    return None
  return actions[:n].tolist()
