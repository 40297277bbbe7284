"""CarRacing background: the CUDA kernel's wrapper and plain version.

Replaces ``envpool_tpu/envs/box2d/car_racing.py``'s ``_fused_render_kernel``,
``_fused_sample_batched`` and ``_fused_sample``, with the path select and
palette of ``_render_v2_impl`` (``:827-835``). One path's sampler, for env e
and output pixel (i, j), in closed form (see ``csrc/car_racing_sampler.cu``):

  r, c = rows[e, i], cols[e, j]; 0 if either lies outside [0, S)
  r = (r - s4[e, c]) mod S;  c = (c - s3[e, r]) mod S
  r = (r - s2[e, c]) mod S;  c = (c - s1[e, r]) mod S
  idx[e, i, j] = bank[8 * scal[e, 0] + r, 128 * scal[e, 1] + c]

``bank`` is the uint8 palette+1 track bank (0 = black), so ``idx`` is a
palette+1 index. An env whose window does not lie inside the bank gets 0
everywhere (both versions), so no read leaves the bank. The background of a
render takes, per env, the fine path's ``idx`` where ``use_fine`` and the
coarse path's elsewhere, and looks it up in ``palette`` (``[P, 3]`` uint8,
an index >= P is black): ``[N, H, W, 3]`` uint8.

A path is the tuple ``(bank, scal, s1, s2, s3, s4, rows, cols)``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from envpool_torch import _build

H = W = 96          # the kernel's output size (a compile-time constant there)
MAX_WINDOW = 4096   # the kernel keeps 4 int16 shift rows of S in shared memory
MAX_PALETTE = 256


def sample_plain(
  bank: torch.Tensor, scal: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
  s3: torch.Tensor, s4: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
) -> torch.Tensor:
  """One path's sampler in plain PyTorch indexing: ``[N, H, W]`` uint8."""
  n, s = s1.shape
  h, w = rows.shape[1], cols.shape[1]
  r = rows.long()[:, :, None].expand(n, h, w)
  c = cols.long()[:, None, :].expand(n, h, w)
  inside = (r >= 0) & (r < s) & (c >= 0) & (c < s)

  def pick(shift: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return shift.long().gather(1, idx.reshape(n, -1)).reshape(n, h, w)

  r, c = torch.remainder(r, s), torch.remainder(c, s)
  r = torch.remainder(r - pick(s4, c), s)
  c = torch.remainder(c - pick(s3, r), s)
  r = torch.remainder(r - pick(s2, c), s)
  c = torch.remainder(c - pick(s1, r), s)
  bank_rows, bank_cols = bank.shape
  r0 = (8 * scal[:, 0].long())[:, None, None]
  c0 = (128 * scal[:, 1].long())[:, None, None]
  window_ok = (r0 >= 0) & (r0 + s <= bank_rows) & (c0 >= 0) & (c0 + s <= bank_cols)
  flat = torch.where(window_ok, (r0 + r) * bank_cols + c0 + c, 0)
  out = bank.reshape(-1)[flat]
  return torch.where(inside & window_ok, out, 0).to(torch.uint8)


def background_plain(
  fine: Sequence[torch.Tensor], coarse: Sequence[torch.Tensor],
  use_fine: torch.Tensor, palette: torch.Tensor,
) -> torch.Tensor:
  """The background in plain PyTorch: both paths through ``sample_plain``,
  the per-env select, the palette lookup. ``[N, H, W, 3]`` uint8."""
  idx = torch.where(
    use_fine[:, None, None], sample_plain(*fine), sample_plain(*coarse)
  ).long()
  idx = torch.where(idx < palette.shape[0], idx, palette.shape[0])
  black = torch.zeros((1, 3), dtype=torch.uint8, device=palette.device)
  return torch.cat([palette, black])[idx]


class _Path(ctypes.Structure):
  """``struct Path`` of ``csrc/car_racing_sampler.cu``."""

  _fields_ = [
    ("bank", ctypes.c_void_p), ("bank_rows", ctypes.c_longlong),
    ("bank_cols", ctypes.c_int), ("s", ctypes.c_int),
    ("scal", ctypes.c_void_p), ("s1", ctypes.c_void_p),
    ("s2", ctypes.c_void_p), ("s3", ctypes.c_void_p),
    ("s4", ctypes.c_void_p), ("rows", ctypes.c_void_p),
    ("cols", ctypes.c_void_p),
  ]


def _kernel():
  """The C entry point of ``csrc/car_racing_sampler.cu``, built at first use."""
  fn = _build.load("car_racing_sampler").car_racing_background
  if fn.argtypes is None:
    fn.argtypes = [
      ctypes.POINTER(_Path), ctypes.POINTER(_Path), ctypes.c_void_p,
      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
      ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
  return fn


def _check_path(name: str, path: Sequence[torch.Tensor], n: int) -> None:
  if len(path) != 8:
    raise ValueError(f"{name} must be (bank, scal, s1, s2, s3, s4, rows, cols)")
  bank, scal, s1, s2, s3, s4, rows, cols = path
  if bank.dtype != torch.uint8 or bank.ndim != 2 or bank.numel() == 0:
    raise ValueError(
      f"{name} bank must be non-empty 2-D uint8, got {bank.dtype} {tuple(bank.shape)}"
    )
  if any(t.dtype != torch.int32 for t in path[1:]):
    raise ValueError(f"{name} scal, shifts, rows and cols must be int32")
  if s1.ndim != 2 or s1.shape[0] != n:
    raise ValueError(f"{name} s1 must be [N, S] with N={n}")
  s = s1.shape[1]
  if scal.shape != (n, 2) or any(t.shape != (n, s) for t in (s2, s3, s4)):
    raise ValueError(f"{name} scal must be [N, 2] and s1..s4 [N, S]")
  if rows.shape != (n, H) or cols.shape != (n, W):
    raise ValueError(f"{name} rows and cols must be [N, {H}]")
  if not 0 < s <= MAX_WINDOW or s * bank.shape[1] >= 2**31:
    raise ValueError(f"{name} window S={s} is outside what the kernel takes")


def _check(fine, coarse, use_fine, palette) -> None:
  n = use_fine.shape[0]
  _check_path("fine", fine, n)
  _check_path("coarse", coarse, n)
  if use_fine.dtype != torch.bool or use_fine.shape != (n,):
    raise ValueError("use_fine must be [N] bool")
  if palette.dtype != torch.uint8 or palette.ndim != 2 or palette.shape[1] != 3:
    raise ValueError("palette must be [P, 3] uint8")
  if not 0 < palette.shape[0] <= MAX_PALETTE:
    raise ValueError(f"palette must have 1..{MAX_PALETTE} entries")
  tensors = (*fine, *coarse, use_fine, palette)
  if any(t.device != palette.device for t in tensors):
    raise ValueError("background inputs must lie on one device")
  if any(not t.is_contiguous() for t in tensors):
    raise ValueError("background inputs must be contiguous")


def _path_struct(path: Sequence[torch.Tensor]) -> _Path:
  bank, scal, s1, s2, s3, s4, rows, cols = path
  return _Path(
    bank.data_ptr(), bank.shape[0], bank.shape[1], s1.shape[1],
    *(t.data_ptr() for t in (scal, s1, s2, s3, s4, rows, cols)),
  )


def fused_background(
  fine: Sequence[torch.Tensor], coarse: Sequence[torch.Tensor],
  use_fine: torch.Tensor, palette: torch.Tensor,
) -> torch.Tensor:
  """The background of one render, ``[N, H, W, 3]`` uint8: one CUDA kernel
  launch for CUDA tensors, the plain version for CPU tensors.
  ``fused_background.launches`` counts kernel launches."""
  _check(fine, coarse, use_fine, palette)
  dev = palette.device
  if dev.type == "cpu":
    return background_plain(fine, coarse, use_fine, palette)
  if dev.type != "cuda":
    raise ValueError(f"no background kernel for device {dev}")
  n = use_fine.shape[0]
  out = torch.empty((n, H, W, 3), dtype=torch.uint8, device=dev)
  fn = _kernel()
  fine_s, coarse_s = _path_struct(fine), _path_struct(coarse)
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(
      ctypes.byref(fine_s), ctypes.byref(coarse_s), use_fine.data_ptr(),
      palette.data_ptr(), palette.shape[0], out.data_ptr(), n, stream,
    )
  if err != 0:
    raise RuntimeError(f"car_racing_background launch failed: CUDA error {err}")
  fused_background.launches += 1
  return out


fused_background.launches = 0
