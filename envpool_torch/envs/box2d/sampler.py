"""CarRacing background sampler: the CUDA kernel's wrapper and plain version.

Replaces ``envpool_tpu/envs/box2d/car_racing.py``'s ``_fused_render_kernel``,
``_fused_sample_batched`` and ``_fused_sample``. The function, for env e and
output pixel (i, j), in closed form (see ``csrc/car_racing_sampler.cu``):

  r, c = rows[e, i], cols[e, j]; 0 if either lies outside [0, S)
  r = (r - s4[e, c]) mod S;  c = (c - s3[e, r]) mod S
  r = (r - s2[e, c]) mod S;  c = (c - s1[e, r]) mod S
  out[e, i, j] = bank[8 * scal[e, 0] + r, 128 * scal[e, 1] + c]

``bank`` is the uint8 palette+1 track bank (0 = black), so the output is a
uint8 palette+1 index. An env whose window does not lie inside the bank
gets 0 everywhere (both versions), so no read leaves the bank.
"""

from __future__ import annotations

import ctypes

import torch

from envpool_torch import _build


def sample_plain(
  bank: torch.Tensor, scal: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
  s3: torch.Tensor, s4: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
) -> torch.Tensor:
  """The sampler in plain PyTorch indexing: ``[N, H, W]`` uint8."""
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


def _kernel():
  """The C entry point of ``csrc/car_racing_sampler.cu``, built at first use."""
  fn = _build.load("car_racing_sampler").car_racing_sample
  if fn.argtypes is None:
    fn.argtypes = (
      [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
      + [ctypes.c_void_p] * 8
      + [ctypes.c_int] * 4
      + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
  return fn


def _check(bank, scal, s1, s2, s3, s4, rows, cols) -> None:
  tensors = (bank, scal, s1, s2, s3, s4, rows, cols)
  if any(t.device != bank.device for t in tensors):
    raise ValueError("sampler inputs must lie on one device")
  if any(not t.is_contiguous() for t in tensors):
    raise ValueError("sampler inputs must be contiguous")
  if bank.dtype != torch.uint8 or bank.ndim != 2:
    raise ValueError(f"bank must be 2-D uint8, got {bank.dtype} {tuple(bank.shape)}")
  if any(t.dtype != torch.int32 for t in tensors[1:]):
    raise ValueError("scal, shifts, rows and cols must be int32")
  n, s = s1.shape
  if scal.shape != (n, 2) or any(t.shape != (n, s) for t in (s2, s3, s4)):
    raise ValueError("scal must be [N, 2] and s1..s4 [N, S]")
  if rows.ndim != 2 or cols.ndim != 2 or rows.shape[0] != n or cols.shape[0] != n:
    raise ValueError("rows must be [N, H] and cols [N, W]")
  if (4 * s + rows.shape[1] + cols.shape[1]) * 4 > 48 * 1024:
    raise ValueError(f"window S={s} exceeds the kernel's shared memory")


def fused_sample(
  bank: torch.Tensor, scal: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
  s3: torch.Tensor, s4: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
) -> torch.Tensor:
  """The sampler: the CUDA kernel for CUDA tensors, the plain version for
  CPU tensors. ``fused_sample.launches`` counts kernel launches."""
  _check(bank, scal, s1, s2, s3, s4, rows, cols)
  if bank.device.type == "cpu":
    return sample_plain(bank, scal, s1, s2, s3, s4, rows, cols)
  if bank.device.type != "cuda":
    raise ValueError(f"no sampler kernel for device {bank.device}")
  n, s = s1.shape
  h, w = rows.shape[1], cols.shape[1]
  out = torch.empty((n, h, w), dtype=torch.uint8, device=bank.device)
  fn = _kernel()
  with torch.cuda.device(bank.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(
      bank.data_ptr(), bank.shape[0], bank.shape[1], scal.data_ptr(),
      s1.data_ptr(), s2.data_ptr(), s3.data_ptr(), s4.data_ptr(),
      rows.data_ptr(), cols.data_ptr(), out.data_ptr(), n, s, h, w, stream,
    )
  if err != 0:
    raise RuntimeError(f"car_racing_sample launch failed: CUDA error {err}")
  fused_sample.launches += 1
  return out


fused_sample.launches = 0
