"""Image ops for obs pipelines — batched tensor replacements for OpenCV.

The port of ``envpool_tpu/ops/image.py``. The reference processes frames
per env on CPU threads with OpenCV (``envpool/utils/image_process.h:27-45``:
``cv::resize`` INTER_AREA and ``cv::cvtColor`` RGB2GRAY); here the same
transforms run on the whole ``[num_envs, ...]`` batch on its device.

INTER_AREA resize is two small matmuls ``W_h @ img @ W_w^T`` with constant
pixel-area-overlap weights, then OpenCV's uint8 rounding. The JAX package
asks XLA for ``Precision.HIGHEST`` so that the TPU's bf16 passes do not
move pixel sums across the .5 rounding line; the card's counterpart is
TF32, which ``resize_area`` turns off around its matmuls.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import numpy as np
import torch

from envpool_torch.core.prng import fma32

# ITU-R BT.601 luma weights used by cv::COLOR_RGB2GRAY
_GRAY_W = np.asarray([0.299, 0.587, 0.114], dtype=np.float32)


@functools.lru_cache(maxsize=64)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
  """[n_out, n_in] pixel-area overlap weight matrix (rows sum to 1)."""
  scale = n_in / n_out
  w = np.zeros((n_out, n_in), dtype=np.float32)
  for o in range(n_out):
    lo = o * scale
    hi = (o + 1) * scale
    i0 = int(np.floor(lo))
    i1 = int(np.ceil(hi))
    for i in range(i0, min(i1, n_in)):
      overlap = min(hi, i + 1) - max(lo, i)
      if overlap > 0:
        w[o, i] = overlap / scale
  return w


@functools.lru_cache(maxsize=16)
def _device_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
  return torch.from_numpy(_area_weights(n_in, n_out)).to(device)


@contextlib.contextmanager
def no_tf32(device: torch.device):
  """float32 matmuls in full precision on the card (TF32 off), whatever the
  process set, e.g. a trainer's ``set_float32_matmul_precision``."""
  if device.type != "cuda":
    yield
    return
  flag = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = flag


def _round_u8(x: torch.Tensor) -> torch.Tensor:
  """OpenCV's uint8 ``saturate_cast``: round half up, clip."""
  return torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8)


def resize_area(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
  """INTER_AREA resize of [..., H, W] (uint8 or float) to [..., h, w].

  Matches ``cv::resize(..., INTER_AREA)`` for downscaling (the Atari
  210x160 -> 84x84 path, ``envpool/atari/atari_env.h:117-121``).
  """
  h_out, w_out = out_hw
  h_in, w_in = img.shape[-2], img.shape[-1]
  wh = _device_weights(h_in, h_out, img.device)
  ww = _device_weights(w_in, w_out, img.device)
  with no_tf32(img.device):
    # contract H then W: [..., h_out, W] then [..., h_out, w_out]
    x = torch.matmul(torch.matmul(wh, img.to(torch.float32)), ww.T)
  if img.dtype == torch.uint8:
    x = _round_u8(x)
  return x


def grayscale(img: torch.Tensor) -> torch.Tensor:
  """RGB [..., H, W, 3] -> gray [..., H, W] with BT.601 weights.

  Matches ``cv::cvtColor(COLOR_RGB2GRAY)``
  (``envpool/utils/image_process.h:41-45``) and, bit for bit, XLA-CPU's
  float32 dot in the JAX package: ``r*0.299``, then ``+ g*0.587`` and
  ``+ b*0.114`` each as one fused multiply-add. Separate float32 products
  and sums land on the other side of .5 for 859 of the 2^24 colours.
  """
  r, g, b = img.to(torch.float32).unbind(-1)
  w = [float(v) for v in _GRAY_W]
  x = fma32(b, w[2], fma32(g, w[1], r * w[0]))
  if img.dtype == torch.uint8:
    x = _round_u8(x)
  return x


def max_last_two(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Elementwise max of the last two skipped frames
  (``envpool/atari/atari_env.h:269-276``)."""
  return torch.maximum(a, b)


def stack_push(stack: torch.Tensor, frame: torch.Tensor, dim: int = 0) -> torch.Tensor:
  """Shift a frame stack along ``dim`` (the JAX package's leading axis by
  default; a batched stack ``[N, stack_num, ...]`` passes 1) and append
  ``frame``. Counterpart of the reference's stack_buf_ deque push
  (``envpool/atari/atari_env.h:281-287``)."""
  rest = stack.narrow(dim, 1, stack.shape[dim] - 1)
  return torch.cat([rest, frame.unsqueeze(dim)], dim)
