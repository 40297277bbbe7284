"""Threefry-2x32 counter-based PRNG, bit-compatible with ``jax.random``.

A port of jax 0.9.0's default key stream (``jax/_src/prng.py``:
``threefry_2x32``, ``threefry_seed``, ``threefry_fold_in``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``; and
``jax/_src/random.py::_randint`` and ``_uniform``) under
``jax_threefry_partitionable=True``, that jax's default. The JAX package
derives per-env keys with it (``pool.py``) and families draw from it
(``car_racing.py`` picks the track with ``randint``; ``sokoban.py`` draws
levels with ``split``/``randint`` and episode caps with ``bits``;
``cartpole.py`` resets with ``uniform``; Pong's serve draws ``bernoulli``),
so the port must reproduce it bit for bit to start from the same seed in
the same state. The trainer draws ``categorical`` actions (Gumbel-max),
``normal`` noise and ``permutation`` minibatch orders (``train/ppo.py``),
and the networks' own initialisation ``truncated_normal``
(``models/nets.py``): the integer draws are exact, the float ones pass
through ``log`` and ``erfinv`` and may differ from XLA's by a few ulps.

Keys are raw ``[..., 2]`` tensors of uint32 values held in ``int64``
(torch's uint32 has no arithmetic on every device). Every function is
batched over leading dimensions: the ``vmap`` of the JAX package becomes a
batch dimension.

Every hash goes through ``split``, ``random_bits`` or ``fold_in``, and each
of those is one call of the hash over a batch of keys and counters: on a
CUDA tensor one launch of ``csrc/threefry.cu`` (``threefry_kernel``), on a
CPU tensor its plain version ``threefry_plain``, the 20 rounds as int64
tensor ops masked to 32 bits (``threefry2x32``). Every draw built on them
(``randint``, ``uniform``, ``bernoulli``, ``normal``, ``gumbel``,
``categorical``, ``permutation``, ``truncated_normal``) reaches the kernel
through them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
  return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(
  k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
  """The Threefry-2x32 hash (20 rounds), broadcasting over all inputs."""
  ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
  x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
  for i in range(5):
    for r in _ROTATIONS[i % 2]:
      x[0] = (x[0] + x[1]) & _M32
      x[1] = _rotl(x[1], r) ^ x[0]
    x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
    x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
  return x[0], x[1]


def prng_key(seed: int, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
  """``jax.random.PRNGKey(seed)`` for an int32-range seed: ``[2]`` int64."""
  seed = int(seed)
  # 32-bit mode: the seed is an int32, its high word shifts out to 0
  return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def threefry_plain(
  keys: torch.Tensor, n_ctr: int, pair: bool,
  data: Optional[torch.Tensor] = None, base: int = 0,
) -> torch.Tensor:
  """The plain version of ``threefry_kernel``, the same arguments and output.

  Keys ``[..., 2]``; per key, the counters ``(0, c + i)`` for ``i <
  n_ctr``, where ``c`` is ``data[...]`` (the fold_in form: ``data`` has the
  keys' batch shape and ``n_ctr`` is 1) or ``base`` (the iota form of
  ``split`` and ``random_bits``: ``base`` 0). Returns ``[..., n_ctr, 2]``,
  the two words of each hash (``pair``), or ``[..., n_ctr]``, their xor.
  """
  batch = keys.shape[:-1]
  if data is None:
    lo = (torch.arange(n_ctr, dtype=torch.int64, device=keys.device) + base) & _M32
    lo = lo.reshape((1,) * len(batch) + (n_ctr,))
  else:
    lo = (data.to(torch.int64) & _M32)[..., None]
  b1, b2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], torch.zeros_like(lo), lo)
  return torch.stack([b1, b2], dim=-1) if pair else b1 ^ b2


def _batch_stride(shape: Sequence[int], strides: Sequence[int]) -> Optional[int]:
  """The one stride that walks a batch of ``shape`` laid out by ``strides``
  in row-major order, or None where one stride cannot."""
  dims = [(n, st) for n, st in zip(shape, strides) if n != 1]
  for (_, s0), (n1, s1) in zip(dims, dims[1:]):
    if s0 != s1 * n1:
      return None
  return dims[-1][1] if dims else 0


def _kernel():
  """The C entry point of ``csrc/threefry.cu``, built at first use."""
  from envpool_torch import _build

  fn = _build.load("threefry").threefry_launch
  if fn.argtypes is None:
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [vp, ll, ll, ll, vp, ctypes.c_int, ll, ll, ll, ctypes.c_int, vp, vp]
    fn.restype = ctypes.c_int
  return fn


def threefry_kernel(
  keys: torch.Tensor, n_ctr: int, pair: bool,
  data: Optional[torch.Tensor] = None, base: int = 0,
) -> torch.Tensor:
  """``threefry_plain`` on CUDA tensors, one launch of ``csrc/threefry.cu``.

  Keys are int64 ``[..., 2]``; ``data`` int32 or int64 with the keys'
  batch shape. A key batch (or ``data``) whose strides cannot be walked by
  one stride is copied first (one PyTorch copy; the views the port passes,
  such as ``both[:, 0]`` or a broadcast key, need none). Nothing is
  launched, or counted, when the output is empty.
  ``threefry_kernel.launches`` counts kernel launches."""
  if keys.device.type != "cuda":
    raise ValueError(f"threefry_kernel takes CUDA tensors, got {keys.device}")
  if keys.dtype != torch.int64 or keys.ndim < 1 or keys.shape[-1] != 2:
    raise ValueError(f"keys must be int64 [..., 2], got {keys.dtype} {tuple(keys.shape)}")
  batch = tuple(keys.shape[:-1])
  n_keys = math.prod(batch)
  if not 0 <= n_ctr < 2**32 or n_keys * n_ctr >= 2**31:
    raise ValueError(f"{n_keys} keys x {n_ctr} counters: the kernel takes "
                     f"fewer than 2^31 outputs")
  out = torch.empty(batch + ((n_ctr, 2) if pair else (n_ctr,)),
                    dtype=torch.int64, device=keys.device)
  key_stride = _batch_stride(batch, keys.stride()[:-1])
  if key_stride is None:
    keys = keys.contiguous()
    key_stride = 2
  data_ptr, data_bytes, data_stride = None, 0, 0
  if data is not None:
    if data.dtype not in (torch.int32, torch.int64) or tuple(data.shape) != batch:
      raise ValueError(f"data must be int32 or int64 {batch}, got {data.dtype} "
                       f"{tuple(data.shape)}")
    if data.device != keys.device or n_ctr != 1:
      raise ValueError("data must lie on the keys' device, with n_ctr 1")
    data_stride = _batch_stride(batch, data.stride())
    if data_stride is None:
      data = data.contiguous()
      data_stride = 1
    data_ptr, data_bytes = data.data_ptr(), data.element_size()
  if out.numel() == 0:
    return out
  with torch.cuda.device(keys.device):
    err = _kernel()(
      keys.data_ptr(), n_keys, key_stride, keys.stride(-1), data_ptr, data_bytes,
      data_stride, int(base) & _M32, n_ctr, int(pair), out.data_ptr(),
      torch.cuda.current_stream().cuda_stream,
    )
  if err != 0:
    raise RuntimeError(f"threefry launch failed: CUDA error {err}")
  threefry_kernel.launches += 1
  return out


threefry_kernel.launches = 0


def _threefry(
  keys: torch.Tensor, n_ctr: int, pair: bool,
  data: Optional[torch.Tensor] = None, base: int = 0,
) -> torch.Tensor:
  """The hash: the kernel for CUDA tensors, the plain version for CPU ones
  (and for meta tensors, which hold shapes only: the tests step families on
  them to show that a step reads nothing back)."""
  if keys.device.type == "cuda":
    return threefry_kernel(keys, n_ctr, pair, data, base)
  if keys.device.type not in ("cpu", "meta"):
    raise ValueError(f"no threefry kernel for device {keys.device}")
  return threefry_plain(keys, n_ctr, pair, data, base)


def fold_in(keys: torch.Tensor, data: Union[torch.Tensor, int]) -> torch.Tensor:
  """``jax.random.fold_in`` batched: keys ``[..., 2]``, data ``[...]``
  (broadcast against the keys' batch) or an int."""
  if not isinstance(data, torch.Tensor):
    # a constant counter, not a host-to-device copy (it may be captured)
    return _threefry(keys, 1, True, base=int(data) & _M32)[..., 0, :]
  data = data.to(device=keys.device)
  if data.dtype not in (torch.int32, torch.int64):
    data = data.to(torch.int64)
  batch = torch.broadcast_shapes(keys.shape[:-1], data.shape)
  out = _threefry(keys.expand(batch + (2,)), 1, True, data.expand(batch))
  return out[..., 0, :]


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
  """``jax.random.split(key, num)`` batched: ``[..., 2] -> [..., num, 2]``."""
  return _threefry(keys, int(num), True)


def random_bits(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
  """32-bit ``jax.random.bits`` batched: ``[..., 2] -> [..., *shape]``."""
  shape = tuple(int(s) for s in shape)
  out = _threefry(keys, math.prod(shape), False)
  return out.reshape(keys.shape[:-1] + shape)


def randint(
  keys: torch.Tensor, shape: Sequence[int], minval: int, maxval: int
) -> torch.Tensor:
  """``jax.random.randint(key, shape, minval, maxval)`` (int32) batched.

  Same algorithm as ``jax/_src/random.py::_randint``: two 32-bit draws
  from the halves of ``split(key)``, combined modulo the span.
  """
  i32 = torch.iinfo(torch.int32)
  lo = max(min(int(minval), i32.max), i32.min)
  hi = max(min(int(maxval), i32.max), i32.min)
  sub = split(keys, 2)
  higher = random_bits(sub[..., 0, :], shape)
  lower = random_bits(sub[..., 1, :], shape)
  span = (hi - lo) & _M32 if hi > lo else 1
  multiplier = (2**16) % span
  multiplier = ((multiplier * multiplier) & _M32) % span
  offset = ((higher % span) * multiplier + (lower % span)) & _M32
  offset = offset % span
  out = (lo + offset) & _M32
  out = torch.where(out >= 2**31, out - 2**32, out)
  return out.to(torch.int32)


def fma32(a: torch.Tensor, b: Union[torch.Tensor, float], c: Union[torch.Tensor, float]) -> torch.Tensor:
  """float32 ``a * b + c`` rounded once, as XLA-CPU's contracted
  multiply-add: the float64 product of two float32 is exact."""
  return (a.double() * b + c).float()


def inv32(c: float) -> float:
  """The float32 reciprocal of a constant: XLA multiplies by it where the
  JAX code divides by ``c`` (torch's CUDA division by a scalar does too,
  its CPU one divides), so ``x * inv32(c)`` is the JAX package's ``x / c``."""
  return float(np.float32(1.0) / np.float32(c))


def mul32(c1: float, c2: float) -> float:
  """The float32 product XLA folds the constant factors of ``(x * c1) * c2``
  into."""
  return float(np.float32(c1) * np.float32(c2))


def uniform(
  keys: torch.Tensor, shape: Sequence[int], minval: float, maxval: float
) -> torch.Tensor:
  """float32 ``jax.random.uniform(key, shape, minval=, maxval=)`` batched.

  Same algorithm as ``jax/_src/random.py::_uniform``: the top 23 of 32
  random bits become the mantissa of a float in [1, 2), minus 1, scaled to
  the range, then floored at ``minval``. XLA contracts the scale-and-shift
  into one fused multiply-add (one rounding); float32 torch ops would round
  twice and miss by up to thousands of ulps near 0 for a range like
  (-0.05, 0.05). So it is done in float64, where the product of two float32
  is exact, and rounded to float32 once: bit-exact against jax
  (``tests/test_torch_engine.py``).
  """
  lo = np.float32(minval)
  span = np.float32(maxval) - lo
  bits = random_bits(keys, shape)
  mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
  floats = mant.view(torch.float32) - 1.0
  return torch.clamp_min(fma32(floats, float(span), float(lo)), float(lo))


def bernoulli(
  keys: torch.Tensor, shape: Sequence[int] = (), p: float = 0.5
) -> torch.Tensor:
  """``jax.random.bernoulli(key, p, shape)`` batched, in jax's default
  "low" mode: ``uniform(key, shape, 0, 1) < p`` in float32."""
  return uniform(keys, shape, 0.0, 1.0) < float(np.float32(p))


# Giles' erfinv polynomials as XLA builds ``erf_inv`` for float32 (the
# ``chlo.erf_inv`` decomposition): w = -log1p(-x * x), then a degree-8
# Horner in w - 2.5 (w < 5) or sqrt(w) - 3.
_ERFINV_LT5 = (
  2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_GE5 = (
  -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
  """float32 ``lax.erf_inv`` in XLA's form, each Horner step rounded once
  as XLA-CPU contracts it. ``log1p`` and ``sqrt`` are torch's, so a result
  may differ from XLA's by a few ulps (``tests/test_torch_ppo.py``)."""
  w = -torch.log1p(-(x * x))
  lt = w < 5.0
  w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
  p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
  for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
    p = fma32(p, w, torch.where(lt, c_lt, c_ge))
  return torch.where(x.abs() == 1.0, x * float(np.finfo(np.float32).max), p * x)


def normal(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
  """float32 ``jax.random.normal(key, shape)`` batched (``_normal_real``):
  ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``."""
  lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
  return float(np.float32(np.sqrt(2))) * _erfinv32(uniform(keys, shape, lo, 1.0))


def truncated_normal(
  keys: torch.Tensor, shape: Sequence[int], lower: float, upper: float
) -> torch.Tensor:
  """float32 ``jax.random.truncated_normal(key, lower, upper, shape)``
  batched: ``sqrt(2) * erfinv(uniform(erf(lower / sqrt 2), erf(upper /
  sqrt 2)))``, clipped inside (lower, upper)."""
  sqrt2 = np.float32(np.sqrt(2))
  lo, hi = np.float32(lower), np.float32(upper)
  a, b = (float(np.float32(math.erf(float(v / sqrt2)))) for v in (lo, hi))
  out = float(sqrt2) * _erfinv32(uniform(keys, shape, a, b))
  return torch.clamp(
    out, float(np.nextafter(lo, np.float32(np.inf))),
    float(np.nextafter(hi, np.float32(-np.inf))),
  )


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
  """float32 ``jax.random.gumbel(key, shape)`` in its default "low" mode:
  ``-log(-log(uniform(tiny, 1)))``."""
  tiny = float(np.finfo(np.float32).tiny)
  return -torch.log(-torch.log(uniform(keys, shape, tiny, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
  """``jax.random.categorical(key, logits)`` over the last axis for one
  key: the Gumbel-max draw ``argmax(gumbel(key, logits.shape) + logits)``
  (int64 indices)."""
  return torch.argmax(gumbel(keys, logits.shape) + logits, dim=-1)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
  """``jax.random.permutation(key, n)`` for one key (``_shuffle``): rounds
  of stable sorts by fresh 32-bit keys, as many as jax makes for ``n``.
  Integer-only, so it is exact (int64 indices)."""
  rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
  x = torch.arange(n, device=key.device)
  for _ in range(rounds):
    key, sub = split(key, 2).unbind(-2)
    order = torch.sort(random_bits(sub, (n,)), stable=True).indices
    x = x[order]
  return x
