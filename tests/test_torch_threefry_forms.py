"""The two forms of the threefry kernel (``csrc/threefry.cu``), through
their plain version ``prng.threefry_plain`` and the public ``split``,
``random_bits`` and ``fold_in`` that dispatch to it on the CPU, against
``jax.random`` bit for bit: the iota form (counters ``(0, i)``, pair and
xor output) and the fold_in form (counter ``(0, data)``, pair and xor), on
strided and broadcast key views, multi-dimensional batches, a single key
with 131,072 counters (PPO's ``permutation`` width) and empty shapes. One
jitted JAX function computes every reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envpool_torch.core import prng

# the suite runs in several worker processes that share the cores: one
# intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

WIDE = 131072


def _keys(rng, *shape):
  return rng.integers(0, 2**32, shape + (2,), dtype=np.uint64).astype(np.uint32)


RNG = np.random.default_rng(17)
BATCH = _keys(RNG, 6)              # [6, 2]
GRID = _keys(RNG, 3, 4)            # [3, 4, 2]
ONE = _keys(RNG)                   # [2]
DATA32 = RNG.integers(-2**31, 2**31, 6, dtype=np.int64).astype(np.int32)
DATA64 = RNG.integers(0, 2**32, (3, 4), dtype=np.int64)
CONST = 2**32 - 3


@jax.jit
def _reference(batch, grid, one, data32, data64):
  vsplit = lambda n: jax.vmap(lambda k: jax.random.split(k, n))
  vbits = lambda shape: jax.vmap(lambda k: jax.random.bits(k, shape))
  vfold = jax.vmap(jax.random.fold_in)
  two = vsplit(2)(batch)                                  # [6, 2, 2]
  return {
    "split2": two,
    "split3": vsplit(3)(batch),
    "split_of_view": vsplit(2)(two[:, 1]),
    "split_grid": jax.vmap(vsplit(5))(grid),
    "bits_scalar": vbits(())(batch),
    "bits_of_view": vbits((7,))(two[:, 0]),
    "bits_grid": jax.vmap(vbits((2, 3)))(grid),
    "bits_wide": jax.random.bits(one, (WIDE,)),
    "bits_empty": vbits((0,))(batch),
    "split_empty": vsplit(0)(batch),
    "fold32": vfold(batch, data32),
    "fold_of_view": vfold(two[:, 1], data32),
    "fold64": jax.vmap(vfold)(grid, data64.astype(jnp.uint32)),
    "fold_broadcast": jax.vmap(lambda d: jax.random.fold_in(one, d))(data32),
    "fold_const": jax.vmap(lambda k: jax.random.fold_in(k, CONST))(batch),
  }


@pytest.fixture(scope="module")
def want():
  out = _reference(BATCH, GRID, ONE, DATA32, DATA64)
  return {k: np.asarray(v).astype(np.int64) for k, v in out.items()}


def _t(x):
  return torch.from_numpy(np.asarray(x).astype(np.int64))


def _two():
  """``split(BATCH, 2)`` as a torch tensor, for its strided views."""
  return prng.threefry_plain(_t(BATCH), 2, True)


# name -> (the plain form's call, the public function's call); each returns
# what the JAX reference of the same name holds
CASES = {
  "split2": (lambda: prng.threefry_plain(_t(BATCH), 2, True),
             lambda: prng.split(_t(BATCH), 2)),
  "split3": (lambda: prng.threefry_plain(_t(BATCH), 3, True),
             lambda: prng.split(_t(BATCH), 3)),
  "split_of_view": (lambda: prng.threefry_plain(_two()[:, 1], 2, True),
                    lambda: prng.split(_two()[:, 1], 2)),
  "split_grid": (lambda: prng.threefry_plain(_t(GRID), 5, True),
                 lambda: prng.split(_t(GRID), 5)),
  "bits_scalar": (lambda: prng.threefry_plain(_t(BATCH), 1, False)[:, 0],
                  lambda: prng.random_bits(_t(BATCH), ())),
  "bits_of_view": (lambda: prng.threefry_plain(_two()[:, 0], 7, False),
                   lambda: prng.random_bits(_two()[:, 0], (7,))),
  "bits_grid": (lambda: prng.threefry_plain(_t(GRID), 6, False).reshape(3, 4, 2, 3),
                lambda: prng.random_bits(_t(GRID), (2, 3))),
  "bits_wide": (lambda: prng.threefry_plain(_t(ONE), WIDE, False),
                lambda: prng.random_bits(_t(ONE), (WIDE,))),
  "bits_empty": (lambda: prng.threefry_plain(_t(BATCH), 0, False),
                 lambda: prng.random_bits(_t(BATCH), (0,))),
  "split_empty": (lambda: prng.threefry_plain(_t(BATCH), 0, True),
                  lambda: prng.split(_t(BATCH), 0)),
  "fold32": (lambda: prng.threefry_plain(_t(BATCH), 1, True, torch.from_numpy(DATA32))[:, 0],
             lambda: prng.fold_in(_t(BATCH), torch.from_numpy(DATA32))),
  "fold_of_view": (lambda: prng.threefry_plain(_two()[:, 1], 1, True, torch.from_numpy(DATA32))[:, 0],
                   lambda: prng.fold_in(_two()[:, 1], torch.from_numpy(DATA32))),
  "fold64": (lambda: prng.threefry_plain(_t(GRID), 1, True, torch.from_numpy(DATA64))[:, :, 0],
             lambda: prng.fold_in(_t(GRID), torch.from_numpy(DATA64))),
  "fold_broadcast": (
    lambda: prng.threefry_plain(_t(ONE).expand(6, 2), 1, True, torch.from_numpy(DATA32))[:, 0],
    lambda: prng.fold_in(_t(ONE), torch.from_numpy(DATA32))),
  "fold_const": (lambda: prng.threefry_plain(_t(BATCH), 1, True, base=CONST)[:, 0],
                 lambda: prng.fold_in(_t(BATCH), CONST)),
}


@pytest.mark.parametrize("form", ["plain", "public"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_form_matches_jax(want, name, form):
  got = CASES[name][form == "public"]()
  assert got.dtype == torch.int64
  assert tuple(got.shape) == want[name].shape
  np.testing.assert_array_equal(got.numpy(), want[name])


@pytest.mark.parametrize("data", ["int32", "int64"])
def test_fold_in_form_xor_output(want, data):
  """The fold_in form's xor output: the xor of the two words jax's
  ``fold_in`` gives for the same key and counter."""
  name, arr = ("fold32", DATA32) if data == "int32" else ("fold64", DATA64)
  keys = _t(BATCH) if data == "int32" else _t(GRID)
  got = prng.threefry_plain(keys, 1, False, torch.from_numpy(arr))[..., 0]
  np.testing.assert_array_equal(got.numpy(), want[name][..., 0] ^ want[name][..., 1])


@pytest.mark.parametrize("shape,strides,expected", [
  ((), (), 0),                 # one key
  ((6,), (2,), 2),             # a contiguous batch
  ((6,), (4,), 4),             # both[:, 0] of a split
  ((6,), (0,), 0),             # a broadcast key
  ((3, 4), (8, 2), 2),         # a contiguous grid
  ((3, 1, 4), (8, 99, 2), 2),  # a size-1 dim takes any stride
  ((3, 4), (0, 0), 0),         # a broadcast grid
  ((3, 4), (16, 2), None),     # rows cut from a wider grid
  ((3, 4), (0, 2), None),      # a broadcast row of keys
])
def test_batch_stride(shape, strides, expected):
  """The kernel walks a key batch by one stride; batches that cannot be
  walked so are copied first."""
  assert prng._batch_stride(shape, strides) == expected


def test_kernel_wrapper_refuses_cpu_tensors():
  """A CPU tensor takes the plain version in the public functions; the
  kernel's wrapper itself never runs quietly on the CPU."""
  with pytest.raises(ValueError, match="CUDA"):
    prng.threefry_kernel(_t(BATCH), 2, True)
