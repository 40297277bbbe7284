"""The port's CarRacing background sampler against the JAX package's Pallas
sampler (interpret mode on the CPU), and its CUDA kernel against its plain
version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envpool_torch.envs.box2d import sampler
from envpool_tpu.envs.box2d.car_racing import _fused_sample_batched

N = 2

# the suite runs in several worker processes that share the cores: one
# intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)


def _inputs(seed, s_dim, bank_shape, n=N):
  """Random integer inputs: shifts over [-S, S], rows/cols partly outside
  the window, window offsets anywhere inside the bank."""
  rng = np.random.default_rng(seed)
  rows_b, cols_b = bank_shape
  bank = rng.integers(0, 9, bank_shape).astype(np.uint8)
  scal = np.stack([
    rng.integers(0, (rows_b - s_dim) // 8 + 1, n),
    rng.integers(0, (cols_b - s_dim) // 128 + 1, n),
  ], 1).astype(np.int32)
  shifts = [rng.integers(-s_dim, s_dim + 1, (n, s_dim)).astype(np.int32)
            for _ in range(4)]
  rows = rng.integers(-24, s_dim + 24, (n, 96)).astype(np.int32)
  cols = rng.integers(-24, s_dim + 24, (n, 96)).astype(np.int32)
  return bank, scal, shifts, rows, cols


@pytest.mark.parametrize("s_dim,bank_shape", [(384, (1024, 640)), (256, (512, 512))])
def test_plain_matches_pallas_bit_exact(s_dim, bank_shape):
  bank, scal, (s1, s2, s3, s4), rows, cols = _inputs(s_dim, s_dim, bank_shape)
  want = np.asarray(_fused_sample_batched(
    jnp.asarray(bank, jnp.bfloat16), jnp.asarray(scal), jnp.asarray(s1),
    jnp.asarray(s2), jnp.asarray(s3), jnp.asarray(s4), jnp.asarray(rows),
    jnp.asarray(cols),
  ))
  t = [torch.from_numpy(x) for x in (bank, scal, s1, s2, s3, s4, rows, cols)]
  got = sampler.sample_plain(*t)
  assert got.dtype == torch.uint8 and got.shape == (N, 96, 96)
  np.testing.assert_array_equal(got.numpy().astype(np.float32), want)
  # on CPU tensors the wrapper is the plain version and launches nothing
  before = sampler.fused_sample.launches
  np.testing.assert_array_equal(sampler.fused_sample(*t).numpy(), got.numpy())
  assert sampler.fused_sample.launches == before


def test_window_outside_bank_is_black():
  bank, scal, (s1, s2, s3, s4), rows, cols = _inputs(1, 256, (512, 512))
  scal[0] = [(512 - 256) // 8 + 1, 0]      # window runs past the last row
  t = [torch.from_numpy(x) for x in (bank, scal, s1, s2, s3, s4, rows, cols)]
  got = sampler.sample_plain(*t)
  assert int(got[0].max()) == 0 and int(got[1].max()) > 0


def test_wrapper_rejects_bad_inputs():
  bank, scal, (s1, s2, s3, s4), rows, cols = _inputs(2, 256, (512, 512))
  t = [torch.from_numpy(x) for x in (bank, scal, s1, s2, s3, s4, rows, cols)]
  with pytest.raises(ValueError):
    sampler.fused_sample(t[0].to(torch.int32), *t[1:])
  with pytest.raises(ValueError):
    sampler.fused_sample(t[0], t[1], t[2][:, :128], *t[3:])


def test_kernel_matches_plain_on_cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
  for s_dim, bank_shape in [(384, (4 * 8 * 1024, 1024)), (256, (4 * 8 * 256, 256))]:
    inputs = _inputs(3, s_dim, bank_shape, n=64)
    bank, scal, shifts, rows, cols = inputs
    t = [torch.from_numpy(x).cuda() for x in (bank, scal, *shifts, rows, cols)]
    before = sampler.fused_sample.launches
    got = sampler.fused_sample(*t)
    torch.cuda.synchronize()
    assert sampler.fused_sample.launches == before + 1
    assert torch.equal(got, sampler.sample_plain(*t))
