"""The port's CarRacing background against the JAX package's Pallas sampler
(interpret mode on the CPU), composed as ``_render_v2_impl`` composes it,
and its CUDA kernel against its plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envpool_torch.envs.box2d import car_track, sampler
from envpool_tpu.envs.box2d.car_racing import _fused_sample_batched

N = 3
USE_FINE = np.asarray([True, False, True])
PATHS = {"fine": (384, (1024, 640)), "coarse": (256, (512, 512))}

# the suite runs in several worker processes that share the cores: one
# intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)


def _inputs(seed, s_dim, bank_shape, n=N):
  """Random integer inputs: bank values palette+1 in [0, 7], shifts over
  [-S, S], rows/cols partly outside the window, window offsets anywhere
  inside the bank."""
  rng = np.random.default_rng(seed)
  rows_b, cols_b = bank_shape
  bank = rng.integers(0, 8, bank_shape).astype(np.uint8)
  scal = np.stack([
    rng.integers(0, (rows_b - s_dim) // 8 + 1, n),
    rng.integers(0, (cols_b - s_dim) // 128 + 1, n),
  ], 1).astype(np.int32)
  shifts = [rng.integers(-s_dim, s_dim + 1, (n, s_dim)).astype(np.int32)
            for _ in range(4)]
  rows = rng.integers(-24, s_dim + 24, (n, 96)).astype(np.int32)
  cols = rng.integers(-24, s_dim + 24, (n, 96)).astype(np.int32)
  return bank, scal, shifts, rows, cols


def _path(inputs, device="cpu"):
  bank, scal, shifts, rows, cols = inputs
  return tuple(torch.from_numpy(x).to(device) for x in (bank, scal, *shifts, rows, cols))


def _palette1(device="cpu"):
  palette1 = np.concatenate([np.zeros((1, 3), np.uint8), car_track.PALETTE])
  return torch.from_numpy(palette1).to(device)


@pytest.fixture(scope="module")
def pallas():
  """Each path's inputs and the Pallas sampler's output on them: one
  interpret-mode call per path for the whole module."""
  out = {}
  for name, (s_dim, bank_shape) in PATHS.items():
    inputs = _inputs(s_dim, s_dim, bank_shape)
    bank, scal, (s1, s2, s3, s4), rows, cols = inputs
    want = np.asarray(_fused_sample_batched(
      jnp.asarray(bank, jnp.bfloat16), jnp.asarray(scal), jnp.asarray(s1),
      jnp.asarray(s2), jnp.asarray(s3), jnp.asarray(s4), jnp.asarray(rows),
      jnp.asarray(cols),
    ))
    out[name] = (inputs, want)
  return out


@pytest.mark.parametrize("s_dim,bank_shape", [(384, (1024, 640)), (256, (512, 512))])
def test_plain_matches_pallas_bit_exact(pallas, s_dim, bank_shape):
  path = "fine" if s_dim == 384 else "coarse"
  assert PATHS[path] == (s_dim, bank_shape)
  inputs, want = pallas[path]
  t = _path(inputs)
  got = sampler.sample_plain(*t)
  assert got.dtype == torch.uint8 and got.shape == (N, 96, 96)
  np.testing.assert_array_equal(got.numpy().astype(np.float32), want)
  # on CPU tensors the wrapper is the plain version and launches nothing
  before = sampler.fused_background.launches
  use_fine = torch.full((N,), path == "fine")
  img = sampler.fused_background(t, t, use_fine, _palette1())
  assert sampler.fused_background.launches == before
  np.testing.assert_array_equal(img.numpy(), _palette1()[got.long()].numpy())


def test_background_matches_jax_composition(pallas):
  """Both paths, the per-env select and the palette: the plain composite
  against the Pallas outputs composed as ``_render_v2_impl`` (``:827-835``)
  composes them, on a mixed fine/coarse batch."""
  (fine_in, idx_fine), (coarse_in, idx_coarse) = pallas["fine"], pallas["coarse"]
  color_idx1 = jnp.where(
    jnp.asarray(USE_FINE)[:, None, None], jnp.round(idx_fine).astype(jnp.int32),
    jnp.round(idx_coarse).astype(jnp.int32),
  )
  img = jnp.zeros((*color_idx1.shape, 3), jnp.uint8)
  for k in range(len(car_track.PALETTE)):
    img = jnp.where(
      (color_idx1 == k + 1)[..., None],
      jnp.asarray(car_track.PALETTE[k], jnp.uint8), img,
    )
  want = np.asarray(img)
  assert len(np.unique(want.reshape(-1, 3), axis=0)) > 4
  got = sampler.fused_background(
    _path(fine_in), _path(coarse_in), torch.from_numpy(USE_FINE), _palette1()
  )
  assert got.dtype == torch.uint8 and got.shape == (N, 96, 96, 3)
  np.testing.assert_array_equal(got.numpy(), want)
  # an index past the palette is black, as in the palette loop
  short = sampler.background_plain(
    _path(fine_in), _path(coarse_in), torch.from_numpy(USE_FINE), _palette1()[:4]
  )
  np.testing.assert_array_equal(
    short.numpy(), np.where((np.asarray(color_idx1) < 4)[..., None], want, 0)
  )


def test_window_outside_bank_is_black():
  bank, scal, (s1, s2, s3, s4), rows, cols = _inputs(1, 256, (512, 512))
  scal[0] = [(512 - 256) // 8 + 1, 0]      # window runs past the last row
  t = [torch.from_numpy(x) for x in (bank, scal, s1, s2, s3, s4, rows, cols)]
  got = sampler.sample_plain(*t)
  assert int(got[0].max()) == 0 and int(got[1].max()) > 0
  img = sampler.fused_background(t, t, torch.ones(N, dtype=torch.bool), _palette1())
  assert int(img[0].max()) == 0 and int(img[1].max()) > 0


def test_wrapper_rejects_bad_inputs():
  t = _path(_inputs(2, 256, (512, 512)))
  use_fine, pal = torch.from_numpy(USE_FINE), _palette1()
  with pytest.raises(ValueError):
    sampler.fused_background((t[0].to(torch.int32), *t[1:]), t, use_fine, pal)
  with pytest.raises(ValueError):
    sampler.fused_background(t, (t[0], t[1], t[2][:, :128], *t[3:]), use_fine, pal)
  with pytest.raises(ValueError):
    sampler.fused_background(t, t, use_fine.to(torch.uint8), pal)
  with pytest.raises(ValueError):
    sampler.fused_background(t, t, use_fine, torch.zeros((300, 3), dtype=torch.uint8))
  with pytest.raises(ValueError):
    sampler.fused_background(t, t, use_fine, pal.to("meta"))


def test_kernel_matches_plain_on_cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
  n = 64
  fine = _path(_inputs(3, 384, (4 * 8 * 1024, 1024), n=n), "cuda")
  coarse = _path(_inputs(4, 256, (4 * 8 * 256, 256), n=n), "cuda")
  use_fine = torch.from_numpy(np.random.default_rng(5).random(n) < 0.5).cuda()
  before = sampler.fused_background.launches
  got = sampler.fused_background(fine, coarse, use_fine, _palette1("cuda"))
  torch.cuda.synchronize()
  assert sampler.fused_background.launches == before + 1
  assert torch.equal(got, sampler.background_plain(fine, coarse, use_fine, _palette1("cuda")))
