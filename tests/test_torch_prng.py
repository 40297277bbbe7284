"""The port's threefry stream against ``jax.random``, element for element."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envpool_torch.core import prng

SEEDS = [0, 1, 2**31 - 1]
RANGES = [(0, 2), (0, 8), (-5, 7)]
N = 6

# the suite runs in several worker processes that share the cores: one
# intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)


def _jax_pool_keys(seed):
  """The per-env keys as ``TpuEnvPool`` derives them (``pool.py:151-154``)."""
  base = jax.random.PRNGKey(seed)
  keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
    jnp.arange(N, dtype=jnp.int32)
  )
  return np.asarray(keys)


def _torch_pool_keys(seed):
  base = prng.prng_key(seed).expand(N, 2)
  return prng.fold_in(base, torch.arange(N, dtype=torch.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
  np.testing.assert_array_equal(
    prng.prng_key(seed).numpy(), np.asarray(jax.random.PRNGKey(seed))
  )
  np.testing.assert_array_equal(
    _torch_pool_keys(seed).numpy(), _jax_pool_keys(seed)
  )


@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed):
  jk = _jax_pool_keys(seed)
  want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(jnp.asarray(jk)))
  got = prng.split(_torch_pool_keys(seed), 3)
  assert got.shape == (N, 3, 2)
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("shape", [(), (5,)])
def test_randint(seed, lo, hi, shape):
  jk = jnp.asarray(_jax_pool_keys(seed))
  want = np.asarray(
    jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi))(jk)
  )
  got = prng.randint(_torch_pool_keys(seed), shape, lo, hi)
  assert got.dtype == torch.int32 and got.shape == want.shape
  np.testing.assert_array_equal(got.numpy(), want)
  assert want.min() >= lo and want.max() < hi


def test_random_bits():
  jk = jnp.asarray(_jax_pool_keys(0))
  want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (7,)))(jk))
  got = prng.random_bits(_torch_pool_keys(0), (7,))
  np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", [0.5, 0.2, 0.9])
@pytest.mark.parametrize("shape", [(), (5,)])
def test_bernoulli(seed, p, shape):
  jk = jnp.asarray(_jax_pool_keys(seed))
  want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, p, shape))(jk))
  got = prng.bernoulli(_torch_pool_keys(seed), shape, p)
  assert got.dtype == torch.bool and got.shape == want.shape
  np.testing.assert_array_equal(got.numpy(), want)


def test_bernoulli_many_keys():
  """p = 0.5, Pong's serve draw, over 4096 split keys: both outcomes."""
  keys = jax.random.split(jax.random.PRNGKey(3), 4096)
  want = np.asarray(jax.vmap(jax.random.bernoulli)(keys))
  got = prng.bernoulli(torch.from_numpy(np.asarray(keys).astype(np.int64)))
  np.testing.assert_array_equal(got.numpy(), want)
  assert 0.45 < want.mean() < 0.55
