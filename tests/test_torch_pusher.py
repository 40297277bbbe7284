"""The port's ``PusherJax-v4`` (CPU, float32) against the JAX package's:
cylinder contacts (the object on the table, the finger against it).

- the specs are equal;
- the reset's acceptance test, ``hypot(x, y) > 0.17``, is the JAX
  package's float32 ``jnp.hypot`` bit for bit (``HYPOT_DRAWS`` draws of the
  reset's distribution; an ulp off at the boundary would change which
  draw a lane keeps);
- the pools (``_torch_parity.pool_parity``): the reset of the JAX pool's
  init against the port's reset on the same keys, ``q`` (the rejection
  loop's accepted x and y) and ``v`` bit for bit; then both pools from
  seed 0 under numpy-seeded uniform actions, every output (the obs, the
  reward and the ``reward_dist``/``reward_ctrl`` info fields) within
  ``TOL`` of ``1 + |x|`` on every lane but those that part, counted
  against ``SHARE``; then the JAX state carried into a fresh port pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import envpool_torch
from envpool_torch.core import prng
from envpool_torch.envs.mujoco import device_tasks as pt

from _torch_parity import init_keys, pool_parity
from test_torch_dmc_classic import assert_spec_matches

torch.set_num_threads(1)

TASK = "PusherJax-v4"
N, STEPS, CARRIED_AT = 16, 12, 8
TOL = 1e-3
# no lane parted when the bound was set (2 of 16 may, as for the other
# contact ids, for a changed library)
SHARE = 0.125
HYPOT_DRAWS = 200_000


def test_spec_matches_jax_package():
  assert_spec_matches(TASK)


def test_acceptance_hypot_matches_jax_bit_for_bit():
  keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), HYPOT_DRAWS))

  def draw(k):
    _, k1, k2 = jax.random.split(k, 3)
    x = jax.random.uniform(k1, (), jnp.float32, -0.3, 0.0)
    y = jax.random.uniform(k2, (), jnp.float32, -0.2, 0.2)
    return x, y, jnp.hypot(x, y)
  x, y, want = (np.asarray(a) for a in jax.jit(jax.vmap(draw))(keys))
  got = pt._hypot32(torch.tensor(x), torch.tensor(y)).numpy()
  np.testing.assert_array_equal(got, want)
  assert got.dtype == np.float32


def test_reset_loop_redraws_per_lane():
  """A lane whose first draw is accepted keeps it; the others (a third or
  so) redraw on their own key chains until outside the goal's radius."""
  cfg = envpool_torch.make_spec(TASK).config
  keys = torch.from_numpy(init_keys(256))
  state, obs, info = pt.PusherJaxEnv.reset(cfg, None, keys)
  x, y = state["q"][:, -4], state["q"][:, -3]
  assert (pt._hypot32(x, y) > np.float32(0.17)).all()
  kc, _ = prng.split(keys).unbind(-2)
  _, k1, k2 = prng.split(kc, 3).unbind(-2)
  x1, y1 = prng.uniform(k1, (), -0.3, 0.0), prng.uniform(k2, (), -0.2, 0.2)
  first = pt._hypot32(x1, y1) > np.float32(0.17)
  assert 0 < (~first).sum() < 256 // 2
  assert (x[first] == x1[first]).all() and (y[first] == y1[first]).all()
  assert (x[~first] != x1[~first]).all()
  assert obs.shape == (256, 23) and set(info) == {"reward_dist", "reward_ctrl"}


def test_pool_matches_jax_package():
  res = pool_parity(TASK, N, STEPS, CARRIED_AT, TOL, SHARE, draws={})
  assert res["worst"] <= TOL
