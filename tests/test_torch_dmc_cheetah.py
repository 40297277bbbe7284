"""The port's ``CheetahJaxRun-v1`` (CPU, float32) against the JAX
package's pool: 8 plane-capsule pairs, ``subtree_linvel`` in the reward,
and the 200-substep settle in its reset.

As in ``test_torch_dmc_classic.py``: the spec equal, the pools from seed 0
and from a carried state (``pool_parity``). The draws are its limited
joints' uniform draws before the settle, bit for bit (the JAX randomizer
against the port's: the JAX pool's reset is the only settle compiled
here); the settled reset state is held to ``SETTLED`` relative. Steps:
floats within ``DMC_CONTACT_TOL`` of ``1 + |x|``, lanes that part counted
against ``DMC_CONTACT_SHARE``; none parted when the bound was set.
"""

import types

import jax
import numpy as np
import torch

from envpool_torch.envs.mujoco.dmc import device_domains as pd
from envpool_tpu.envs.mujoco.dmc import device_domains as jd

from _torch_parity import (
  DMC_CONTACT_SHARE, DMC_CONTACT_TOL, assert_state_close, init_keys,
  pool_parity,
)
from test_torch_dmc_classic import assert_spec_matches

torch.set_num_threads(1)

SETTLED = 1e-4
TASK = "CheetahJaxRun-v1"


def _cheetah_draws():
  """(JAX, port) functions of the keys: qpos0 with the limited joints
  drawn, as cheetah's reset does before its settle."""
  cfg = types.SimpleNamespace(task_name="run", frame_skip=1)
  jm = jd.DmcCheetahJaxEnv.mdl(cfg)
  pm = pd.DmcCheetahJaxEnv.mdl(cfg)

  def jax_fn(keys):
    q0 = jax.numpy.asarray(jm.init_qpos, jax.numpy.float32)
    return {"q": np.asarray(jax.jit(jax.vmap(
      lambda k: jd.randomize_limited_and_rotational_joints(
        jm, q0, k, limited_only=True)))(keys))}

  def port_fn(keys):
    q, _ = pd.DmcCheetahJaxEnv._reset_qv(cfg, keys)
    return {"q": pd.randomize_limited_and_rotational_joints(
      pm, q, keys, limited_only=True).numpy()}
  return jax_fn, port_fn


def test_spec_matches_jax_package():
  assert_spec_matches(TASK)


def test_pool_matches_jax_package():
  n = 4
  jax_fn, port_fn = _cheetah_draws()
  keys = init_keys(n)
  assert_state_close(port_fn(torch.from_numpy(keys)),
                     jax_fn(jax.numpy.asarray(keys.astype(np.uint32))), {},
                     "cheetah draws")
  pool_parity(TASK, n, 10, 6, DMC_CONTACT_TOL,
              DMC_CONTACT_SHARE, reset_tol=SETTLED)
