"""The port's three walker ids (CPU, float32) against the JAX package's
pools: 7 plane-capsule and 15 capsule-capsule pairs, 122 rows, 8 Newton
iterations, ``subtree_linvel`` in the walk and run rewards.

As in ``test_torch_dmc_classic.py``: specs equal, the reset draws on the
pool's keys, the pools from seed 0 and from a carried state
(``pool_parity``). The draws are bit for bit. Steps: floats within
``DMC_CONTACT_TOL`` of ``1 + |x|``, lanes that part counted against
``DMC_CONTACT_SHARE``; none parted when the bound was set.
"""

import pytest
import torch

from _torch_parity import DMC_CONTACT_SHARE, DMC_CONTACT_TOL, pool_parity
from test_torch_dmc_classic import assert_spec_matches

torch.set_num_threads(1)

# id -> (envs, steps, carried at, reset state keys within 4 ulps)
TASKS = {
  "WalkerJaxStand-v1": (8, 6, 3, ()),
  "WalkerJaxWalk-v1": (8, 6, 3, ()),
  "WalkerJaxRun-v1": (8, 6, 3, ()),
}


@pytest.mark.parametrize("task_id", list(TASKS))
def test_spec_matches_jax_package(task_id):
  assert_spec_matches(task_id)


@pytest.mark.parametrize("task_id", list(TASKS))
def test_pool_matches_jax_package(task_id):
  n, steps, carried_at, ulp_keys = TASKS[task_id]
  pool_parity(task_id, n, steps, carried_at, DMC_CONTACT_TOL,
              DMC_CONTACT_SHARE, draws={k: 4 for k in ulp_keys})
