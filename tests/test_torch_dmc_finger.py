"""The port's three finger ids (CPU, float32) against the JAX package's
pools: capsule contacts with the touch sensors (the rows' normal forces
through the ray test of ``site_touch_forces``) and the collision-free init
from 8 candidates (spin lowers the spinner's damping: its own model).

As in ``test_torch_dmc_classic.py``: specs equal, the reset draws on the
pool's keys, the pools from seed 0 and from a carried state
(``pool_parity``). The draws: bit for bit but the turn tasks' target,
``anchor + radius sin(angle)``, within 4 units in the last place (XLA's
and torch's ``sin`` part by an ulp). Steps: floats within
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
  "FingerJaxSpin-v1": (8, 10, 6, ()),
  "FingerJaxTurnEasy-v1": (8, 10, 6, ("target",)),
  "FingerJaxTurnHard-v1": (8, 10, 6, ("target",)),
}


@pytest.mark.parametrize("task_id", list(TASKS))
def test_spec_matches_jax_package(task_id):
  assert_spec_matches(task_id)


@pytest.mark.parametrize("task_id", list(TASKS))
def test_pool_matches_jax_package(task_id):
  n, steps, carried_at, ulp_keys = TASKS[task_id]
  pool_parity(task_id, n, steps, carried_at, DMC_CONTACT_TOL,
              DMC_CONTACT_SHARE, draws={k: 4 for k in ulp_keys})
