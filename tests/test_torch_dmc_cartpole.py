"""The port's six cartpole ids (CPU, float32) against the JAX package's
pools: balance, balance_sparse, swingup, swingup_sparse (one pole), and
two_poles and three_poles, whose cart-box x pole-capsule pairs and
pole-pole capsules go through the box and capsule narrow phase (inactive
from the suite's inits, as in the JAX package).

As in ``test_torch_dmc_classic.py``: specs equal, the reset draws on the
pool's keys, the pools from seed 0 and from a carried state
(``pool_parity``). The draws: ``q`` bit for bit where it is a uniform draw
(balance), and within 4 units in the last place where it passes through
``normal`` (the swingup tasks' ``q``, every task's ``v``: erfinv).
"""

import pytest
import torch

from _torch_parity import pool_parity
from test_torch_dmc_classic import SHARE, TOL, assert_spec_matches

torch.set_num_threads(1)

# id -> (envs, steps, carried at, reset state keys within 4 ulps)
TASKS = {
  "CartpoleJaxBalance-v1": (8, 20, 12, ("v",)),
  "CartpoleJaxBalanceSparse-v1": (8, 20, 12, ("v",)),
  "CartpoleJaxSwingup-v1": (8, 20, 12, ("q", "v")),
  "CartpoleJaxSwingupSparse-v1": (8, 20, 12, ("q", "v")),
  "CartpoleJaxTwoPoles-v1": (8, 20, 12, ("q", "v")),
  "CartpoleJaxThreePoles-v1": (8, 20, 12, ("q", "v")),
}


@pytest.mark.parametrize("task_id", list(TASKS))
def test_spec_matches_jax_package(task_id):
  assert_spec_matches(task_id)


@pytest.mark.parametrize("task_id", list(TASKS))
def test_pool_matches_jax_package(task_id):
  n, steps, carried_at, normal_keys = TASKS[task_id]
  pool_parity(task_id, n, steps, carried_at, TOL, SHARE,
              draws={k: 4 for k in normal_keys})
