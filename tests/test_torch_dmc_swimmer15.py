"""The port's ``SwimmerJaxSwimmer15-v1`` (CPU, float32) against the JAX
package's pool: 17 dofs, 104 capsule-capsule pairs, 430 rows and a
16-iteration Newton solve in each of 15 substeps (its JAX pool takes about
a minute to compile on one core, so it has a file of its own).

As in ``test_torch_dmc_swimmer6.py``: specs equal, the reset draws bit
for bit, the pools from seed 0 and from a carried state, lanes that part
counted against ``DMC_CONTACT_SHARE``.
"""

import torch

from _torch_parity import DMC_CONTACT_SHARE, DMC_CONTACT_TOL, pool_parity
from test_torch_dmc_classic import assert_spec_matches

torch.set_num_threads(1)

TASK = "SwimmerJaxSwimmer15-v1"


def test_spec_matches_jax_package():
  assert_spec_matches(TASK)


def test_pool_matches_jax_package():
  pool_parity(TASK, 4, 5, 3, DMC_CONTACT_TOL,
              DMC_CONTACT_SHARE, draws={})
