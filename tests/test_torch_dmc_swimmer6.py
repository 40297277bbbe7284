"""The port's swimmer ids (CPU, float32) against the JAX package's pools,
one per file (each JAX pool's compile is most of its time): here
``SwimmerJaxSwimmer6-v1``, the 6-link chain in a viscous medium with 14
capsule-capsule pairs; ``SwimmerJaxSwimmer15-v1`` in
``test_torch_dmc_swimmer15.py``.

As in ``test_torch_dmc_classic.py``: the spec equal, the reset draws bit
for bit on the pool's keys, the pools from seed 0 and from a carried state
(``pool_parity``). Steps: floats within ``DMC_CONTACT_TOL`` of ``1 + |x|``,
lanes that part counted against ``DMC_CONTACT_SHARE``; none parted when
the bound was set.
"""

import torch

from _torch_parity import DMC_CONTACT_SHARE, DMC_CONTACT_TOL, pool_parity
from test_torch_dmc_classic import assert_spec_matches

torch.set_num_threads(1)

TASK = "SwimmerJaxSwimmer6-v1"


def test_spec_matches_jax_package():
  assert_spec_matches(TASK)


def test_pool_matches_jax_package():
  pool_parity(TASK, 8, 8, 4, DMC_CONTACT_TOL, DMC_CONTACT_SHARE, draws={})
