"""The port's small dm_control ids (CPU, float32) against the JAX
package's pools: pendulum, acrobot, reacher and point_mass (cartpole's six
in ``test_torch_dmc_cartpole.py``).

Per id the specs are equal, and ``pool_parity`` (``_torch_parity.py``)
holds the reset state, the steps from seed 0 under numpy-seeded actions
and the steps of a pool loaded with the JAX pool's state. The reset draws
are bit for bit where they are threefry uniform draws (every ``q``);
reacher's target, ``radius * sin(angle)``, within 4 units in the last
place, and point_mass's hard mixing matrix, the cosines and sines of
bit-exact angles ``a1`` and ``a1 + delta``, within 1e-7 absolute (XLA's
and torch's ``cos`` part by an ulp, and entries near 0 have tiny ulps).
Steps: floats within
``TOL`` of ``1 + |x|``; no lane parted when the bounds were set (1 of 8
may, for a changed library).
"""

import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu

from _torch_parity import pool_parity

torch.set_num_threads(1)

TOL = 1e-4
SHARE = 0.125
# id -> (envs, steps, carried at, reset state keys not bit for bit)
TASKS = {
  "PendulumJaxSwingup-v1": (8, 20, 12, ()),
  "AcrobotJaxSwingup-v1": (8, 20, 12, ()),
  "AcrobotJaxSwingupSparse-v1": (8, 20, 12, ()),
  "ReacherJaxEasy-v1": (8, 20, 12, ("target",)),
  "ReacherJaxHard-v1": (8, 20, 12, ("target",)),
  "PointMassJaxEasy-v1": (8, 20, 12, ()),
  "PointMassJaxHard-v1": (8, 20, 12, ("wrap",)),
}
# reset state key -> its bound (see the module docstring)
BOUNDS = {"target": 4, "wrap": 1e-7
}


def assert_spec_matches(task_id):
  got, want = envpool_torch.make_spec(task_id), envpool_tpu.make_spec(task_id)
  assert got.config._replace(base_path="") == want.config._replace(base_path="")
  assert got._env_cls.__name__ == want._env_cls.__name__
  for g_spec, w_spec in ((got.state_array_spec, want.state_array_spec),
                         (got.action_array_spec, want.action_array_spec)):
    assert list(g_spec) == list(w_spec)
    for k in w_spec:
      g, w = g_spec[k], w_spec[k]
      assert (g.dtype, g.shape) == (w.dtype, w.shape), (task_id, k)
      np.testing.assert_array_equal(g.minimum, w.minimum)
      np.testing.assert_array_equal(g.maximum, w.maximum)


@pytest.mark.parametrize("task_id", list(TASKS))
def test_spec_matches_jax_package(task_id):
  assert_spec_matches(task_id)


@pytest.mark.parametrize("task_id", list(TASKS))
def test_pool_matches_jax_package(task_id):
  n, steps, carried_at, normal_keys = TASKS[task_id]
  pool_parity(task_id, n, steps, carried_at, TOL, SHARE,
              draws={k: BOUNDS[k] for k in normal_keys})
