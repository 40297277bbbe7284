"""``InvertedDoublePendulumJax-v4`` and ``SwimmerJax-v4`` through the port's
pool against the JAX package's (CPU, float32): the pool half of
``tests/test_torch_mujoco_tasks.py`` for the two ids whose dynamics
amplify float32 rounding, so that lanes may part (counted against the
bound stated there)."""

import pytest

from test_torch_mujoco_tasks import pool_parity


@pytest.mark.parametrize("task_id", ["InvertedDoublePendulumJax-v4", "SwimmerJax-v4"])
def test_pool_matches_jax_package(task_id):
  pool_parity(task_id)
