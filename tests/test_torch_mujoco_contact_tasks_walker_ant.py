"""``Walker2dJax-v4`` and ``AntJax-v4`` (the free joint) through the port's
pool against the JAX package's (CPU, float32):
``tests/test_torch_mujoco_contact_tasks.py``'s pool parity for these two
ids, in a file of their own (one JAX compile each)."""

import pytest

from test_torch_mujoco_contact_tasks import contact_pool_parity


@pytest.mark.parametrize("task_id", ["Walker2dJax-v4", "AntJax-v4"])
def test_pool_matches_jax_package(task_id):
  contact_pool_parity(task_id)
