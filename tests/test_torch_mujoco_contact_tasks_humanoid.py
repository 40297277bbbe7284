"""``HumanoidJax-v4`` through the port's pool against the JAX package's
(CPU, float32): ``tests/test_torch_mujoco_contact_tasks.py``'s pool
parity (the 376-dim observation from the last forward evaluation, the
state's ``mc``), in a file of its own (one JAX compile)."""

from test_torch_mujoco_contact_tasks import contact_pool_parity


def test_pool_matches_jax_package():
  contact_pool_parity("HumanoidJax-v4")
