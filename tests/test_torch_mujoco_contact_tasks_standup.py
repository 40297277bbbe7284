"""``HumanoidStandupJax-v4`` through the port's pool against the JAX
package's (CPU, float32): ``tests/test_torch_mujoco_contact_tasks.py``'s
pool parity, in a file of its own (one JAX compile)."""

from test_torch_mujoco_contact_tasks import contact_pool_parity


def test_pool_matches_jax_package():
  contact_pool_parity("HumanoidStandupJax-v4")
