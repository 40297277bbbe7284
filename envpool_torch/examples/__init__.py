"""Example scripts of the port, the counterparts of ``examples/`` at the
repo's root (the JAX package's). Each runs as a module and takes the JAX
script's arguments plus ``--device`` (default: the CUDA device; the CPU
only when asked for)::

  python -m envpool_torch.examples.ppo_sokoban --num-envs 1024 --iterations 50
  python -m envpool_torch.examples.ppo_mujoco --task HalfCheetahJax-v4
  python -m envpool_torch.examples.xla_step
  python -m envpool_torch.examples.async_loop     # needs mujoco
  python -m envpool_torch.examples.cleanrl_ppo --num-envs 16 --iterations 40
  python -m envpool_torch.examples.sb3_example
  python -m envpool_torch.examples.tianshou_example
  python -m envpool_torch.examples.acme_example   # needs dm_env

The last three drive their library's adapter on their own where the
library (stable_baselines3, tianshou, dm-acme) is not installed; their
imports of it are made late, inside ``main``.
"""


def mesh_for(device: str):
  """The examples' mesh: ``"cuda"`` takes every CUDA device
  (``make_mesh()``, which raises without one); any other device one shard
  on it."""
  from envpool_torch.parallel import make_mesh
  if device == "cuda":
    return make_mesh()
  return make_mesh(devices=[device])
