"""Device-mesh parallelism for envpool_torch (``envpool_tpu/parallel``).

The JAX package shards the env batch over a ``jax.sharding.Mesh`` and
compiles one SPMD program; here each position of a mesh's env axis holds
one block of envs on its device, advanced by its own engine, and
multi-host runs start with ``torch.distributed``.
"""

from .sharded import (
  Mesh,
  ShardedEnvPool,
  initialize_distributed,
  make_mesh,
)

__all__ = ["ShardedEnvPool", "make_mesh", "initialize_distributed"]
