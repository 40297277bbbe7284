"""envpool_torch: the PyTorch/CUDA port of envpool_tpu.

The same registry ids, dialects (gym, gymnasium, dm_env) and pool API as
``envpool_tpu``, with env families written as batched PyTorch functions and
the TPU kernels rewritten as CUDA kernels for Hopper. Pools run on the CUDA
device unless the caller passes ``device="cpu"``. Only the families the
port has are registered.
"""

import envpool_torch.entry  # noqa: F401
from envpool_torch.core.pool import state_from_numpy
from envpool_torch.registration import (
  list_all_envs,
  make,
  make_dm,
  make_gym,
  make_gymnasium,
  make_spec,
  register,
)

__version__ = "0.1.0"
__all__ = [
  "register",
  "make",
  "make_dm",
  "make_gym",
  "make_gymnasium",
  "make_spec",
  "list_all_envs",
  "state_from_numpy",
]
