"""Utility subsystems: profiling, checkpointing (``envpool_tpu/utils``)."""

from .checkpoint import load_pool_state, save_pool_state
from .profiling import StepTimer, trace

__all__ = ["StepTimer", "trace", "save_pool_state", "load_pool_state"]
