"""PPO on the port (``envpool_tpu/train``)."""

from .ppo import (
  ClipAdam,
  PPOConfig,
  PPOState,
  make_ppo_train_step,
  ppo_init,
)

__all__ = [
  "ClipAdam",
  "PPOConfig",
  "PPOState",
  "make_ppo_train_step",
  "ppo_init",
]
