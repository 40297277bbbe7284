"""Actor-critic networks of the port (``envpool_tpu/models``) and the
converter of the JAX package's parameters."""

from .convert import params_from_flax
from .nets import AtariCNN, GaussianMLPActorCritic, MLPActorCritic, SokobanCNN

__all__ = [
  "SokobanCNN",
  "AtariCNN",
  "MLPActorCritic",
  "GaussianMLPActorCritic",
  "params_from_flax",
]
