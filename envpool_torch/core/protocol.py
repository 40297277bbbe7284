"""Typing protocols for the public surface (the port's copy of
``envpool_tpu/core/protocol.py``).

Counterpart of ``envpool/python/protocol.py``: structural types that any
EnvSpec/EnvPool implementation (on-device or host tier) satisfies, for
downstream type-checking without importing concrete engine classes.
"""

from __future__ import annotations

from typing import (
  Any,
  Dict,
  Optional,
  Protocol,
  Tuple,
  Union,
  runtime_checkable,
)

import numpy as np

from .spec import ArraySpec

__all__ = ["ArraySpec", "EnvSpecProtocol", "EnvPoolProtocol"]


@runtime_checkable
class EnvSpecProtocol(Protocol):
  """Structural type of an environment spec (cf. protocol.py:38-99)."""

  gen_config: Any
  config: Tuple

  @property
  def state_array_spec(self) -> Dict[str, ArraySpec]:
    ...

  @property
  def action_array_spec(self) -> Dict[str, ArraySpec]:
    ...

  @property
  def reward_threshold(self) -> Optional[float]:
    ...


@runtime_checkable
class EnvPoolProtocol(Protocol):
  """Structural type of a batched env pool (cf. protocol.py:128-236)."""

  spec: Any

  def send(
    self,
    action: Union[Dict[str, Any], np.ndarray],
    env_id: Optional[np.ndarray] = None,
  ) -> None:
    ...

  def recv(self) -> Any:
    ...

  def step(
    self,
    action: Union[Dict[str, Any], np.ndarray],
    env_id: Optional[np.ndarray] = None,
  ) -> Any:
    ...

  def reset(self, env_id: Optional[np.ndarray] = None) -> Any:
    ...

  def async_reset(self) -> None:
    ...
