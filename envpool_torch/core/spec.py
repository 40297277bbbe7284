"""Array / environment schema specs.

The port's copy of ``envpool_tpu/core/spec.py`` (numpy only). A plain
re-design of the reference spec system:
- reference: compile-time C++ ``Spec<D>`` with dtype+shape+bounds
  (``envpool/core/spec.h:37-110``) surfaced to Python as ``ArraySpec``
  (``envpool/python/protocol.py:100-124``).
- here: a plain Python dataclass carrying the same information. Shapes may
  contain a leading ``-1`` meaning "dynamic per-player dimension", exactly as
  in the reference; the pool folds it to the batch dimension for
  single-player envs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np

__all__ = ["ArraySpec", "ContainerSpec", "spec_like", "zeros_from_spec"]


@dataclasses.dataclass
class ArraySpec:
  """dtype + shape + bounds description of one state/action field.

  Mirrors the reference ``ArraySpec`` (``envpool/python/protocol.py:100-124``):
  ``minimum``/``maximum`` may be scalars or (element-wise) arrays.
  """

  dtype: Any
  shape: Tuple[int, ...]
  minimum: Any = None
  maximum: Any = None

  def __post_init__(self) -> None:
    self.dtype = np.dtype(self.dtype)
    self.shape = tuple(int(s) for s in self.shape)
    if self.minimum is None:
      self.minimum = _default_min(self.dtype)
    if self.maximum is None:
      self.maximum = _default_max(self.dtype)
    if isinstance(self.minimum, (list, tuple, np.ndarray)):
      self.minimum = np.asarray(self.minimum, dtype=self.dtype)
    if isinstance(self.maximum, (list, tuple, np.ndarray)):
      self.maximum = np.asarray(self.maximum, dtype=self.dtype)

  @property
  def static_shape(self) -> Tuple[int, ...]:
    """Shape with dynamic (-1) player dims removed."""
    return tuple(s for s in self.shape if s != -1)

  def __repr__(self) -> str:
    return (
      f"ArraySpec(shape={list(self.shape)}, dtype={self.dtype}, "
      f"minimum={self.minimum}, maximum={self.maximum})"
    )


@dataclasses.dataclass
class ContainerSpec:
  """Nested dynamic-shape field — the masked-static TPU equivalent of the
  reference's ``Spec<Container<D>>`` (``envpool/core/spec.h:100-110``).

  The reference's container is a per-slot heap array whose shape varies at
  runtime (exercised by the tutorial dummy env's ``obs:dyn``,
  ``envpool/dummy/dummy_envpool.h:146-158``). XLA requires static shapes,
  so on-device the field is carried as a PAIR:

    data  — padded to ``max_shape`` (dtype = ``inner.dtype``)
    shape — int32[ndim], the actual dims of this env's value

  The env's step/reset returns ``(data, shape)`` for the key; the pool
  slices ``data`` down to ``shape`` at the host boundary and delivers a
  ragged object-array column, matching the reference's Python surface.
  Dialect spaces expose the padded static box. ``xla()`` rejects
  container specs exactly like the reference
  (``envpool/core/py_envpool.h:220-238``).

  ``inner.shape`` may contain ``-1`` for runtime-dynamic dims; every dim
  is bounded by the corresponding entry of ``max_shape``.
  """

  inner: ArraySpec
  max_shape: Tuple[int, ...]

  def __post_init__(self) -> None:
    if not isinstance(self.inner, ArraySpec):
      self.inner = ArraySpec(*self.inner)
    self.max_shape = tuple(int(s) for s in self.max_shape)
    if len(self.max_shape) != len(self.inner.shape):
      raise ValueError(
        f"max_shape {self.max_shape} rank != inner shape "
        f"{self.inner.shape} rank"
      )

  # quacks like ArraySpec for the padded static view
  @property
  def dtype(self) -> np.dtype:
    return self.inner.dtype

  @property
  def shape(self) -> Tuple[int, ...]:
    return self.max_shape

  @property
  def static_shape(self) -> Tuple[int, ...]:
    return self.max_shape

  @property
  def minimum(self) -> Any:
    return self.inner.minimum

  @property
  def maximum(self) -> Any:
    return self.inner.maximum

  @property
  def ndim(self) -> int:
    return len(self.max_shape)

  def __repr__(self) -> str:
    return (
      f"ContainerSpec(inner={self.inner!r}, max_shape={list(self.max_shape)})"
    )


def _default_min(dtype: np.dtype) -> Any:
  if dtype == np.bool_:
    return False
  if np.issubdtype(dtype, np.floating):
    return float(np.finfo(dtype).min)
  return int(np.iinfo(dtype).min)


def _default_max(dtype: np.dtype) -> Any:
  if dtype == np.bool_:
    return True
  if np.issubdtype(dtype, np.floating):
    return float(np.finfo(dtype).max)
  return int(np.iinfo(dtype).max)


def spec_like(dtype: Any, shape: Tuple[int, ...], low: Any = None,
              high: Any = None) -> ArraySpec:
  """Shorthand constructor."""
  return ArraySpec(dtype, shape, low, high)


def zeros_from_spec(spec: ArraySpec, batch: int) -> np.ndarray:
  """Allocate a zero-filled batched host array for a spec."""
  return np.zeros((batch, *spec.static_shape), dtype=spec.dtype)
