"""Tensor ops shared by image-obs env families (``envpool_tpu/ops``)."""

from .image import (
  grayscale,
  max_last_two,
  resize_area,
  stack_push,
)

__all__ = ["resize_area", "grayscale", "max_last_two", "stack_push"]
