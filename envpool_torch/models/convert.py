"""Carry the JAX package's network parameters into the port's modules."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def params_from_flax(net: nn.Module, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """A flax parameter tree of ``envpool_tpu.models`` -> ``net``'s state dict.

  ``params`` is the nested dict of arrays that ``flax`` ``init`` returns
  (``{"params": {"Conv_0": {"kernel", "bias"}, ..., "log_std"}}``, the
  ``"params"`` level optional), as numpy or any array with ``__array__``.
  Conv kernels go HWIO -> OIHW and dense kernels [in, out] -> [out, in]; the
  names are the same on both sides. ``net`` must be built (``net.init``):
  its parameters give the expected keys, shapes and the device.
  """
  tree = params.get("params", params)
  out: Dict[str, np.ndarray] = {}
  for name, leaf in tree.items():
    if not isinstance(leaf, Mapping):
      out[name] = np.asarray(leaf)
      continue
    kernel = np.asarray(leaf["kernel"])
    out[f"{name}.weight"] = (
      kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T
    )
    out[f"{name}.bias"] = np.asarray(leaf["bias"])
  want = net.state_dict()
  if set(out) != set(want):
    raise ValueError(
      f"flax parameters {sorted(out)} do not match {type(net).__name__}'s "
      f"{sorted(want)} (build it with net.init(obs) first)"
    )
  sd = {}
  for k, v in out.items():
    if tuple(v.shape) != tuple(want[k].shape):
      raise ValueError(f"{k}: flax shape {v.shape} != {tuple(want[k].shape)}")
    sd[k] = torch.from_numpy(np.array(v, np.float32)).to(want[k].device)
  return sd
