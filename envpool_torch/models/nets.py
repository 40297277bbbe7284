"""Actor-critic networks of the port, as ``nn.Module``s.

The port of ``envpool_tpu/models/nets.py``: the same classes, constructor
arguments and outputs, ``(logits, value)`` or ``((mean, log_std), value)``.
Parameters carry flax's names (``Conv_0.weight``, ``Dense_2.bias``,
``log_std``) so that ``convert.params_from_flax`` maps one tree onto the
other name for name.

- Dtype flow: the JAX package's, with explicit casts (no autocast), so the
  CPU and the card compute the same thing. Parameters are float32; a layer
  of compute dtype ``dtype`` casts its input and its parameters to it; the
  float32 heads promote their input to float32. Image obs become
  ``obs.to(dtype) / 255``.
- Layout: NCHW, held as channels-last in memory, so that the flatten in
  flax's H·W·C order before the first dense layer (the activations
  permuted to NHWC) is a view on the card.
- Padding: flax's "SAME", ``total = max((ceil(in / s) - 1) * s + k - in, 0)``
  split with the smaller half first, so AtariCNN's strided convs pad
  asymmetrically (84 -> (2, 2), 21 -> (1, 2)).
- Shapes are taken from the first observation, as flax's ``init`` does:
  ``net.init(obs, seed)`` builds the parameters and draws them, on the CPU,
  from the port's threefry stream (``prng.truncated_normal`` of
  ``fold_in(PRNGKey(seed), i)`` for the i-th parameter): flax's
  initialisers in distribution and algorithm (``lecun_normal``: a normal
  truncated at two standard deviations, scaled to variance 1 / fan_in; zero
  biases; ``log_std`` zeros), not its keys. A ``torch.Generator``'s draws
  are not promised to match between torch releases (a run seeded alike went
  otherwise under torch 2.11 than under 2.13), and the same seed must give
  the same net on every machine.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from envpool_torch.core import prng

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# whose normal truncated to [-2, 2] has this standard deviation
_TRUNC_STD = 0.87962566103423978


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
  total = max((math.ceil(size / s) - 1) * s + k - size, 0)
  return total // 2, total - total // 2


class _Dense(nn.Module):
  """``nn.Dense``: ``weight`` [out, in] (flax's kernel transposed), ``bias``."""

  def __init__(self, n_in: int, n_out: int) -> None:
    super().__init__()
    self.weight = nn.Parameter(torch.zeros(n_out, n_in))
    self.bias = nn.Parameter(torch.zeros(n_out))

  def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))

  def forward_columns(self, blocks: Sequence[torch.Tensor], bias: torch.Tensor,
                      x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``forward`` with the weight given as output-feature blocks on their
    devices: each block's outputs on its device, gathered on ``x``'s."""
    return _gather_columns(
      blocks, bias, x, -1,
      lambda xd, w, b: F.linear(xd.to(dtype), w.to(dtype), b.to(dtype)),
    )


class _Conv(nn.Module):
  """``nn.Conv`` with "SAME" padding: ``weight`` OIHW (flax's HWIO kernel
  transposed), ``bias``."""

  def __init__(self, n_in: int, n_out: int, k: int, stride: int) -> None:
    super().__init__()
    self.weight = nn.Parameter(torch.zeros(n_out, n_in, k, k))
    self.bias = nn.Parameter(torch.zeros(n_out))
    self.stride = stride

  def _pad(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    k, s = self.weight.shape[-1], self.stride
    (top, bottom), (left, right) = (_same_pad(n, k, s) for n in x.shape[-2:])
    if (top, left) == (bottom, right):
      return x, (top, left)
    return F.pad(x, (left, right, top, bottom)), (0, 0)

  def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    x, padding = self._pad(x)
    return F.conv2d(
      x.to(dtype), self.weight.to(dtype), self.bias.to(dtype), self.stride,
      padding,
    )

  def forward_columns(self, blocks: Sequence[torch.Tensor], bias: torch.Tensor,
                      x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``forward`` with the weight given as output-channel blocks on their
    devices: each block's channels on its device, gathered on ``x``'s."""
    x, padding = self._pad(x)
    return _gather_columns(
      blocks, bias, x, 1,
      lambda xd, w, b: F.conv2d(
        xd.to(dtype), w.to(dtype), b.to(dtype), self.stride, padding
      ),
    )


def _gather_columns(blocks, bias, x, dim, layer):
  """Run ``layer(x, weight block, bias slice)`` per block on the block's
  device, and concatenate the outputs along ``dim`` on ``x``'s device.
  ``x`` enters in float32 (the layers cast it back, exactly), so that
  autograd sums the blocks' gradients of ``x`` in float32 where the whole
  layer's one GEMM would have accumulated them."""
  if x.is_floating_point() and x.element_size() < 4:
    x = x.float()
  outs, start = [], 0
  for w in blocks:
    b = bias[start:start + w.shape[0]].to(w.device)
    outs.append(layer(x.to(w.device), w, b).to(x.device))
    start += w.shape[0]
  return torch.cat(outs, dim)


def forward_split(net: nn.Module, params: Dict[str, torch.Tensor],
                  columns: Dict[str, Sequence[torch.Tensor]],
                  obs: torch.Tensor) -> Any:
  """``net(obs)`` under ``params`` (its state dict, on ``obs``'s device),
  except that each weight named in ``columns`` is given as blocks of its
  output features (dim 0 of the ``[out, in]`` and OIHW layouts) on the
  devices of a model axis: column-parallel layers, each layer's output
  gathered before the next one uses it. Biases are whole."""
  layers = {
    f"{name}.weight": m for name, m in net.named_modules()
    if isinstance(m, (_Dense, _Conv))
  }
  missing = set(columns) - set(layers)
  if missing:
    raise ValueError(f"{sorted(missing)} are not weights of dense or conv layers")
  patched = []
  try:
    for name, blocks in columns.items():
      layer = layers[name]
      bias = params[name[:-len("weight")] + "bias"]
      layer.forward = functools.partial(layer.forward_columns, blocks, bias)
      patched.append(layer)
    whole = {k: v for k, v in params.items() if k not in columns}
    return torch.func.functional_call(net, whole, (obs,), strict=False)
  finally:
    for layer in patched:
      del layer.forward


class _ActorCritic(nn.Module):
  """Parameters built from the first observation's shape (``init``)."""

  def _layers(self, obs_shape: Tuple[int, ...]) -> Dict[str, Any]:
    """The layers (and bare parameters) for one observation's shape, by
    flax name."""
    raise NotImplementedError

  def init(self, obs: torch.Tensor, seed: int = 0) -> "_ActorCritic":
    """Build the parameters for observations shaped like ``obs`` (a batch)
    on its device, drawn from the threefry stream of ``seed``."""
    for name, layer in self._layers(tuple(obs.shape[1:])).items():
      setattr(self, name, layer)
    key = prng.prng_key(seed)
    with torch.no_grad():
      for i, (name, p) in enumerate(self.named_parameters()):
        if name.endswith(".weight"):
          std = math.sqrt(1.0 / p[0].numel()) / _TRUNC_STD
          draw = prng.truncated_normal(prng.fold_in(key, i), p.shape, -2.0, 2.0)
          p.copy_(draw * std)
        else:
          p.zero_()
    self.built = True
    return self.to(obs.device)

  def _check_built(self) -> None:
    if not getattr(self, "built", False):
      raise RuntimeError(
        f"{type(self).__name__}: call init(obs, seed) before the first call"
      )


class _ConvTrunk(_ActorCritic):
  """Conv layers, flatten in H·W·C order, one relu dense layer."""

  convs: Sequence[Tuple[int, int, int]]   # (channels, kernel, stride)
  hidden: int

  def _layers(self, obs_shape):
    c, h, w = obs_shape
    layers: Dict[str, nn.Module] = {}
    for i, (ch, k, s) in enumerate(self.convs):
      layers[f"Conv_{i}"] = _Conv(c, ch, k, s)
      c, h, w = ch, math.ceil(h / s), math.ceil(w / s)
    layers["Dense_0"] = _Dense(c * h * w, self.hidden)
    layers["Dense_1"] = _Dense(self.hidden, self.num_actions)
    layers["Dense_2"] = _Dense(self.hidden, 1)
    return layers

  def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    self._check_built()
    dt = self.dtype
    x = (obs.to(dt) / 255.0).contiguous(memory_format=torch.channels_last)
    for i in range(len(self.convs)):
      x = F.relu(getattr(self, f"Conv_{i}")(x, dt))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(self.Dense_0(x, dt))
    logits = self.Dense_1(x, torch.float32)
    value = self.Dense_2(x, torch.float32)[..., 0]
    return logits, value


class SokobanCNN(_ConvTrunk):
  """Conv actor-critic for [B, 3, D, D] uint8 Sokoban observations: three
  3×3 convs, a 256-unit dense layer, the logits and value heads."""

  def __init__(
    self, num_actions: int = 4, channels: Sequence[int] = (128, 128, 128),
    dtype: torch.dtype = torch.bfloat16,
  ) -> None:
    super().__init__()
    self.num_actions, self.channels, self.dtype = num_actions, tuple(channels), dtype
    self.convs = [(ch, 3, 1) for ch in self.channels]
    self.hidden = 256


class AtariCNN(_ConvTrunk):
  """Nature-CNN actor-critic for [B, stack, 84, 84] uint8 frames."""

  def __init__(self, num_actions: int, dtype: torch.dtype = torch.bfloat16) -> None:
    super().__init__()
    self.num_actions, self.dtype = num_actions, dtype
    self.convs = [(32, 8, 4), (64, 4, 2), (64, 3, 1)]
    self.hidden = 512


class _MLPTrunk(_ActorCritic):
  """tanh dense layers, then the heads (``Dense_k``, ``Dense_{k+1}``)."""

  hidden: Sequence[int]
  n_out: int

  def _layers(self, obs_shape):
    sizes: List[int] = [math.prod(obs_shape), *self.hidden]
    layers: Dict[str, nn.Module] = {
      f"Dense_{i}": _Dense(a, b) for i, (a, b) in enumerate(zip(sizes, sizes[1:]))
    }
    k = len(self.hidden)
    layers[f"Dense_{k}"] = _Dense(sizes[-1], self.n_out)
    layers[f"Dense_{k + 1}"] = _Dense(sizes[-1], 1)
    return layers

  def _trunk(self, obs: torch.Tensor) -> torch.Tensor:
    self._check_built()
    x = obs.to(self.dtype)
    for i in range(len(self.hidden)):
      x = torch.tanh(getattr(self, f"Dense_{i}")(x, self.dtype))
    return x

  def _heads(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    k = len(self.hidden)
    out = getattr(self, f"Dense_{k}")(x, torch.float32)
    value = getattr(self, f"Dense_{k + 1}")(x, torch.float32)[..., 0]
    return out, value


class MLPActorCritic(_MLPTrunk):
  """MLP actor-critic for low-dimensional observations (classic control)."""

  def __init__(
    self, num_actions: int, hidden: Sequence[int] = (256, 256),
    dtype: torch.dtype = torch.bfloat16,
  ) -> None:
    super().__init__()
    self.num_actions, self.hidden, self.dtype = num_actions, tuple(hidden), dtype
    self.n_out = num_actions

  def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return self._heads(self._trunk(obs))


class GaussianMLPActorCritic(_MLPTrunk):
  """MLP actor-critic with a diagonal-Gaussian policy head; ``log_std`` is
  a state-independent learnable vector. Returns ((mean, log_std), value)."""

  def __init__(
    self, action_dim: int, hidden: Sequence[int] = (256, 256),
    dtype: torch.dtype = torch.bfloat16,
  ) -> None:
    super().__init__()
    self.action_dim, self.hidden, self.dtype = action_dim, tuple(hidden), dtype
    self.n_out = action_dim

  def _layers(self, obs_shape):
    return {**super()._layers(obs_shape),
            "log_std": nn.Parameter(torch.zeros(self.action_dim))}

  def forward(self, obs: torch.Tensor):
    mean, value = self._heads(self._trunk(obs))
    return (mean, self.log_std.expand_as(mean)), value
