"""The port's networks (``envpool_torch.models``) against the flax networks
of ``envpool_tpu.models`` on the CPU: the flax parameters carried across by
``params_from_flax``, the same numpy-seeded inputs through both.

Tolerances: float32 outputs within 1e-5 of the largest output (relative;
the two frameworks sum the products in other orders). The bf16 case within
2e-2 relative: bf16 keeps 8 bits, about 4e-3 per rounding, and the two
frameworks may round a bias add or an accumulation at other places.
Gradients of a scalar of the outputs within 1e-4 of the largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envpool_torch.models import nets as tnets
from envpool_torch.models import params_from_flax
from envpool_tpu.models import nets as jnets

torch.set_num_threads(1)


def _image(shape, seed):
  return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _vector(shape, seed):
  return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# (flax net, port net, obs): SokobanCNN on 10x10 and 7x7 covers the H·W·C
# flatten order on two sizes; AtariCNN on 84x84 the asymmetric SAME padding
# of its strided convs ((2, 2) and (1, 2))
CASES = {
  "sokoban_10": lambda dt, tdt: (
    jnets.SokobanCNN(channels=(8, 8, 8), dtype=dt),
    tnets.SokobanCNN(channels=(8, 8, 8), dtype=tdt), _image((5, 3, 10, 10), 1)),
  "sokoban_7": lambda dt, tdt: (
    jnets.SokobanCNN(channels=(8, 6, 4), dtype=dt),
    tnets.SokobanCNN(channels=(8, 6, 4), dtype=tdt), _image((4, 3, 7, 7), 2)),
  "atari_84": lambda dt, tdt: (
    jnets.AtariCNN(num_actions=6, dtype=dt),
    tnets.AtariCNN(num_actions=6, dtype=tdt), _image((2, 4, 84, 84), 3)),
  "mlp": lambda dt, tdt: (
    jnets.MLPActorCritic(num_actions=3, hidden=(16, 16), dtype=dt),
    tnets.MLPActorCritic(num_actions=3, hidden=(16, 16), dtype=tdt),
    _vector((7, 5), 4)),
  "gaussian_mlp": lambda dt, tdt: (
    jnets.GaussianMLPActorCritic(action_dim=2, hidden=(16, 16), dtype=dt),
    tnets.GaussianMLPActorCritic(action_dim=2, hidden=(16, 16), dtype=tdt),
    _vector((7, 5), 5)),
}


def _carry(case, dt=jnp.float32, tdt=torch.float32):
  jnet, tnet, obs = CASES[case](dt, tdt)
  params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs))
  params = jax.tree.map(np.asarray, params)
  tnet.init(torch.from_numpy(obs), seed=0)
  tnet.load_state_dict(params_from_flax(tnet, params))
  return jnet, tnet, params, obs


def _leaves(tree):
  return [
    np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x,
               np.float32)
    for x in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
  ]


def _assert_close(got, want, rel):
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-30)
    assert float(np.abs(g - w).max()) <= rel * scale, (
      float(np.abs(g - w).max()), scale
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_flax(case):
  jnet, tnet, params, obs = _carry(case)
  want = _leaves(jnet.apply(params, jnp.asarray(obs)))
  got = _leaves(tnet(torch.from_numpy(obs)))
  _assert_close(got, want, 1e-5)


def test_forward_bf16_matches_flax():
  """Default compute dtype (bf16): the same casts on both sides."""
  jnet, tnet, params, obs = _carry(
    "sokoban_10", jnp.bfloat16, torch.bfloat16
  )
  assert tnet.dtype == torch.bfloat16
  want = _leaves(jnet.apply(params, jnp.asarray(obs)))
  got = _leaves(tnet(torch.from_numpy(obs)))
  for g in jax.tree.leaves(tnet(torch.from_numpy(obs))):
    assert g.dtype == torch.float32     # the heads are float32
  _assert_close(got, want, 2e-2)


@pytest.mark.parametrize("case", ["sokoban_7", "gaussian_mlp"])
def test_gradient_matches_jax_grad(case):
  """The gradient of sum(out * c) + sum(value * c') over every parameter
  (the Gaussian case includes ``log_std``)."""
  jnet, tnet, params, obs = _carry(case)
  outs = jnet.apply(params, jnp.asarray(obs))
  weights = [_vector(np.shape(x), 10 + i) for i, x in enumerate(jax.tree.leaves(outs))]

  def scalar(p):
    leaves = jax.tree.leaves(jnet.apply(p, jnp.asarray(obs)))
    return sum(jnp.sum(x * w) for x, w in zip(leaves, weights))

  want = params_from_flax(tnet, jax.tree.map(np.asarray, jax.grad(scalar)(params)))
  leaves = jax.tree.leaves(
    tnet(torch.from_numpy(obs)), is_leaf=lambda x: isinstance(x, torch.Tensor)
  )
  total = sum((x * torch.from_numpy(w)).sum() for x, w in zip(leaves, weights))
  total.backward()
  got = dict(tnet.named_parameters())
  assert set(got) == set(want)
  for k in want:
    _assert_close([got[k].grad.numpy()], [want[k].numpy()], 1e-4)


def test_params_from_flax_rejects_a_mismatch():
  _, tnet, params, _ = _carry("mlp")
  other = tnets.MLPActorCritic(num_actions=3, hidden=(16, 8), dtype=torch.float32)
  other.init(torch.zeros(1, 5))
  with pytest.raises(ValueError):
    params_from_flax(other, params)
  with pytest.raises(RuntimeError):
    tnets.MLPActorCritic(num_actions=3)(torch.zeros(1, 5))   # not built


def test_own_init_follows_lecun_normal():
  """The port's own draws: zero biases and log_std, weights truncated at
  two standard deviations of a variance-1/fan_in normal; the same seed
  gives the same parameters."""
  net = tnets.GaussianMLPActorCritic(action_dim=2, hidden=(256, 256))
  net.init(torch.zeros(1, 64), seed=3)
  w = net.Dense_1.weight.detach()
  std = (1 / 256) ** 0.5
  assert abs(float(w.std()) / std - 1) < 0.02
  assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
  assert not net.Dense_0.bias.any() and not net.log_std.any()
  again = tnets.GaussianMLPActorCritic(action_dim=2, hidden=(256, 256))
  again.init(torch.zeros(1, 64), seed=3)
  for (k, a), b in zip(net.state_dict().items(), again.state_dict().values()):
    assert torch.equal(a, b), k
