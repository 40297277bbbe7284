"""Blackjack — batched PyTorch dynamics.

The port of ``envpool_tpu/envs/toy_text/blackjack.py`` (parity target
``envpool/toy_text/blackjack.h:30-150``, sutton-and-barto / natural
variants). Hands are summarized by (raw sum, has-ace, natural), so the
state is fixed-shape. Cards are drawn uniform{1..13} capped at 10, matching
``DrawCard``.

The dealer's stick-time draw-out is a ``lax.while_loop`` in the JAX
package: under ``vmap`` it runs until every lane stops, a lane's carry
frozen once its own condition fails, and a lane's m-th card comes from the
m-th key of its own chain ``kk, kd = split(kk)``. Here the loop is bounded
and masked, with no read of the device from the host: the chain is walked
``MAX_DEALER_DRAWS`` times, all the dealer's cards are drawn in one
``randint`` over the ``[N, MAX_DEALER_DRAWS]`` keys, and the draws are
applied in order under each lane's own mask.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec

# The most cards a dealer can draw before standing: from an opening pair
# (raw total >= 2) each card adds >= 1 until the usable-ace total reaches
# 17. Found by exhaustive search over card sequences (ace, ace, then cards
# that keep the total under 17 longest); tests/test_torch_toy_text.py
# repeats the search.
MAX_DEALER_DRAWS = 10


def _draw(keys: torch.Tensor) -> torch.Tensor:
  """A card per key: ``[..., 2]`` keys -> ``[...]`` values in 1..10."""
  return torch.clamp_max(prng.randint(keys, (), 1, 14), 10)


def _sum_hand(raw: torch.Tensor, has_ace: torch.Tensor) -> torch.Tensor:
  """Usable-ace total: +10 when an ace fits under 21."""
  return torch.where(has_ace & (raw + 10 <= 21), raw + 10, raw)


def _usable_ace(raw: torch.Tensor, has_ace: torch.Tensor) -> torch.Tensor:
  return (has_ace & (raw + 10 <= 21)).to(torch.int32)


def _score(raw: torch.Tensor, has_ace: torch.Tensor) -> torch.Tensor:
  s = _sum_hand(raw, has_ace)
  return torch.where(s > 21, 0, s)


def _natural(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
  return ((c1 == 1) & (c2 == 10)) | ((c1 == 10) & (c2 == 1))


def dealer_draw_out(raw, ace, keys):
  """The dealer's hand after drawing to 17 or more, from the key ``keys``
  of each lane's chain. Bounded and masked: every lane walks
  ``MAX_DEALER_DRAWS`` links of its chain, and a draw counts only while
  that lane's total is below 17."""
  chain = []
  for _ in range(MAX_DEALER_DRAWS):
    keys, kd = prng.split(keys, 2).unbind(-2)
    chain.append(kd)
  cards = _draw(torch.stack(chain, 1))  # [N, MAX_DEALER_DRAWS]
  for card in cards.unbind(1):
    drawing = _sum_hand(raw, ace) < 17
    raw = torch.where(drawing, raw + card, raw)
    ace = ace | (drawing & (card == 1))
  return raw, ace


class BlackjackEnv(FuncEnv):
  """Blackjack-v1."""

  name = "Blackjack"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"natural": False, "sab": True}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"obs": ArraySpec(np.int32, (3,), 0, 31)}

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, 1)}

  @staticmethod
  def _obs(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([
      _sum_hand(state["p_raw"], state["p_ace"]),
      state["d_first"],
      _usable_ace(state["p_raw"], state["p_ace"]),
    ], 1).to(torch.int32)

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    p1, p2, d1, d2 = _draw(prng.split(keys, 4)).unbind(1)
    new = {
      "p_raw": p1 + p2,
      "p_ace": (p1 == 1) | (p2 == 1),
      "p_nat": _natural(p1, p2),
      "d_raw": d1 + d2,
      "d_ace": (d1 == 1) | (d2 == 1),
      "d_nat": _natural(d1, d2),
      "d_first": d1,
    }
    return new, cls._obs(new), {}

  @classmethod
  def step(cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor):
    hit = action.to(torch.int32) != 0
    k_hit, k_dealer = prng.split(keys, 2).unbind(1)

    # --- hit branch: one card to the player
    card = _draw(k_hit)
    p_raw_h = state["p_raw"] + card
    p_ace_h = state["p_ace"] | (card == 1)
    bust = _sum_hand(p_raw_h, p_ace_h) > 21

    # --- stick branch: the dealer draws to 17+
    d_raw, d_ace = dealer_draw_out(state["d_raw"], state["d_ace"], k_dealer)
    p_score = _score(state["p_raw"], state["p_ace"])
    d_score = _score(d_raw, d_ace)
    stick_rew = (
      (p_score > d_score).to(torch.float32) - (p_score < d_score).to(torch.float32)
    )
    if cfg.sab:
      stick_rew = torch.where(state["p_nat"] & ~state["d_nat"], 1.0, stick_rew)
    elif cfg.natural:
      stick_rew = torch.where(state["p_nat"] & (stick_rew == 1.0), 1.5, stick_rew)

    new = {
      "p_raw": torch.where(hit, p_raw_h, state["p_raw"]),
      "p_ace": torch.where(hit, p_ace_h, state["p_ace"]),
      "p_nat": state["p_nat"] & ~hit,
      "d_raw": torch.where(hit, state["d_raw"], d_raw),
      "d_ace": torch.where(hit, state["d_ace"], d_ace),
      "d_nat": state["d_nat"],
      "d_first": state["d_first"],
    }
    term = torch.where(hit, bust, True)
    reward = torch.where(hit, torch.where(bust, -1.0, 0.0), stick_rew)
    return new, cls._obs(new), reward.to(torch.float32), term, {}
