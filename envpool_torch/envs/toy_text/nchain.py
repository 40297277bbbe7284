"""NChain — batched PyTorch dynamics.

The port of ``envpool_tpu/envs/toy_text/nchain.py`` (parity target
``envpool/toy_text/nchain.h:30-100``): 5-state chain, 20% action flip,
forward (+1 state, 0 reward; 10 at the end), backward resets to 0 with
reward 2.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec


class NChainEnv(FuncEnv):
  """NChain-v0."""

  name = "NChain"

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"obs": ArraySpec(np.int32, (-1,), 0, 4)}

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, 1)}

  @staticmethod
  def reset(cfg: Any, state: Any, keys: torch.Tensor):
    del state
    s = torch.zeros(keys.shape[0], dtype=torch.int32, device=keys.device)
    return {"s": s}, s, {}

  @staticmethod
  def step(cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor):
    flip = prng.uniform(keys, (), 0.0, 1.0) < 0.2
    act = action.to(torch.int32)
    act = torch.where(flip, 1 - act, act)
    s = state["s"]
    back = act != 0
    at_end = s >= 4
    reward = torch.where(
      back, 2.0, torch.where(at_end, 10.0, 0.0)
    ).to(torch.float32)
    s = torch.where(back, 0, torch.where(at_end, s, s + 1)).to(torch.int32)
    return {"s": s}, s, reward, torch.zeros_like(back), {}
