"""CliffWalking — batched PyTorch dynamics.

The port of ``envpool_tpu/envs/toy_text/cliffwalking.py`` (parity target
``envpool/toy_text/cliffwalking.h:30-100``): 4x12 grid, start (3,0),
stepping onto the cliff (row 3, cols 1..10) costs -100 and teleports back
to start, goal (3,11) terminates; every move costs -1.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec


class CliffWalkingEnv(FuncEnv):
  """CliffWalking-v0."""

  name = "CliffWalking"

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"obs": ArraySpec(np.int32, (-1,), 0, 47)}

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, 3)}

  @staticmethod
  def reset(cfg: Any, state: Any, keys: torch.Tensor):
    del state
    n = keys.shape[0]
    x = torch.full((n,), 3, dtype=torch.int32, device=keys.device)
    y = torch.zeros_like(x)
    return {"x": x, "y": y}, x * 12 + y, {}

  @staticmethod
  def step(cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor):
    del keys
    act = action.to(torch.int32)
    # 0 up(-x) 1 right(+y) 2 down(+x) 3 left(-y)
    dx = torch.where(act == 0, -1, torch.where(act == 2, 1, 0))
    dy = torch.where(act == 1, 1, torch.where(act == 3, -1, 0))
    x = torch.clamp(state["x"] + dx, 0, 3).to(torch.int32)
    y = torch.clamp(state["y"] + dy, 0, 11).to(torch.int32)
    on_cliff = (x == 3) & (y > 0) & (y < 11)
    reward = torch.where(on_cliff, -100.0, -1.0).to(torch.float32)
    x = torch.where(on_cliff, 3, x)
    y = torch.where(on_cliff, 0, y)
    term = (x == 3) & (y == 11)
    return {"x": x, "y": y}, x * 12 + y, reward, term, {}
