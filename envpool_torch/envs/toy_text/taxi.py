"""Taxi — batched PyTorch dynamics.

The port of ``envpool_tpu/envs/toy_text/taxi.py`` (parity target
``envpool/toy_text/taxi.h:30-126``): 5x5 grid with wall map, passenger at
one of 4 depots (s==4 means in taxi), destination depot t; actions:
0 south(+x) 1 north(-x) 2 east(+y) 3 west(-y) 4 pickup 5 dropoff.
Obs encoding ``((x*5+y)*5+s)*4+t`` matches gym's Taxi-v3.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec

# wall map rows "|:|::|" — movement right from (x, y) allowed iff
# map_[x][y+1] == ':'; left allowed iff map_[x][y] == ':'
_MAP = ["|:|::|", "|:|::|", "|::::|", "||:|:|", "||:|:|"]
_RIGHT_OK = np.array(
  [[r[y + 1] == ":" for y in range(5)] for r in _MAP], np.bool_
)
_LEFT_OK = np.array(
  [[r[y] == ":" for y in range(5)] for r in _MAP], np.bool_
)
# depot locations 0..3 and the depot id under each cell (-1 if none)
_LOC = np.array([[0, 0], [0, 4], [4, 0], [4, 3]], np.int32)
_LOC_MAP = -np.ones((5, 5), np.int32)
for _i, (_x, _y) in enumerate(_LOC):
  _LOC_MAP[_x, _y] = _i


@functools.lru_cache(maxsize=4)
def _tables(device: torch.device) -> Dict[str, torch.Tensor]:
  """The maps as flat device tables indexed by ``x * 5 + y`` (depots by id)."""
  return {
    "right_ok": torch.from_numpy(_RIGHT_OK.ravel()).to(device),
    "left_ok": torch.from_numpy(_LEFT_OK.ravel()).to(device),
    "loc_map": torch.from_numpy(_LOC_MAP.ravel()).to(device),
    "loc_x": torch.from_numpy(_LOC[:, 0].copy()).to(device),
    "loc_y": torch.from_numpy(_LOC[:, 1].copy()).to(device),
  }


class TaxiEnv(FuncEnv):
  """Taxi-v3."""

  name = "Taxi"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"reward_threshold": 8.0}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"obs": ArraySpec(np.int32, (-1,), 0, 499)}

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, 5)}

  @staticmethod
  def _obs(s: Dict[str, torch.Tensor]) -> torch.Tensor:
    return ((s["x"] * 5 + s["y"]) * 5 + s["s"]) * 4 + s["t"]

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    k = prng.split(keys, 4)
    # x, y in [0, 5) and s, t in [0, 4): one draw per key, two spans
    xy = prng.randint(k[:, :2], (), 0, 5)
    st = prng.randint(k[:, 2:], (), 0, 4)
    new = {"x": xy[:, 0], "y": xy[:, 1], "s": st[:, 0], "t": st[:, 1]}
    return new, cls._obs(new), {}

  @classmethod
  def step(cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor):
    tab = _tables(keys.device)
    act = action.to(torch.int32)
    x, y, s, t = state["x"], state["y"], state["s"], state["t"]
    cell = x * 5 + y
    right_ok = tab["right_ok"][cell]
    left_ok = tab["left_ok"][cell]
    loc_at = tab["loc_map"][cell]

    nx = torch.where(
      act == 0, torch.clamp_max(x + 1, 4),
      torch.where(act == 1, torch.clamp_min(x - 1, 0), x)
    )
    ny = torch.where(
      (act == 2) & right_ok, y + 1,
      torch.where((act == 3) & left_ok, y - 1, y)
    )

    # pickup
    s3 = torch.clamp_max(s, 3)
    pick_ok = (s < 4) & (x == tab["loc_x"][s3]) & (y == tab["loc_y"][s3])
    # dropoff
    drop_win = (s == 4) & (x == tab["loc_x"][t]) & (y == tab["loc_y"][t])
    drop_depot = (s == 4) & ~drop_win & (loc_at >= 0)

    ns = torch.where(
      (act == 4) & pick_ok, 4,
      torch.where(
        (act == 5) & drop_win, t,
        torch.where((act == 5) & drop_depot, loc_at, s)
      )
    )
    term = (act == 5) & drop_win
    reward = torch.where(
      (act == 4) & ~pick_ok, -10.0,
      torch.where(
        (act == 5) & drop_win, 20.0,
        torch.where((act == 5) & ~drop_win & ~drop_depot, -10.0, -1.0)
      )
    ).to(torch.float32)
    new = {
      "x": torch.where(act <= 1, nx, x),
      "y": torch.where((act == 2) | (act == 3), ny, y),
      "s": ns,
      "t": t,
    }
    return new, cls._obs(new), reward, term, {}
