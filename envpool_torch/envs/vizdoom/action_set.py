"""Combined-action discretization for the port's ViZDoom family; the
port's copy of ``envpool_tpu/envs/vizdoom/action_set.py``.

Parity target: ``envpool/vizdoom/utils.h:30-132`` (``BuildActionSet``).
The reference enumerates every admissible button combination with a
recursion over the 43 global button ids; here the same enumeration is a
left-to-right scan that collects independent decision *slots* followed by
one cartesian product (earlier slots vary slowest — the recursion's
emission order).

Slot rules (identical admissibility constraints):

- plain button: off, on (SPEED is pinned on under ``force_speed``);
- antagonist pairs (MOVE_RIGHT/LEFT, MOVE_BACKWARD/FORWARD,
  TURN_RIGHT/LEFT, LOOK_UP/DOWN, MOVE_UP/DOWN, SELECT_NEXT/PREV_WEAPON,
  SELECT_NEXT/PREV_ITEM): at most one pressed -> 3 options;
- the ten SELECT_WEAPONx buttons: at most one pressed -> k+1 options;
- delta buttons: ``delta_button_config[name] = (num, min, max)`` expands
  to ``num`` evenly spaced magnitudes (absent/num<=1 -> stays 0).

This module is pure Python/NumPy (no vizdoom import) so the action-set
logic is unit-testable without the wheel.
"""

from __future__ import annotations

from itertools import product
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

BUTTONS: List[str] = [
  "ATTACK", "USE", "JUMP", "CROUCH", "TURN180", "ALTATTACK", "RELOAD",
  "ZOOM", "SPEED", "STRAFE", "MOVE_RIGHT", "MOVE_LEFT", "MOVE_BACKWARD",
  "MOVE_FORWARD", "TURN_RIGHT", "TURN_LEFT", "LOOK_UP", "LOOK_DOWN",
  "MOVE_UP", "MOVE_DOWN", "LAND", "SELECT_WEAPON1", "SELECT_WEAPON2",
  "SELECT_WEAPON3", "SELECT_WEAPON4", "SELECT_WEAPON5", "SELECT_WEAPON6",
  "SELECT_WEAPON7", "SELECT_WEAPON8", "SELECT_WEAPON9", "SELECT_WEAPON0",
  "SELECT_NEXT_WEAPON", "SELECT_PREV_WEAPON", "DROP_SELECTED_WEAPON",
  "ACTIVATE_SELECTED_ITEM", "SELECT_NEXT_ITEM", "SELECT_PREV_ITEM",
  "DROP_SELECTED_ITEM", "LOOK_UP_DOWN_DELTA", "TURN_LEFT_RIGHT_DELTA",
  "MOVE_FORWARD_BACKWARD_DELTA", "MOVE_LEFT_RIGHT_DELTA",
  "MOVE_UP_DOWN_DELTA",
]
_BUTTON_ID = {name: i for i, name in enumerate(BUTTONS)}

_SPEED = 8
_WEAPON_SELECT = range(21, 31)
_PAIR_FIRST = (10, 12, 14, 16, 18, 31, 35)  # antagonist (id, id+1) pairs
_DELTA = range(38, 43)

# one slot option = tuple of (env_position, value) assignments on top of
# an all-zeros button row
_Option = Tuple[Tuple[int, float], ...]


def _as_id(button: Union[int, str]) -> int:
  if isinstance(button, str):
    return _BUTTON_ID[button]
  return int(button)


def build_action_set(
  available: Sequence[Union[int, str]],
  force_speed: bool = False,
  delta_button_config: Dict[str, Sequence[float]] = None,
) -> np.ndarray:
  """Enumerate the combined action set.

  Args:
    available: the env's available buttons, in env order (names or
      global ids) — ``DoomGame.get_available_buttons()``.
    force_speed: pin SPEED on in every action.
    delta_button_config: name -> (num, min, max) per delta button.

  Returns:
    float64 array [n_actions, len(available)]; row i is the button
    vector for discrete action i, ordered exactly as the reference.
  """
  ids = [_as_id(b) for b in available]
  pos_of = {gid: i for i, gid in enumerate(ids)}
  deltas: Dict[int, Tuple[int, float, float]] = {}
  for name, (num, lo, hi) in (delta_button_config or {}).items():
    gid = _BUTTON_ID.get(name, -1)
    if gid >= 0:
      deltas[gid] = (int(num), float(lo), float(hi))

  slots: List[List[_Option]] = []
  cur = 0
  while cur < len(BUTTONS):
    if cur in _DELTA:
      num, lo, hi = deltas.get(cur, (0, 0.0, 0.0))
      if cur in pos_of and num > 1:
        # float32 accumulation like the reference (utils.h:52-54)
        step = np.float32((hi - lo) / (num - 1))
        vals, a = [], np.float32(lo)
        for _ in range(num):
          vals.append(float(a))
          a = a + step
        slots.append([((pos_of[cur], v),) for v in vals])
      cur += 1
    elif cur in _WEAPON_SELECT:
      opts: List[_Option] = [()]
      opts += [
        ((pos_of[w], 1.0),) for w in _WEAPON_SELECT if w in pos_of
      ]
      if len(opts) > 1:
        slots.append(opts)
      cur = 31
    elif cur in _PAIR_FIRST and cur in pos_of and cur + 1 in pos_of:
      slots.append([
        (), ((pos_of[cur], 1.0),), ((pos_of[cur + 1], 1.0),)
      ])
      cur += 2
    elif cur in pos_of:
      if cur == _SPEED and force_speed:
        slots.append([((pos_of[cur], 1.0),)])
      else:
        slots.append([(), ((pos_of[cur], 1.0),)])
      cur += 1
    else:
      cur += 1

  rows = []
  for combo in product(*slots):
    row = np.zeros(len(ids), np.float64)
    for option in combo:
      for pos, val in option:
        row[pos] = val
    rows.append(row)
  return np.stack(rows) if rows else np.zeros((1, len(ids)), np.float64)
