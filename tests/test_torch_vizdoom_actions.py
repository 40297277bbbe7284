"""The port's ViZDoom combined-action set
(``envpool_torch/envs/vizdoom/action_set.py``): the twins of the 8 tests of
``tests/test_vizdoom_actions.py``, and the port's ``build_action_set``
equal to the JAX package's, row by row and in order, over every button
list, antagonist pair, weapon group and delta configuration that file
uses."""

import numpy as np
import pytest

from envpool_torch.envs.vizdoom.action_set import BUTTONS, build_action_set
from envpool_tpu.envs.vizdoom import action_set as jax_action_set


# ------------------------------------------- twins of test_vizdoom_actions.py


def test_exact_enumeration_single_plus_pair() -> None:
  # ATTACK is a free bit; MOVE_RIGHT/MOVE_LEFT are antagonists (<=1 on).
  rows = build_action_set(["ATTACK", "MOVE_RIGHT", "MOVE_LEFT"])
  expected = np.asarray([
    [0, 0, 0],
    [0, 1, 0],
    [0, 0, 1],
    [1, 0, 0],
    [1, 1, 0],
    [1, 0, 1],
  ], np.float64)
  np.testing.assert_array_equal(rows, expected)


def test_lone_pair_member_is_a_plain_button() -> None:
  # MOVE_RIGHT without MOVE_LEFT: plain on/off (factor 2, not 3)
  rows = build_action_set(["ATTACK", "MOVE_RIGHT"])
  assert len(rows) == 4


def test_force_speed_halves() -> None:
  buttons = ["ATTACK", "SPEED", "MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT"]
  free = build_action_set(buttons, force_speed=False)
  forced = build_action_set(buttons, force_speed=True)
  assert len(free) == 2 * len(forced)
  assert (forced[:, 1] == 1.0).all()          # SPEED pinned on
  # forced set == the speed-on half of the free set, same order
  speed_on = free[free[:, 1] == 1.0]
  np.testing.assert_array_equal(forced, speed_on)


def test_weapon_select_group() -> None:
  # k weapon-select buttons contribute a factor k+1 (none or exactly one)
  rows = build_action_set(
    ["ATTACK", "SELECT_WEAPON1", "SELECT_WEAPON3", "SELECT_WEAPON5"]
  )
  assert len(rows) == 2 * (3 + 1)
  weap = rows[:, 1:]
  assert (weap.sum(axis=1) <= 1).all()
  # enumeration order: none first, then ascending weapon id (utils.h:63-73)
  np.testing.assert_array_equal(
    weap[:4], [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]
  )


def test_delta_button_multiplies() -> None:
  buttons = ["ATTACK", "MOVE_FORWARD", "LOOK_UP_DOWN_DELTA"]
  base = build_action_set(buttons)
  d1 = build_action_set(
    buttons, delta_button_config={"LOOK_UP_DOWN_DELTA": [11, -10, 10]}
  )
  assert len(d1) == 11 * len(base)
  vals = np.unique(d1[:, 2])
  np.testing.assert_allclose(vals, np.arange(-10.0, 10.1, 2.0), atol=1e-5)

  buttons2 = buttons + ["MOVE_LEFT_RIGHT_DELTA"]
  d2 = build_action_set(
    buttons2,
    delta_button_config={
      "MOVE_LEFT_RIGHT_DELTA": [11, -10, 10],
      "LOOK_UP_DOWN_DELTA": [11, -10, 10],
    },
  )
  assert len(d2) == 121 * len(base)


def test_unconfigured_delta_is_inert() -> None:
  rows = build_action_set(["ATTACK", "TURN_LEFT_RIGHT_DELTA"])
  assert len(rows) == 2
  assert (rows[:, 1] == 0.0).all()


def test_antagonist_pairs_all() -> None:
  # every (id, id+1) pair in the reference's list caps at 3 options
  for first in ANTAGONIST_FIRST:
    second = BUTTONS[BUTTONS.index(first) + 1]
    rows = build_action_set([first, second])
    assert len(rows) == 3, first
    assert (rows.sum(axis=1) <= 1).all()


def test_realistic_battle_set() -> None:
  # D3Battle-like: 2 pairs + 3 singles -> 3*3*2^3 = 72
  rows = build_action_set(BATTLE)
  assert len(rows) == 2 ** 3 * 3 * 3
  assert rows.shape[1] == 7
  assert len(np.unique(rows, axis=0)) == len(rows)


# ---------------------------------------------------- against the JAX package

ANTAGONIST_FIRST = ("MOVE_RIGHT", "MOVE_BACKWARD", "TURN_RIGHT", "LOOK_UP",
                    "MOVE_UP", "SELECT_NEXT_WEAPON", "SELECT_NEXT_ITEM")
BATTLE = ["ATTACK", "USE", "SPEED",
          "MOVE_FORWARD", "MOVE_BACKWARD", "TURN_LEFT", "TURN_RIGHT"]
DELTA_ONE = {"LOOK_UP_DOWN_DELTA": [11, -10, 10]}
DELTA_TWO = {"MOVE_LEFT_RIGHT_DELTA": [11, -10, 10],
             "LOOK_UP_DOWN_DELTA": [11, -10, 10]}

# (buttons, force_speed, delta_button_config): every call of the JAX file,
# each antagonist pair in both orders, the weapon group alone and whole,
# the delta configurations over their buttons, and the tests' fake scenario
CASES = [
  (["ATTACK", "MOVE_RIGHT", "MOVE_LEFT"], False, None),
  (["ATTACK", "MOVE_RIGHT"], False, None),
  (["ATTACK", "SPEED", "MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT"], False, None),
  (["ATTACK", "SPEED", "MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT"], True, None),
  (["ATTACK", "SELECT_WEAPON1", "SELECT_WEAPON3", "SELECT_WEAPON5"], False, None),
  ([f"SELECT_WEAPON{i}" for i in (0, 9, 5, 1)], False, None),
  (["ATTACK"] + [f"SELECT_WEAPON{i}" for i in range(10)], True, None),
  (["ATTACK", "MOVE_FORWARD", "LOOK_UP_DOWN_DELTA"], False, None),
  (["ATTACK", "MOVE_FORWARD", "LOOK_UP_DOWN_DELTA"], False, DELTA_ONE),
  (["ATTACK", "MOVE_FORWARD", "LOOK_UP_DOWN_DELTA", "MOVE_LEFT_RIGHT_DELTA"],
   False, DELTA_TWO),
  (["MOVE_LEFT_RIGHT_DELTA", "ATTACK", "LOOK_UP_DOWN_DELTA"], True, DELTA_TWO),
  (["ATTACK", "TURN_LEFT_RIGHT_DELTA"], False, None),
  (["ATTACK", "TURN_LEFT_RIGHT_DELTA"], False,
   {"TURN_LEFT_RIGHT_DELTA": [1, -5, 5]}),
  (["TURN_LEFT_RIGHT_DELTA", "MOVE_UP_DOWN_DELTA"], False,
   {"TURN_LEFT_RIGHT_DELTA": [3, -0.1, 0.7], "MOVE_UP_DOWN_DELTA": [4, 0, 1],
    "NOT_A_BUTTON": [5, 0, 1]}),
  (BATTLE, False, None),
  (BATTLE, True, None),
  (["MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT", "ATTACK"], False, None),
  ([0, 14, 15, 38], False, {"LOOK_UP_DOWN_DELTA": [5, -2, 2]}),
  ([], False, None),
]
for _first in ANTAGONIST_FIRST:
  _second = BUTTONS[BUTTONS.index(_first) + 1]
  CASES += [([_first, _second], False, None), ([_second, "ATTACK", _first], False, None)]


@pytest.mark.parametrize("buttons,force_speed,deltas", CASES)
def test_action_set_matches_jax(buttons, force_speed, deltas) -> None:
  got = build_action_set(buttons, force_speed, deltas)
  want = jax_action_set.build_action_set(buttons, force_speed, deltas)
  assert got.dtype == want.dtype == np.float64
  assert got.shape == want.shape
  np.testing.assert_array_equal(got, want)


def test_constants_match_jax() -> None:
  from envpool_torch.envs.vizdoom import action_set as port
  assert port.BUTTONS == jax_action_set.BUTTONS
  assert port._BUTTON_ID == jax_action_set._BUTTON_ID
  assert port._SPEED == jax_action_set._SPEED
  assert list(port._WEAPON_SELECT) == list(jax_action_set._WEAPON_SELECT)
  assert port._PAIR_FIRST == jax_action_set._PAIR_FIRST
  assert list(port._DELTA) == list(jax_action_set._DELTA)
