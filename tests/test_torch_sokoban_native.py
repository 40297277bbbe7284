"""The port's native (C++) tier: twins of ``tests/test_native.py``.

The library must build here (g++ is part of the test environment): it is
compiled into ``build/native/`` at first use and compared with the
pure-Python parser and A* solver on the same inputs.
"""

import os

import numpy as np
import torch

import envpool_torch
from envpool_torch import native
from envpool_torch.envs.sokoban.astar import SokobanSolver
from envpool_torch.envs.sokoban.level_loader import parse_level_file

torch.set_num_threads(1)

LEVELS_DIR = os.path.join(
  os.path.dirname(envpool_torch.__file__), "envs", "sokoban", "sample_levels"
)


def test_native_builds_into_build_dir() -> None:
  assert native.available(), "g++ failed to build envpool_torch/native"
  assert native._LIB.exists()
  assert native._LIB.parent == native.BUILD_DIR
  assert native.BUILD_DIR.parts[-2:] == ("build", "native")


def test_parse_parity() -> None:
  for fname in ("000.txt", "001.txt", "small.txt"):
    path = os.path.join(LEVELS_DIR, fname)
    arr = native.parse_file(path, 10)
    py = np.stack(parse_level_file(path))
    np.testing.assert_array_equal(arr, py)


def test_solver_cross_check_and_env_replay() -> None:
  levels = parse_level_file(os.path.join(LEVELS_DIR, "small.txt"))
  solved = 0
  for idx, level in enumerate(levels):
    actions = native.solve(level, node_limit=500_000)
    py_actions, _ = SokobanSolver(level).solve(200_000)
    if actions is None or py_actions is None:
      continue
    # both A* searches must find equally short solutions
    assert len(actions) == len(py_actions)
    solved += 1
    # the native solution must actually solve the port's env
    env = envpool_torch.make_gymnasium(
      "Sokoban-v0", num_envs=1, device="cpu",
      max_episode_steps=len(actions) + 2,
      min_episode_steps=len(actions) + 2,
      levels_dir=os.path.join(LEVELS_DIR, "small.txt"),
      load_sequentially=True,
    )
    env.reset()
    for _ in range(idx):
      env.reset()
    for a in actions:
      _, rew, term, trunc, _ = env.step(np.asarray([a], np.int32))
    assert term[0] and rew[0] > 9.0
  assert solved > 0
