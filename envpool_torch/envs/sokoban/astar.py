"""A* Sokoban solver — host-side tool.

The port's copy of ``envpool_tpu/envs/sokoban/astar.py`` (numpy only; not
on the device path). Counterpart of the reference's standalone solver
(``envpool/sokoban/sokoban_node.h:28-121``, ``envpool/sokoban/astar_log.cc:
22-100``): searches over (player, frozen-box-set) states, with
corner-deadlock pruning and a sum-of-Manhattan-distances heuristic, and a
CLI that walks a level file sequentially appending rows to a
``Level,Actions,Steps,SearchSteps`` CSV log (resumable: already-logged
levels are skipped).

Usage:
  python -m envpool_torch.envs.sokoban.astar LEVEL_FILE LOG_FILE \
      [--total-levels 1000] [--node-limit 1000000]
"""

from __future__ import annotations

import argparse
import heapq
import os
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from .level_loader import (
  BOX,
  BOX_ON_TARGET,
  PLAYER,
  PLAYER_ON_TARGET,
  TARGET,
  WALL,
  parse_level_file,
)

# Up, Right, Down, Left in (row, col) deltas — solver move order
# (``sokoban_node.h:29-31``). The env numbers actions up/down/left/right
# (0/1/2/3); ``SOLVER_TO_ENV_ACTION`` converts.
DELTA = ((-1, 0), (0, 1), (1, 0), (0, -1))
SOLVER_TO_ENV_ACTION = (0, 3, 1, 2)  # up, right, down, left -> env codes

Pos = Tuple[int, int]
State = Tuple[Pos, FrozenSet[Pos]]


class SokobanSolver:
  """A* search for one level."""

  def __init__(self, level: np.ndarray) -> None:
    level = np.asarray(level)
    self.dim = level.shape[0]
    self.walls = level == WALL
    self.targets: FrozenSet[Pos] = frozenset(
      (int(x), int(y))
      for x, y in np.argwhere(
        (level == TARGET) | (level == BOX_ON_TARGET)
      )
    )
    boxes = frozenset(
      (int(x), int(y))
      for x, y in np.argwhere((level == BOX) | (level == BOX_ON_TARGET))
    )
    px, py = np.argwhere(
      (level == PLAYER) | (level == PLAYER_ON_TARGET)
    )[0]
    self.start: State = ((int(px), int(py)), boxes)
    self._tlist = sorted(self.targets)

  def _wall(self, x: int, y: int) -> bool:
    if not (0 <= x < self.dim and 0 <= y < self.dim):
      return True
    return bool(self.walls[x, y])

  def _corner_dead(self, box: Pos) -> bool:
    """Box in a wall corner off-target can never be moved again
    (``SokobanNode::CornerWalls``)."""
    if box in self.targets:
      return False
    x, y = box
    vert = self._wall(x, y - 1) or self._wall(x, y + 1)
    horz = self._wall(x - 1, y) or self._wall(x + 1, y)
    return vert and horz

  def _h(self, state: State) -> float:
    """Sum over boxes of Manhattan distance to the nearest target."""
    total = 0
    for bx, by in state[1]:
      total += min(
        abs(bx - tx) + abs(by - ty) for tx, ty in self._tlist
      )
    return float(total)

  def _successors(self, state: State) -> List[Tuple[int, State]]:
    (px, py), boxes = state
    out = []
    for a, (dx, dy) in enumerate(DELTA):
      nx, ny = px + dx, py + dy
      if self._wall(nx, ny):
        continue
      if (nx, ny) in boxes:
        bx, by = nx + dx, ny + dy
        if self._wall(bx, by) or (bx, by) in boxes:
          continue
        nboxes = (boxes - {(nx, ny)}) | {(bx, by)}
        if self._corner_dead((bx, by)):
          continue
        out.append((a, ((nx, ny), nboxes)))
      else:
        out.append((a, ((nx, ny), boxes)))
    return out

  def solve(
    self, node_limit: int = 1_000_000
  ) -> Tuple[Optional[List[int]], int]:
    """Return (solver-action list or None, search steps expanded)."""
    start = self.start
    if not start[1] - self.targets and start[1]:
      return [], 0  # already solved
    open_heap: List[Tuple[float, int, State]] = []
    g: Dict[State, float] = {start: 0.0}
    came: Dict[State, Tuple[State, int]] = {}
    counter = 0
    heapq.heappush(open_heap, (self._h(start), counter, start))
    closed = set()
    steps = 0
    while open_heap and steps < node_limit:
      _, _, cur = heapq.heappop(open_heap)
      if cur in closed:
        continue
      closed.add(cur)
      steps += 1
      if not (cur[1] - self.targets):
        # reconstruct
        actions: List[int] = []
        s = cur
        while s in came:
          s, a = came[s]
          actions.append(a)
        return actions[::-1], steps
      for a, nxt in self._successors(cur):
        ng = g[cur] + 1.0
        if nxt in closed or ng >= g.get(nxt, float("inf")):
          continue
        g[nxt] = ng
        came[nxt] = (cur, a)
        counter += 1
        heapq.heappush(open_heap, (ng + self._h(nxt), counter, nxt))
    return None, steps


def solve_level(
  level: np.ndarray, node_limit: int = 1_000_000
) -> Tuple[Optional[List[int]], int]:
  """Solve one level; returns env-numbered actions (0=up,1=down,2=left,3=right).

  Uses the native C++ solver (``envpool_torch/native/sokoban_native.cpp``,
  counterpart of the reference's ``sokoban_node.cc`` A*) when the library
  is available, falling back to the pure-Python search.
  """
  from envpool_torch import native
  if native.available():
    actions = native.solve(level, node_limit)
    if actions is not None:
      return actions, -1  # the C API does not report expansion counts
  actions, steps = SokobanSolver(level).solve(node_limit)
  if actions is None:
    return None, steps
  return [SOLVER_TO_ENV_ACTION[a] for a in actions], steps


def run_astar_log(
  level_file: str,
  log_file: str,
  total_levels: int = 1000,
  node_limit: int = 1_000_000,
) -> None:
  """Sequentially solve levels from a file, appending to a resumable CSV."""
  levels = parse_level_file(level_file)
  done = 0
  if os.path.exists(log_file) and os.path.getsize(log_file) > 0:
    with open(log_file) as f:
      done = max(0, sum(1 for line in f if line.strip()) - 1)
  else:
    with open(log_file, "a") as f:
      f.write("Level,Actions,Steps,SearchSteps\n")
  with open(log_file, "a") as f:
    for idx in range(done, min(total_levels, len(levels))):
      actions, steps = SokobanSolver(levels[idx]).solve(node_limit)
      if actions is None:
        f.write(f"{idx},,-1,{steps}\n")
      else:
        acts = " ".join(str(SOLVER_TO_ENV_ACTION[a]) for a in actions)
        f.write(f"{idx},{acts},{len(actions)},{steps}\n")
      f.flush()


def main() -> None:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("level_file")
  p.add_argument("log_file")
  p.add_argument("--total-levels", type=int, default=1000)
  p.add_argument("--node-limit", type=int, default=1_000_000)
  args = p.parse_args()
  run_astar_log(
    args.level_file, args.log_file, args.total_levels, args.node_limit
  )


if __name__ == "__main__":
  main()
