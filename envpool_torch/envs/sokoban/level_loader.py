"""Sokoban level bank: text loader + procedural generator.

The port's copy of ``envpool_tpu/envs/sokoban/level_loader.py`` (numpy
only, unchanged, so both packages build the same banks byte for byte).
Host-side counterpart of the reference's C++ ``LevelLoader``
(``envpool/sokoban/level_loader.cc:30-216``): instead of each env lazily
streaming levels from disk on its worker thread, ALL levels are parsed once
up front into a dense ``[n_levels, dim, dim]`` uint8 bank that lives in
device memory, and per-episode level selection happens inside the batched
step (sequential round-robin cursor or uniform random pick), so resets
never leave the device.

File format (identical to the reference): levels are blocks of lines starting
with ``#``; a ``; idx`` comment line precedes each level; every line must
start and end with ``#`` and use only ``# @ $ . `` characters
(``envpool/sokoban/level_loader.cc:66-99``); the first line's ``#`` count
defines the room dimension and all lines must match it (:146-160).

Tile codes (``envpool/sokoban/level_loader.h:29-36``):
wall=0 empty=1 target=2 box_on_target=3 box=4 player=5 player_on_target=6.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

WALL, EMPTY, TARGET, BOX_ON_TARGET, BOX, PLAYER, PLAYER_ON_TARGET = range(7)
MAX_LEVEL_OBJECT = PLAYER_ON_TARGET

_CHAR_TO_TILE = {
  "#": WALL,
  " ": EMPTY,
  ".": TARGET,
  "$": BOX,
  "@": PLAYER,
}
# print key, same glyphs as the reference (level_loader.cc:61-62)
PRINT_LEVEL_KEY = "# .a$@s"


class LevelBank:
  """Dense host-side level bank plus per-level (file_idx, level_idx) tags."""

  def __init__(
    self,
    levels: np.ndarray,        # [n, dim, dim] uint8
    file_idx: np.ndarray,      # [n] int32: which file each level came from
    level_idx: np.ndarray,     # [n] int32: index within its file
    file_names: List[str],
  ) -> None:
    self.levels = levels
    self.file_idx = file_idx
    self.level_idx = level_idx
    self.file_names = file_names
    # per-file [start, length) for uniform random "pick file, then level"
    n_files = int(file_idx.max()) + 1 if len(file_idx) else 0
    starts, lengths = [], []
    for f in range(n_files):
      where = np.nonzero(file_idx == f)[0]
      starts.append(int(where[0]))
      lengths.append(len(where))
    self.file_start = np.asarray(starts, dtype=np.int32)
    self.file_len = np.asarray(lengths, dtype=np.int32)

  @property
  def n_levels(self) -> int:
    return len(self.levels)


def parse_level_file(path: str) -> List[np.ndarray]:
  """Parse one level file, with the reference's exact validation.

  Mirrors ``LevelLoader::LoadFile`` (``envpool/sokoban/level_loader.cc:
  113-178``): blocks of ``#``-initial lines, square room, row length equal
  to the ``#`` count of the first row.
  """
  levels: List[np.ndarray] = []
  with open(path, "r") as f:
    lines = f.read().split("\n")
  i = 0
  while i < len(lines):
    line = lines[i]
    if not line or line[0] != "#":
      i += 1
      continue
    dim_room = sum(1 for c in line if c == "#")
    rows = [_parse_line(line)]
    i += 1
    while i < len(lines) and lines[i] and lines[i][0] == "#":
      if len(lines[i]) != dim_room:
        raise RuntimeError(
          f"Irregular line '{lines[i]}' does not match dim_room={dim_room}"
        )
      rows.append(_parse_line(lines[i]))
      i += 1
    level = np.concatenate(rows)
    if level.size != dim_room * dim_room:
      raise RuntimeError(
        f"Room is not square: {level.size} != {dim_room}x{dim_room}"
      )
    levels.append(level.reshape(dim_room, dim_room))
  if not levels:
    raise RuntimeError(f"No levels loaded from file '{path}'")
  return levels


def _parse_line(line: str) -> np.ndarray:
  if line[0] != "#" or line[-1] != "#":
    raise RuntimeError(
      f"Line '{line}' does not start ({line[0]}) and end ({line[-1]}) "
      "with '#', as it should."
    )
  try:
    return np.asarray([_CHAR_TO_TILE[c] for c in line], dtype=np.uint8)
  except KeyError as e:
    raise RuntimeError(
      f"Line '{line}' has character {e} which is not in the valid set "
      "'#@$. '."
    ) from e


def load_bank(levels_dir: str, dim_room: int,
              n_levels_to_load: int = -1) -> LevelBank:
  """Load every level file under ``levels_dir`` (sorted by file name).

  A regular-file path loads just that file; a directory loads each regular
  file in it, sorted by name, like the reference constructor
  (``envpool/sokoban/level_loader.cc:39-53``).
  """
  if os.path.isfile(levels_dir):
    paths = [levels_dir]
  else:
    paths = sorted(
      os.path.join(levels_dir, p)
      for p in os.listdir(levels_dir)
      if os.path.isfile(os.path.join(levels_dir, p))
    )
  all_levels, file_idx, level_idx = [], [], []
  for fi, path in enumerate(paths):
    levels = parse_level_file(path)
    for li, lvl in enumerate(levels):
      if lvl.shape != (dim_room, dim_room):
        raise RuntimeError(
          f"Loaded level is not dim_room x dim_room. world_.size()="
          f"{lvl.size}, dim_room_={dim_room}"
        )
      all_levels.append(lvl)
      file_idx.append(fi)
      level_idx.append(li)
  levels_arr = np.stack(all_levels).astype(np.uint8)
  if 0 < n_levels_to_load < len(levels_arr):
    levels_arr = levels_arr[:n_levels_to_load]
    file_idx = file_idx[:n_levels_to_load]
    level_idx = level_idx[:n_levels_to_load]
  return LevelBank(
    levels_arr,
    np.asarray(file_idx, dtype=np.int32),
    np.asarray(level_idx, dtype=np.int32),
    [os.path.basename(p) for p in paths],
  )


def print_level(level: np.ndarray) -> str:
  """Render a level to the reference's glyph string
  (level_loader.cc:101-111)."""
  return "\n".join(
    "".join(PRINT_LEVEL_KEY[t] for t in row) for row in np.asarray(level)
  )


# --------------------------------------------------------------- generation

_DIRS = np.asarray([(0, -1), (0, 1), (-1, 0), (1, 0)], dtype=np.int64)


def generate_level(
  rng: np.random.Generator,
  dim_room: int = 10,
  n_boxes: int = 4,
  reverse_steps: int = 300,
  wall_density: float = 0.1,
) -> Optional[np.ndarray]:
  """Generate one solvable level by reverse play.

  Boxes start ON their targets and are *pulled* away by a random reverse
  walk, so replaying the pulls forwards solves the level — every generated
  level is solvable by construction. Returns None if the sampled layout is
  degenerate (e.g. all boxes still matched); callers retry.
  """
  d = dim_room
  world = np.full((d, d), EMPTY, dtype=np.uint8)
  world[0, :] = world[-1, :] = WALL
  world[:, 0] = world[:, -1] = WALL
  n_int = (d - 2) * (d - 2)
  # scatter interior walls + pick boxes/player from one permutation
  n_walls = int(wall_density * n_int)
  perm = rng.permutation(n_int)
  interior_xy = np.divmod(perm, d - 2)
  ixs, iys = interior_xy[0] + 1, interior_xy[1] + 1
  world[ixs[:n_walls], iys[:n_walls]] = WALL
  if n_int - n_walls < n_boxes + 1:
    return None
  bsel = slice(n_walls, n_walls + n_boxes)
  boxes = list(zip(ixs[bsel].tolist(), iys[bsel].tolist()))
  player = (int(ixs[n_walls + n_boxes]), int(iys[n_walls + n_boxes]))
  world[ixs[bsel], iys[bsel]] = BOX_ON_TARGET
  world[player] = PLAYER

  # reverse walk: a "pull" moves the player one cell away from a box and
  # drags the box into the player's old cell. All randomness drawn up front.
  actions = rng.integers(0, 4, size=reverse_steps)
  pulls = rng.random(reverse_steps) < 0.7
  px, py = player
  w = world  # local alias

  for step in range(reverse_steps):
    dx, dy = _DIRS[actions[step]]
    nx, ny = px + dx, py + dy          # cell the player steps into
    if not (0 <= nx < d and 0 <= ny < d) or w[nx, ny] not in (EMPTY, TARGET):
      continue
    bx, by = px - dx, py - dy          # cell behind the player (box source)
    pull = (
      pulls[step] and 0 <= bx < d and 0 <= by < d
      and w[bx, by] in (BOX, BOX_ON_TARGET)
    )
    # vacate player cell
    w[px, py] = TARGET if w[px, py] == PLAYER_ON_TARGET else EMPTY
    if pull:
      w[bx, by] = TARGET if w[bx, by] == BOX_ON_TARGET else EMPTY
      w[px, py] = BOX_ON_TARGET if w[px, py] == TARGET else BOX
    px, py = nx, ny
    w[px, py] = PLAYER_ON_TARGET if w[px, py] == TARGET else PLAYER
  # keep only levels expressible in the text format (no matched boxes, no
  # player-on-target: the '# @$. ' charset cannot encode those tiles) —
  # which also guarantees a non-trivial episode.
  if int((world == BOX).sum()) != n_boxes or (world == PLAYER_ON_TARGET).any():
    return None
  del boxes
  return world


def generate_bank(
  seed: int,
  n_levels: int,
  dim_room: int = 10,
  n_boxes: int = 4,
) -> LevelBank:
  """Deterministically generate a bank of solvable levels (file_idx = 0)."""
  rng = np.random.default_rng(np.random.SeedSequence([seed, dim_room]))
  levels = []
  while len(levels) < n_levels:
    lvl = generate_level(rng, dim_room=dim_room, n_boxes=n_boxes)
    if lvl is not None:
      levels.append(lvl)
  arr = np.stack(levels).astype(np.uint8)
  return LevelBank(
    arr,
    np.zeros(n_levels, dtype=np.int32),
    np.arange(n_levels, dtype=np.int32),
    ["<generated>"],
  )


def level_to_text(level: np.ndarray) -> str:
  """Inverse of parsing: render with file chars (# @$. and space)."""
  chars = {WALL: "#", EMPTY: " ", TARGET: ".", BOX: "$", PLAYER: "@",
           BOX_ON_TARGET: "$", PLAYER_ON_TARGET: "@"}
  # NOTE: the text format cannot express box-on-target / player-on-target;
  # generated banks for file export therefore re-place any matched boxes.
  return "\n".join(
    "".join(chars[int(t)] for t in row) for row in np.asarray(level)
  )
