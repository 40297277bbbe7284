"""CarRacing track generation + rasterization (host side).

The port's copy of ``envpool_tpu/envs/box2d/car_track.py`` (numpy only).

Behavioral port of ``envpool/box2d/car_racing_env.cc:95-321`` CreateTrack:
12 noisy checkpoints on a morphed circle, a curvature-limited tracer that
chases them for 4+ laps, loop extraction with the glue check, and the
red/white borders on hard turns.

TPU redesign: instead of creating Box2D static tile bodies per reset, a
BANK of tracks is generated once per pool (seeded) and each track is baked
into (a) a padded tile-quad array used on-device for wheel/tile containment
(friction, visitation reward) and (b) a world-aligned color-index bitmap
used by the on-device renderer — per-step rendering is then an affine
gather, not 300 polygon fills.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

SCALE = 6.0
TRACK_RAD = 900 / SCALE
PLAYFIELD = 2000 / SCALE
TRACK_TURN_RATE = 0.31
TRACK_DETAIL_STEP = 21 / SCALE
TRACK_WIDTH = 40 / SCALE
BORDER = 8 / SCALE
BORDER_MIN_COUNT = 4
CHECKPOINTS = 12
GRASS_DIM = PLAYFIELD / 20.0

# palette indices for the bitmap
C_BG = 0
C_GRASS = 1
C_ROAD0 = 2      # three road shades (i % 3)
C_ROAD1 = 3
C_ROAD2 = 4
C_BORDER_WHITE = 5
C_BORDER_RED = 6

# RGB palette (the reference stores BGR cv::Scalars and converts to RGB at
# the end; values here are already RGB)
PALETTE = np.asarray(
  [
    [102, 204, 102],   # bg
    [102, 230, 102],   # grass
    [102, 102, 102],   # road shade 0
    [105, 105, 105],   # road + 2.55
    [107, 107, 107],   # road + 5.1
    [255, 255, 255],   # border white
    [255, 0, 0],       # border red
  ],
  dtype=np.uint8,
)

BITMAP_RES = 1024  # world [-PLAYFIELD, PLAYFIELD] -> 0.65 m/px


@dataclass
class Track:
  tiles: np.ndarray       # [T, 4, 2] float32 quads
  centers: np.ndarray     # [T, 2] tile centers
  bitmap: np.ndarray      # [R, R] uint8 palette indices
  init_angle: float
  init_xy: Tuple[float, float]
  n_tiles: int


def _try_create_track(rng: np.random.Generator) -> Optional[List]:
  checkpoints = []
  for c in range(CHECKPOINTS):
    noise = rng.uniform(0, 2 * math.pi / CHECKPOINTS)
    alpha = 2 * math.pi * c / CHECKPOINTS + noise
    rad = rng.uniform(TRACK_RAD / 3, TRACK_RAD)
    if c == 0:
      alpha = 0.0
      rad = 1.5 * TRACK_RAD
    elif c == CHECKPOINTS - 1:
      alpha = 2 * math.pi * c / CHECKPOINTS
      rad = 1.5 * TRACK_RAD
    checkpoints.append((alpha, rad * math.cos(alpha), rad * math.sin(alpha)))
  start_alpha = -math.pi / CHECKPOINTS

  x, y, beta = 1.5 * TRACK_RAD, 0.0, 0.0
  dest_i = 0
  laps = 0
  track = []
  no_freeze = 2500
  visited_other_side = False
  while True:
    alpha = math.atan2(y, x)
    if visited_other_side and alpha > 0:
      laps += 1
      visited_other_side = False
    if alpha < 0:
      visited_other_side = True
      alpha += 2 * math.pi
    while True:
      failed = True
      while True:
        dest_alpha, dest_x, dest_y = checkpoints[dest_i % CHECKPOINTS]
        if alpha <= dest_alpha:
          failed = False
          break
        dest_i += 1
        if dest_i % CHECKPOINTS == 0:
          break
      if not failed:
        break
      alpha -= 2 * math.pi
    r1x, r1y = math.cos(beta), math.sin(beta)
    p1x, p1y = -r1y, r1x
    dest_dx, dest_dy = dest_x - x, dest_y - y
    proj = r1x * dest_dx + r1y * dest_dy
    while beta - alpha > 1.5 * math.pi:
      beta -= 2 * math.pi
    while beta - alpha < -1.5 * math.pi:
      beta += 2 * math.pi
    prev_beta = beta
    proj *= SCALE
    if proj > 0.3:
      beta -= min(TRACK_TURN_RATE, abs(0.001 * proj))
    if proj < -0.3:
      beta += min(TRACK_TURN_RATE, abs(0.001 * proj))
    x += p1x * TRACK_DETAIL_STEP
    y += p1y * TRACK_DETAIL_STEP
    track.append((alpha, prev_beta * 0.5 + beta * 0.5, x, y))
    if laps > 4:
      break
    no_freeze -= 1
    if no_freeze == 0:
      break

  # closed-loop extraction
  i1 = i2 = -1
  i = len(track) - 1
  while True:
    if i == 0:
      return None
    pass_through_start = (
      track[i][0] > start_alpha and track[i - 1][0] <= start_alpha
    )
    if pass_through_start and i2 == -1:
      i2 = i
    elif pass_through_start and i1 == -1:
      i1 = i
      break
    i -= 1
  track = track[i1:i2 - 1]
  if not track:
    return None
  first_beta = track[0][1]
  well_glued = math.sqrt(
    (math.cos(first_beta) * (track[0][2] - track[-1][2])) ** 2
    + (math.sin(first_beta) * (track[0][3] - track[-1][3])) ** 2
  )
  if well_glued > TRACK_DETAIL_STEP:
    return None
  return track


def generate_track(rng: np.random.Generator) -> Track:
  """Generate one valid track (retrying like ResetBox2d:352-355)."""
  while True:
    track = _try_create_track(rng)
    if track is not None:
      break
  n = len(track)

  # red-white borders on hard turns (car_racing_env.cc:233-252)
  border = [False] * n
  for i in range(n):
    good = True
    oneside = 0
    for neg in range(BORDER_MIN_COUNT):
      beta1 = track[(i - neg) % n][1]
      beta2 = track[(i - neg - 1) % n][1]
      good = good and abs(beta1 - beta2) > TRACK_TURN_RATE * 0.2
      oneside += int(np.sign(beta1 - beta2))
    border[i] = good and abs(oneside) == BORDER_MIN_COUNT
  border2 = list(border)
  for i in range(n):
    if border[i]:
      for neg in range(BORDER_MIN_COUNT):
        border2[(i - neg) % n] = True
  border = border2

  tiles = np.zeros((n, 4, 2), dtype=np.float32)
  colors = np.zeros(n, dtype=np.uint8)
  border_quads = []
  border_colors = []
  for i in range(n):
    a1, b1, x1, y1 = track[i]
    a2, b2, x2, y2 = track[i - 1]
    c1, s1 = math.cos(b1), math.sin(b1)
    c2, s2 = math.cos(b2), math.sin(b2)
    tiles[i] = [
      [x1 - TRACK_WIDTH * c1, y1 - TRACK_WIDTH * s1],
      [x1 + TRACK_WIDTH * c1, y1 + TRACK_WIDTH * s1],
      [x2 + TRACK_WIDTH * c2, y2 + TRACK_WIDTH * s2],
      [x2 - TRACK_WIDTH * c2, y2 - TRACK_WIDTH * s2],
    ]
    colors[i] = C_ROAD0 + (i % 3)
    if border[i]:
      side = float(np.sign(b2 - b1)) or 1.0
      bq = np.asarray([
        [x1 + side * TRACK_WIDTH * c1, y1 + side * TRACK_WIDTH * s1],
        [x1 + side * (TRACK_WIDTH + BORDER) * c1,
         y1 + side * (TRACK_WIDTH + BORDER) * s1],
        [x2 + side * (TRACK_WIDTH + BORDER) * c2,
         y2 + side * (TRACK_WIDTH + BORDER) * s2],
        [x2 + side * TRACK_WIDTH * c2, y2 + side * TRACK_WIDTH * s2],
      ], dtype=np.float32)
      border_quads.append(bq)
      border_colors.append(C_BORDER_WHITE if i % 2 == 0 else C_BORDER_RED)

  bitmap = _rasterize(tiles, colors, border_quads, border_colors)
  centers = tiles.mean(axis=1)
  return Track(
    tiles=tiles,
    centers=centers,
    bitmap=bitmap,
    init_angle=float(track[0][1]),
    init_xy=(float(track[0][2]), float(track[0][3])),
    n_tiles=n,
  )


def _rasterize(tiles, colors, border_quads, border_colors) -> np.ndarray:
  """Bake bg/grass/borders/road into a [R, R] palette-index bitmap.

  bitmap[iy, ix] covers world [(ix+.5)*scale - PLAYFIELD, ...] with +y up
  at increasing iy (the renderer handles screen flipping).
  """
  r = BITMAP_RES
  scale = 2 * PLAYFIELD / r
  # grass checker (car_racing_env.cc:464-477: bright squares where both
  # grass-grid indices are even)
  idx = np.arange(r)
  world = (idx + 0.5) * scale - PLAYFIELD
  gx = np.floor(world / GRASS_DIM).astype(np.int64)
  even = gx % 2 == 0
  bitmap = np.where(
    even[None, :] & even[:, None], C_GRASS, C_BG
  ).astype(np.uint8)

  def fill(quad: np.ndarray, color: int) -> None:
    lo = quad.min(axis=0)
    hi = quad.max(axis=0)
    ix0 = max(int((lo[0] + PLAYFIELD) / scale) - 1, 0)
    ix1 = min(int((hi[0] + PLAYFIELD) / scale) + 2, r)
    iy0 = max(int((lo[1] + PLAYFIELD) / scale) - 1, 0)
    iy1 = min(int((hi[1] + PLAYFIELD) / scale) + 2, r)
    if ix0 >= ix1 or iy0 >= iy1:
      return
    xs = (np.arange(ix0, ix1) + 0.5) * scale - PLAYFIELD
    ys = (np.arange(iy0, iy1) + 0.5) * scale - PLAYFIELD
    px, py = np.meshgrid(xs, ys)
    inside = np.ones_like(px, dtype=bool)
    for k in range(4):
      x1, y1 = quad[k]
      x2, y2 = quad[(k + 1) % 4]
      cross = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
      inside &= cross <= 0
    bitmap[iy0:iy1, ix0:ix1][inside] = color

  for bq, bc in zip(border_quads, border_colors):
    fill(np.asarray(bq), bc)
  for i in range(len(tiles)):
    fill(tiles[i], int(colors[i]))
  return bitmap


COARSE_RES = 128  # full-playfield mipmap for the zoom-out animation


def generate_bank(seed: int, n_tracks: int, max_tiles: int = 460):
  """Stack n_tracks into padded arrays for device residence."""
  rng = np.random.default_rng(np.random.SeedSequence([seed, 0xCA2]))
  tracks = [generate_track(rng) for _ in range(n_tracks)]
  tmax = max_tiles
  tiles = np.zeros((n_tracks, tmax, 4, 2), np.float32)
  centers = np.full((n_tracks, tmax, 2), 1e6, np.float32)
  n_tiles = np.zeros(n_tracks, np.int32)
  bitmaps = np.zeros((n_tracks, BITMAP_RES, BITMAP_RES), np.uint8)
  coarse = np.zeros((n_tracks, COARSE_RES, COARSE_RES), np.uint8)
  init = np.zeros((n_tracks, 3), np.float32)  # angle, x, y
  stride = BITMAP_RES // COARSE_RES
  for i, t in enumerate(tracks):
    k = min(t.n_tiles, tmax)
    tiles[i, :k] = t.tiles[:k]
    centers[i, :k] = t.centers[:k]
    n_tiles[i] = k
    bitmaps[i] = t.bitmap
    coarse[i] = t.bitmap[::stride, ::stride]
    init[i] = (t.init_angle, *t.init_xy)
  return tiles, centers, n_tiles, bitmaps, coarse, init
