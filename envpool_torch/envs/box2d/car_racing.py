"""CarRacing-v2 — the port's batched PyTorch version of the Box2D racer.

Counterpart of ``envpool_tpu/envs/box2d/car_racing.py`` (physics
``:203-338``, the v2 render ``:749-847`` with its overlays ``:398-488``),
written batched-first over ``[N, ...]`` tensors and keeping the JAX
package's float32 operation order, so both packages agree to the last bit
wherever the two frameworks' float32 kernels do. Same physics, reward,
termination and 96x96x3 observation; same documented deviations from the
reference render (no skid marks, no score digits).

Tracks are a host-generated bank (``car_track.py``, numpy). The render's
two background banks, the four pre-rotated copies of every track's fine
1024^2 bitmap and of its zero-padded 256^2 coarse mipmap, are built once
per (seed, n_tracks, device) as uint8 palette+1 (0 = black): 32 MiB and
2 MiB at the default 8 tracks. Every render's background comes from one
call of the background sampler (``sampler.py``: one CUDA kernel launch on
the card), which takes the coarse bank during the first-second zoom
animation and the fine bank after it, per env, and applies the palette.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec

from . import car_track
from .car_track import BITMAP_RES, COARSE_RES, PALETTE, PLAYFIELD, SCALE
from .sampler import fused_background

FPS = 50.0
DT = 1.0 / FPS
SIZE = 0.02
ENGINE_POWER = 1e8 * SIZE * SIZE
WHEEL_MOI = 4000 * SIZE * SIZE
FRICTION_LIMIT = 1e6 * SIZE * SIZE
WHEEL_R = 27.0
WHEEL_W = 14.0
BRAKE_FORCE = 15.0
ZOOM = 2.7
WINDOW_W, WINDOW_H = 1000.0, 800.0
STATE_W = STATE_H = 96
FINE_WIN = 384      # fine-path window of the sampler
COARSE_WIN = 256    # coarse mipmap padded to this size

_WHEEL_POS = np.asarray(
  [[-55, 80], [55, 80], [-55, -82], [55, -82]], np.float64
) * SIZE
_HULL_POLYS = [
  np.asarray([[-60, 130], [60, 130], [60, 110], [-60, 110]], np.float64)
  * SIZE,
  np.asarray([[-15, 120], [15, 120], [20, 20], [-20, 20]], np.float64)
  * SIZE,
  np.asarray(
    [[25, 20], [50, -10], [50, -40], [20, -90], [-20, -90], [-50, -40],
     [-50, -10], [-25, 20]], np.float64
  ) * SIZE,
  np.asarray([[-50, -120], [50, -120], [50, -90], [-50, -90]], np.float64)
  * SIZE,
]


def _poly_mass(poly, density):
  area = cx = cy = inertia = 0.0
  n = len(poly)
  for i in range(n):
    x0, y0 = poly[i]
    x1, y1 = poly[(i + 1) % n]
    cr = x0 * y1 - x1 * y0
    area += cr / 2
    cx += (x0 + x1) * cr / 6
    cy += (y0 + y1) * cr / 6
    inertia += cr * (x0 * x0 + x0 * x1 + x1 * x1
                     + y0 * y0 + y0 * y1 + y1 * y1) / 12
  if area < 0:
    area, cx, cy, inertia = -area, -cx, -cy, -inertia
  return (density * area, density * inertia,
          np.asarray([cx, cy]) / max(area, 1e-12))


_HM = sum(_poly_mass(p, 1.0)[0] for p in _HULL_POLYS)
_WHEEL_M = 0.1 * (2 * WHEEL_W * SIZE) * (2 * WHEEL_R * SIZE)
CAR_MASS = _HM + 4 * _WHEEL_M
CAR_I = sum(_poly_mass(p, 1.0)[1] for p in _HULL_POLYS) + sum(
  _WHEEL_M * float(np.sum(w * w)) for w in _WHEEL_POS
)

_TMAX = 460

# window-coordinate maps of rot90^k about the array center (see the JAX
# package's ``_QUAD_A``): (r, c) lands at A_k (r, c) + b_k(S)
_QUAD_A = np.asarray([
  [[1, 0], [0, 1]],
  [[0, -1], [1, 0]],
  [[-1, 0], [0, -1]],
  [[0, 1], [-1, 0]],
], np.float32)


def _quad_b(s_dim: int) -> np.ndarray:
  m = float(s_dim - 1)
  return np.asarray([[0, 0], [m, 0], [m, m], [0, m]], np.float32)


# overlay colors (RGB), kept on the device with the other render constants
_BLACK = (0, 0, 0)
_COLORS = (
  _BLACK, (204, 0, 0), (255, 255, 255), (0, 0, 255), (51, 0, 255),
  (0, 255, 0), (255, 0, 0),
)


@functools.lru_cache(maxsize=8)
def _bank(seed: int, n_tracks: int):
  return car_track.generate_bank(seed, n_tracks, _TMAX)


def _rot_bank(bitmaps1: np.ndarray) -> np.ndarray:
  """[T, S, S] -> [4 * T * S, S]: the rot90^k copies, k = 0..3."""
  t, s, _ = bitmaps1.shape
  return np.ascontiguousarray(np.concatenate([
    np.rot90(bitmaps1, k=k, axes=(1, 2)) for k in range(4)
  ]).reshape(4 * t * s, s))


@functools.lru_cache(maxsize=4)
def _device_bank(
  seed: int, n_tracks: int, device: torch.device
) -> Dict[str, torch.Tensor]:
  """Track arrays and the two uint8 palette+1 render banks on ``device``."""
  tiles, _, n_tiles, bitmaps, coarse, init = _bank(seed, n_tracks)
  pad = (COARSE_WIN - COARSE_RES) // 2
  coarse1 = np.pad(coarse + 1, ((0, 0), (pad, pad), (pad, pad)))
  host = {
    "tiles": tiles, "n_tiles": n_tiles, "init": init,
    "fine": _rot_bank(bitmaps + 1), "coarse": _rot_bank(coarse1),
  }
  return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


@functools.lru_cache(maxsize=4)
def _constants(device: torch.device) -> Dict[str, torch.Tensor]:
  """Pixel grids and small tables of the render, per device."""
  ii, jj = torch.meshgrid(
    torch.arange(STATE_H, device=device), torch.arange(STATE_W, device=device),
    indexing="ij",
  )
  palette1 = np.concatenate([np.zeros((1, 3), np.uint8), PALETTE])
  return {
    "x_s": (jj + 0.5) * (WINDOW_W / STATE_W),
    "y_s": WINDOW_H - (ii + 0.5) * (WINDOW_H / STATE_H),
    "y_png": (ii + 0.5) * (WINDOW_H / STATE_H),  # post-flip window row
    "palette1": torch.from_numpy(palette1).to(device),
    "quad_a": torch.from_numpy(_QUAD_A).to(device),
    "quad_b_fine": torch.from_numpy(_quad_b(BITMAP_RES)).to(device),
    "quad_b_coarse": torch.from_numpy(_quad_b(COARSE_WIN)).to(device),
    "wheel_pos": torch.from_numpy(_WHEEL_POS.astype(np.float32)).to(device),
    "rear_drive": torch.tensor([0.0, 0.0, 1.0, 1.0], device=device),
    "colors": {
      c: torch.tensor(c, dtype=torch.uint8, device=device) for c in _COLORS
    },
  }


class CarRacingEnv(FuncEnv):
  """CarRacing-v2."""

  name = "CarRacing"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 900.0,
      "lap_complete_percent": 0.95,
      "n_tracks": 8,   # track-bank size (extension of the reference)
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.uint8, (96, 96, 3), 0, 255),
      "info:tile_visited_count": ArraySpec(np.int32, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "action": ArraySpec(
        np.float32, (-1, 3), [-1.0, 0.0, 0.0], [1.0, 1.0, 1.0]
      )
    }

  # ------------------------------------------------------------------ hooks

  @classmethod
  def init(cls, cfg: Any, env_ids: torch.Tensor, keys: torch.Tensor) -> Any:
    # the reset's state without its render: init never shows an obs
    del env_ids
    return cls._reset(cfg, keys, render=False)[0]

  @classmethod
  def reset(
    cls, cfg: Any, state: Any, keys: torch.Tensor
  ) -> Tuple[Any, Any, Dict]:
    del state
    return cls._reset(cfg, keys, render=True)

  @classmethod
  def step(
    cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor
  ) -> Tuple[Any, Any, torch.Tensor, torch.Tensor, Dict]:
    del keys
    return cls._step_impl(cfg, state, action.reshape(-1, 3), render=True)

  # ------------------------------------------------------------------- core

  @classmethod
  def _reset(cls, cfg: Any, keys: torch.Tensor, render: bool):
    bank = _device_bank(int(cfg.seed), int(cfg.n_tracks), keys.device)
    n = keys.shape[0]
    track_id = prng.randint(keys, (), 0, int(cfg.n_tracks))
    init_j = bank["init"][track_id.long()]

    def zeros(*shape, dtype=torch.float32):
      return torch.zeros((n, *shape), dtype=dtype, device=keys.device)

    st = {
      "track_id": track_id,
      "pos": init_j[:, 1:3],
      "vel": zeros(2),
      "angle": init_j[:, 0],
      "omega": zeros(),
      "wheel_omega": zeros(4),
      "joint_angle": zeros(2),   # front steering joints
      "gas": zeros(),
      "brake": zeros(),
      "steer": zeros(),
      "phase": zeros(4),
      "visited": zeros(_TMAX, dtype=torch.bool),
      "visited_count": zeros(dtype=torch.int32),
      "reward_acc": zeros(),
      "prev_reward": zeros(),
      "new_lap": zeros(dtype=torch.bool),
      "t": zeros(),
    }
    st, obs, _, _, info = cls._step_impl(cfg, st, None, render)
    return st, obs, info

  @classmethod
  def _step_impl(cls, cfg: Any, st: Any, action, render: bool):
    dev = st["pos"].device
    bank = _device_bank(int(cfg.seed), int(cfg.n_tracks), dev)
    n = st["pos"].shape[0]
    tid = st["track_id"].long()
    tiles = bank["tiles"][tid]                                  # [N, T, 4, 2]
    n_tiles = bank["n_tiles"][tid]                              # [N]

    is_action = action is not None
    gas, brake, steer = st["gas"], st["brake"], st["steer"]
    if is_action:
      steer = -torch.clamp(action[:, 0], -1.0, 1.0)
      # gas smoothing: += min(g - gas, 0.1) (car_dynamics.cc:108-114)
      g = torch.clamp(action[:, 1], 0.0, 1.0)
      gas = gas + torch.clamp(g - gas, max=0.1)
      brake = torch.clamp(action[:, 2], 0.0, 1.0)

    pos, vel = st["pos"], st["vel"]
    angle, omega = st["angle"], st["omega"]
    wheel_omega = st["wheel_omega"]
    joint_angle = st["joint_angle"]
    phase = st["phase"]

    # steering joints chase the target (car_dynamics.cc:128-131)
    diff = steer[:, None] - joint_angle
    jspeed = torch.sign(diff) * torch.clamp(50.0 * torch.abs(diff), max=3.0)
    joint_angle = torch.clamp(joint_angle + jspeed * DT, -0.4, 0.4)

    # wheel_pos_local @ rot(angle).T
    c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    wl = _constants(dev)["wheel_pos"]
    wheel_world = pos[:, None, :] + torch.stack([
      wl[:, 0] * c + wl[:, 1] * (-s), wl[:, 0] * s + wl[:, 1] * c,
    ], dim=-1)                                                  # [N, 4, 2]
    wheel_angle = angle[:, None] + torch.cat(
      [joint_angle, torch.zeros_like(joint_angle)], dim=1
    )

    # which tile is each wheel on? (friction + visitation)
    a = tiles[:, None]                                          # [N,1,T,4,2]
    b = torch.roll(tiles, -1, dims=2)[:, None]
    p = wheel_world[:, :, None, None, :]                        # [N,4,1,1,2]
    cross = (
      (b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1])
      - (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0])
    )                                                           # [N,4,T,4]
    on_tile = (cross <= 0).all(-1) | (cross >= 0).all(-1)       # [N, 4, T]
    valid = torch.arange(_TMAX, device=dev)[None, :] < n_tiles[:, None]
    on_tile = on_tile & valid[:, None, :]
    on_road = on_tile.any(2)                                    # [N, 4]
    friction_limit = torch.where(
      on_road, FRICTION_LIMIT, FRICTION_LIMIT * 0.6
    )

    # visitation reward (FrictionDetector, car_racing_env.cc:64-79)
    touched = on_tile.any(1)                                    # [N, T]
    newly = touched & ~st["visited"]
    visited = st["visited"] | touched
    n_new = newly.sum(1).to(torch.int32)
    visited_count = st["visited_count"] + n_new
    reward_acc = st["reward_acc"] + 1000.0 * n_new.to(torch.float32) / (
      n_tiles.to(torch.float32)
    )
    new_lap = st["new_lap"] | (
      newly[:, 0]
      & (visited_count.to(torch.float32)
         > n_tiles.to(torch.float32) * float(cfg.lap_complete_percent))
    )

    # per-wheel forces (car_dynamics.cc:133-215)
    forw = torch.stack(
      [-torch.sin(wheel_angle), torch.cos(wheel_angle)], dim=-1
    )
    side = torch.stack(
      [torch.cos(wheel_angle), torch.sin(wheel_angle)], dim=-1
    )
    r = wheel_world - pos[:, None, :]
    v_wheel = vel[:, None, :] + omega[:, None, None] * torch.stack(
      [-r[..., 1], r[..., 0]], dim=-1
    )
    vf = (forw * v_wheel).sum(-1)
    vs = (side * v_wheel).sum(-1)

    gas_w = _constants(dev)["rear_drive"] * gas[:, None]
    wheel_omega = wheel_omega + (
      DT * ENGINE_POWER * gas_w / WHEEL_MOI / (torch.abs(wheel_omega) + 5.0)
    )
    # brake (car_dynamics.cc:155-165)
    bval = torch.minimum(
      BRAKE_FORCE * brake[:, None], torch.abs(wheel_omega)
    )
    wheel_omega = torch.where(
      brake[:, None] >= 0.9, 0.0, wheel_omega - torch.sign(wheel_omega) * bval
    )
    phase = phase + wheel_omega * DT

    vr = wheel_omega * (WHEEL_R * SIZE)
    f_force = (-vf + vr) * (205000 * SIZE * SIZE)
    p_force = -vs * (205000 * SIZE * SIZE)
    force = torch.sqrt(f_force**2 + p_force**2)
    scale_down = torch.where(
      force > friction_limit, friction_limit / (force + 1e-9), 1.0
    )
    f_force = f_force * scale_down
    p_force = p_force * scale_down
    wheel_omega = wheel_omega - (
      DT * f_force * (WHEEL_R * SIZE) / WHEEL_MOI
    )

    f_vec = p_force[..., None] * side + f_force[..., None] * forw  # [N,4,2]
    total_f = f_vec.sum(1)
    total_tau = (r[..., 0] * f_vec[..., 1] - r[..., 1] * f_vec[..., 0]).sum(1)

    vel = vel + total_f / CAR_MASS * DT
    omega = omega + total_tau / CAR_I * DT
    pos = pos + vel * DT
    angle = angle + omega * DT
    t = st["t"] + DT

    # reward / termination (car_racing_env.cc:385-410)
    if is_action:
      reward_acc = reward_acc - 0.1
      step_reward = reward_acc - st["prev_reward"]
      prev_reward = reward_acc
      finished = (visited_count >= n_tiles) | new_lap
      out = (torch.abs(pos[:, 0]) > PLAYFIELD) | (
        torch.abs(pos[:, 1]) > PLAYFIELD
      )
      step_reward = torch.where(out, -100.0, step_reward)
      term = finished | out
    else:
      step_reward = torch.zeros(n, dtype=torch.float32, device=dev)
      prev_reward = st["prev_reward"]
      term = torch.zeros(n, dtype=torch.bool, device=dev)

    new_st = {
      "track_id": st["track_id"], "pos": pos, "vel": vel, "angle": angle,
      "omega": omega, "wheel_omega": wheel_omega,
      "joint_angle": joint_angle, "gas": gas, "brake": brake,
      "steer": steer, "phase": phase, "visited": visited,
      "visited_count": visited_count, "reward_acc": reward_acc,
      "prev_reward": prev_reward, "new_lap": new_lap, "t": t,
    }
    obs = _render_v2(
      bank, int(cfg.n_tracks), st["track_id"], pos, vel, angle, omega,
      joint_angle, wheel_omega, t,
    ) if render else None
    info = {"tile_visited_count": visited_count}
    return new_st, obs, step_reward.to(torch.float32), term, info


# ---------------------------------------------------------------------------
# render


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Batched [N, 2, 2] @ [N, 2] in the order of a 2-term dot."""
  return a[:, :, 0] * v[:, None, 0] + a[:, :, 1] * v[:, None, 1]


def _rotated_inputs(
  n_tracks: int,
  track_id: torch.Tensor,   # [N] int32
  s_full: int,              # per-track bitmap size S in the bank
  s_win: int,               # sampler window (== s_full: no windowing)
  m_col_i: torch.Tensor,    # d(by,bx)/di  [N, 2], full-bitmap coords
  m_col_j: torch.Tensor,    # d(by,bx)/dj  [N, 2]
  q0: torch.Tensor,         # (by, bx) of out pixel (0,0) [N, 2]
  pivot: torch.Tensor,      # rotation pivot in full coords [N, 2]
  quad_b: torch.Tensor,     # [4, 2] offsets of the rot90 maps for s_full
  quad_a: torch.Tensor,     # [4, 2, 2]
) -> Tuple[torch.Tensor, ...]:
  """One path's sampler inputs ``(scal, s1, s2, s3, s4, rows, cols)`` for
  96x96 nearest sampling along the affine p -> M p + q0 (batched port of
  the JAX package's ``_sample_rotated``): pick the pre-rotated quadrant
  bank, window around the mapped pivot at (8, 128)-aligned offsets, factor
  the residual |angle| <= 45 deg rotation into integer shears, and let the
  sampler walk them back per pixel."""
  dev = q0.device
  theta = -torch.atan2(m_col_i[:, 1], m_col_i[:, 0])
  k = torch.round(theta / (math.pi / 2)).to(torch.int32)
  km = torch.remainder(k, 4)
  a_k = quad_a[km.long()]
  b_k = quad_b[km.long()]
  m1_i = _mv(a_k, m_col_i)
  m1_j = _mv(a_k, m_col_j)
  q1 = _mv(a_k, q0) + b_k
  c1 = _mv(a_k, pivot) + b_k
  ci = torch.round(c1).to(torch.int32)
  ws = torch.stack([
    torch.clamp(
      torch.div(ci[:, 0] - s_win // 2, 8, rounding_mode="floor") * 8,
      0, s_full - s_win,
    ),
    torch.clamp(
      (torch.div(ci[:, 1], 128, rounding_mode="floor") - 1) * 128,
      0, s_full - s_win,
    ),
  ], dim=-1)
  q1 = q1 - ws
  c1 = c1 - ws
  # residual rotation of the conjugated affine
  phi = torch.atan2(m1_i[:, 1], m1_i[:, 0])
  theta_res = -phi
  a = torch.tan(theta_res / 2)
  b = -torch.sin(theta_res)
  ar = torch.arange(s_win, device=dev)
  s1 = torch.round(a[:, None] * (ar - c1[:, 0:1])).to(torch.int32)
  s2 = torch.round(b[:, None] * (ar - c1[:, 1:2])).to(torch.int32)
  # upper-triangular factor U = Rot(-phi) @ M1, Rot(-phi) = [[c, s], [-s, c]]
  cp, sp = torch.cos(phi), torch.sin(phi)
  rot = torch.stack([
    torch.stack([cp, sp], dim=-1), torch.stack([-sp, cp], dim=-1)
  ], dim=1)
  r0 = _mv(rot, q1 - c1) + c1
  u_i = _mv(rot, m1_i)
  u_j = _mv(rot, m1_j)
  u00, u01, u11 = u_i[:, 0], u_j[:, 0], u_j[:, 1]
  cc = torch.arange(s_win, device=dev).to(torch.float32)
  s4 = -torch.round(
    (u01 / u11)[:, None] * (cc - r0[:, 1:2])
  ).to(torch.int32)
  out_i = torch.arange(STATE_H, device=dev)
  rows = torch.round(r0[:, 0:1] + u00[:, None] * out_i).to(torch.int32)
  cols = torch.round(r0[:, 1:2] + u11[:, None] * out_i).to(torch.int32)
  flat_row = (km * n_tracks + track_id) * s_full + ws[:, 0]
  scal = torch.stack([
    torch.div(flat_row, 8, rounding_mode="floor"),
    torch.div(ws[:, 1], 128, rounding_mode="floor"),
  ], dim=-1).to(torch.int32)
  return scal, s1, s2, s1, s4, rows, cols


def _view(pos: torch.Tensor, angle: torch.Tensor, t: torch.Tensor):
  """The render's view: (zoom, cos, sin of the view angle, translation)."""
  zoom = (
    0.1 * SCALE * torch.clamp(1.0 - t, min=0.0)
    + ZOOM * SCALE * torch.clamp(t, max=1.0)
  )
  scroll = -pos * zoom[:, None]
  cv, sv = torch.cos(-angle), torch.sin(-angle)   # rot_v = [[cv,-sv],[sv,cv]]
  trans0 = cv * scroll[:, 0] + (-sv) * scroll[:, 1] + WINDOW_W / 2.0
  trans1 = sv * scroll[:, 0] + cv * scroll[:, 1] + WINDOW_H / 4.0
  return zoom, cv, sv, trans0, trans1


def _world_of(view, x_s, y_s, shape):
  """Window pixel -> world: (window px - trans) / zoom, times rot_v from
  the right; the per-env view reshaped to ``shape``."""
  zoom, cv, sv, trans0, trans1 = (v.reshape(shape) for v in view)
  sx = (x_s - trans0) / zoom
  sy = (y_s - trans1) / zoom
  return sx * cv + sy * sv, sx * (-sv) + sy * cv


def _background_inputs(bank, n_tracks, track_id, pos, view):
  n = pos.shape[0]
  dev = pos.device
  k = _constants(dev)

  def bm_coords(i, j, res):
    x_s = (j + 0.5) * (WINDOW_W / STATE_W)
    y_s = WINDOW_H - (i + 0.5) * (WINDOW_H / STATE_H)
    w0, w1 = _world_of(view, x_s, y_s, (n,))
    return torch.stack([(w1 + PLAYFIELD) / res, (w0 + PLAYFIELD) / res], -1)

  res_f = 2 * PLAYFIELD / BITMAP_RES
  res_c = 2 * PLAYFIELD / COARSE_RES

  # fine path: 384^2 window around the car in the four-rotation bank
  q00 = bm_coords(0.0, 0.0, res_f)
  m_i = bm_coords(1.0, 0.0, res_f) - q00
  m_j = bm_coords(0.0, 1.0, res_f) - q00
  center = torch.stack([
    (pos[:, 1] + PLAYFIELD) / res_f, (pos[:, 0] + PLAYFIELD) / res_f
  ], -1)
  fine = (bank["fine"], *_rotated_inputs(
    n_tracks, track_id, BITMAP_RES, FINE_WIN, m_i, m_j, q00, center,
    k["quad_b_fine"], k["quad_a"],
  ))

  # coarse path: whole playfield mipmap, zero-padded to 256, pivot at the
  # map center
  q00c = bm_coords(0.0, 0.0, res_c)
  m_ic = bm_coords(1.0, 0.0, res_c) - q00c
  m_jc = bm_coords(0.0, 1.0, res_c) - q00c
  pad_c = (COARSE_WIN - COARSE_RES) // 2
  coarse = (bank["coarse"], *_rotated_inputs(
    n_tracks, track_id, COARSE_WIN, COARSE_WIN, m_ic, m_jc, q00c + pad_c,
    torch.full((n, 2), (COARSE_WIN - 1) / 2.0, device=dev),
    k["quad_b_coarse"], k["quad_a"],
  ))

  # steady zoom covers <= 192 * res_f meters per axis; else coarse
  zoom = view[0]
  view_w = torch.div(
    torch.full_like(zoom, STATE_W * (WINDOW_W / STATE_W)), zoom
  )
  use_fine = view_w * 1.5 < 192 * res_f
  return fine, coarse, use_fine


def background_inputs(
  seed: int, n_tracks: int, st: Dict[str, torch.Tensor]
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...], torch.Tensor]:
  """The background kernel's inputs for the render of env state ``st`` (its
  ``track_id``, ``pos``, ``angle`` and ``t``) on ``st``'s device: the fine
  and coarse paths ``(bank, scal, s1, s2, s3, s4, rows, cols)`` and the
  per-env ``use_fine``. ``sampler.fused_background`` of these is the
  render's background before the overlays."""
  pos = st["pos"]
  bank = _device_bank(int(seed), int(n_tracks), pos.device)
  view = _view(pos, st["angle"], st["t"])
  return _background_inputs(bank, int(n_tracks), st["track_id"], pos, view)


def _render_v2(
  bank, n_tracks, track_id, pos, vel, angle, omega, joint_angle,
  wheel_omega, t,
) -> torch.Tensor:
  """Batched gather-free 96x96x3 render (``_render_v2_impl`` of the JAX
  package): the background from the fine bank (steady zoom) or the coarse
  mipmap (first-second zoom animation), chosen per env inside one kernel
  launch, then the car and indicator overlays."""
  n = pos.shape[0]
  k = _constants(pos.device)
  view = _view(pos, angle, t)
  fine, coarse, use_fine = _background_inputs(
    bank, n_tracks, track_id, pos, view
  )
  img = fused_background(fine, coarse, use_fine, k["palette1"])  # [N,96,96,3]
  world = _world_of(view, k["x_s"], k["y_s"], (n, 1, 1))
  return _overlays(
    img, world, k["y_png"], k["x_s"], pos, vel, angle, omega, joint_angle,
    wheel_omega,
  )


def _paint(img: torch.Tensor, mask: torch.Tensor, color) -> torch.Tensor:
  return torch.where(mask[..., None], _constants(img.device)["colors"][color], img)


def _in_poly(px: torch.Tensor, py: torch.Tensor, poly: np.ndarray):
  """Points inside a convex polygon (either winding), vertex by vertex."""
  a = poly.astype(np.float32)
  d = np.roll(a, -1, axis=0) - a
  all_le = all_ge = None
  for v in range(len(a)):
    cross = float(d[v, 0]) * (py - float(a[v, 1])) - float(d[v, 1]) * (
      px - float(a[v, 0])
    )
    le, ge = cross <= 0, cross >= 0
    all_le = le if all_le is None else all_le & le
    all_ge = ge if all_ge is None else all_ge & ge
  return all_le | all_ge


def _overlays(
  img, world, y_png, x_png, pos, vel, angle, omega, joint_angle, wheel_omega,
) -> torch.Tensor:
  """Car sprite + indicator bar, batched (``_overlays`` of the JAX package)."""
  n = pos.shape[0]

  def per_env(v):
    return v.reshape(n, 1, 1)

  # car overlay: world -> car frame, rel @ rot(angle)
  rel0 = world[0] - per_env(pos[:, 0])
  rel1 = world[1] - per_env(pos[:, 1])
  ch, sh = per_env(torch.cos(angle)), per_env(torch.sin(angle))
  car0 = rel0 * ch + rel1 * sh
  car1 = rel0 * (-sh) + rel1 * ch

  in_hull = _in_poly(car0, car1, _HULL_POLYS[0])
  for poly in _HULL_POLYS[1:]:
    in_hull = in_hull | _in_poly(car0, car1, poly)

  wheel_angles = torch.cat([joint_angle, torch.zeros_like(joint_angle)], 1)
  in_wheel = torch.zeros_like(in_hull)
  for w in range(4):
    wc = _WHEEL_POS[w].astype(np.float32)
    rel_w0 = car0 - float(wc[0])
    rel_w1 = car1 - float(wc[1])
    cw = per_env(torch.cos(wheel_angles[:, w]))
    sw = per_env(torch.sin(wheel_angles[:, w]))
    wxy0 = rel_w0 * cw + rel_w1 * sw
    wxy1 = rel_w0 * (-sw) + rel_w1 * cw
    in_wheel = in_wheel | (
      (torch.abs(wxy0) <= WHEEL_W * SIZE) & (torch.abs(wxy1) <= WHEEL_R * SIZE)
    )
  img = _paint(img, in_hull & ~in_wheel, (204, 0, 0))
  img = _paint(img, in_wheel, _BLACK)

  # indicator bar (car_racing_env.cc:491-560): bottom 5h rows black, then
  # value bars. h = H/40, s = W/40 in window units.
  h = WINDOW_H / 40.0
  s = WINDOW_W / 40.0
  img = _paint(img, (y_png > WINDOW_H - 5 * h).expand(n, -1, -1), _BLACK)
  true_speed = torch.sqrt((vel * vel).sum(-1))

  def vert_bar(img, place, val, color):
    y_top = WINDOW_H - (h + h * val)
    inside = (
      ((x_png >= place * s) & (x_png < (place + 1) * s))
      & (y_png >= per_env(torch.clamp(y_top, max=WINDOW_H - h)))
      & (y_png < per_env(torch.clamp(y_top, min=WINDOW_H - h)))
      & per_env(torch.abs(val) > 1e-4)
    )
    return _paint(img, inside, color)

  def horiz_bar(img, place, val, color):
    x_from = place * s
    x_to = (place + val) * s
    inside = (
      ((y_png >= WINDOW_H - 4 * h) & (y_png < WINDOW_H - 2 * h))
      & (x_png >= per_env(torch.clamp(x_to, max=x_from)))
      & (x_png < per_env(torch.clamp(x_to, min=x_from)))
      & per_env(torch.abs(val) > 1e-4)
    )
    return _paint(img, inside, color)

  img = vert_bar(img, 5, 0.02 * true_speed, (255, 255, 255))
  img = vert_bar(img, 7, 0.01 * wheel_omega[:, 0], (0, 0, 255))
  img = vert_bar(img, 8, 0.01 * wheel_omega[:, 1], (0, 0, 255))
  img = vert_bar(img, 9, 0.01 * wheel_omega[:, 2], (51, 0, 255))
  img = vert_bar(img, 10, 0.01 * wheel_omega[:, 3], (51, 0, 255))
  img = horiz_bar(img, 20, -10.0 * joint_angle[:, 0], (0, 255, 0))
  img = horiz_bar(img, 30, -0.8 * omega, (255, 0, 0))
  return img
