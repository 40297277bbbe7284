"""LunarLander (discrete + continuous) — the port's batched PyTorch version.

Counterpart of ``envpool_tpu/envs/box2d/lunar_lander.py`` (itself a
rigid-body re-derivation of ``envpool/box2d/lunar_lander_env.cc``, not the
Box2D solver): the lander and both legs are one compound rigid body, 4
substeps of gravity, integration and projected contact impulses of its 10
hull and leg points against the piecewise-linear terrain, Box2D's sleep
rule, the reference's obs scaling, shaping reward, -100 crash and +100
rest. Same world constants, state keys, key use and float32 operation
order, written over ``[N, ...]`` tensors.

Some rewrites follow what XLA does with the JAX code. XLA turns a division
by a constant into a multiplication by its float32 reciprocal, so the port
multiplies by ``prng.inv32(c)`` where the JAX code divides by ``c``; it
folds a chain of constant factors into one (``prng.mul32``); XLA-CPU fuses
the first square of ``x * x + y * y`` into the add (``prng.fma32``). With
them the reset is bit for bit against the JAX package. The one-hot
terrain lookup, a TPU workaround, is a gather here: a sum of one value and
zeros is that value, so it is exact. XLA also contracts some multiply-adds
and its trig differs from torch's by an ulp, so the parity tests hold the
float fields to a tolerance (``tests/test_torch_box2d.py``).
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

FPS = 50.0
DT = 1.0 / FPS
SCALE = 30.0
MAIN_ENGINE_POWER = 13.0
SIDE_ENGINE_POWER = 0.6
INITIAL_RANDOM = 1000.0
LEG_AWAY = 20.0 / SCALE
LEG_DOWN = 18.0 / SCALE
LEG_W = 2.0 / SCALE
LEG_H = 8.0 / SCALE
SIDE_ENGINE_HEIGHT = 14.0 / SCALE
SIDE_ENGINE_AWAY = 12.0 / SCALE
VIEWPORT_W = 600.0 / SCALE  # 20
VIEWPORT_H = 400.0 / SCALE  # 13.33
CHUNKS = 11
HELIPAD_Y = VIEWPORT_H / 4
GRAVITY = -10.0

# lander hull polygon in body frame (lunar_lander_env.h:38-39), /SCALE
_LANDER_POLY = np.asarray(
  [[-14, 17], [-17, 0], [-17, -10], [17, -10], [17, 0], [14, 17]],
  dtype=np.float64,
) / SCALE

# contact points of the compound body: hull vertices + leg bottom corners
_LEG_TIPS = np.asarray(
  [
    [-LEG_AWAY - LEG_W, -LEG_DOWN - LEG_H],
    [-LEG_AWAY + LEG_W, -LEG_DOWN - LEG_H],
    [LEG_AWAY - LEG_W, -LEG_DOWN - LEG_H],
    [LEG_AWAY + LEG_W, -LEG_DOWN - LEG_H],
  ],
  dtype=np.float64,
)
_CONTACT_PTS = np.concatenate([_LANDER_POLY, _LEG_TIPS]).astype(np.float32)
_N_HULL_PTS = len(_LANDER_POLY)


def poly_mass(poly: np.ndarray, density: float) -> Tuple[float, float, np.ndarray]:
  """(mass, inertia about centroid, centroid) of a convex polygon."""
  area = 0.0
  cx = cy = 0.0
  inertia = 0.0
  n = len(poly)
  for i in range(n):
    x0, y0 = poly[i]
    x1, y1 = poly[(i + 1) % n]
    cross = x0 * y1 - x1 * y0
    area += cross / 2
    cx += (x0 + x1) * cross / 6
    cy += (y0 + y1) * cross / 6
    inertia += cross * (
      x0 * x0 + x0 * x1 + x1 * x1 + y0 * y0 + y0 * y1 + y1 * y1
    ) / 12
  cx, cy = cx / area, cy / area
  mass = density * area
  inertia = density * inertia - mass * (cx * cx + cy * cy)
  return mass, inertia, np.asarray([cx, cy])


# mass properties (box2d: density x area; hull density 5, legs 1)
_HULL_M, _HULL_I, _HULL_C = poly_mass(_LANDER_POLY, 5.0)
_LEG_M = 1.0 * (2 * LEG_W) * (2 * LEG_H)
_LEG_I = _LEG_M * ((2 * LEG_W) ** 2 + (2 * LEG_H) ** 2) / 12
_LEG_CS = np.asarray([[-LEG_AWAY, -LEG_DOWN], [LEG_AWAY, -LEG_DOWN]])
TOTAL_MASS = _HULL_M + 2 * _LEG_M
_COM = (
  _HULL_M * _HULL_C + _LEG_M * _LEG_CS[0] + _LEG_M * _LEG_CS[1]
) / TOTAL_MASS
TOTAL_I = (
  _HULL_I + _HULL_M * np.sum((_HULL_C - _COM) ** 2)
  + sum(_LEG_I + _LEG_M * np.sum((c - _COM) ** 2) for c in _LEG_CS)
)

# box2d sleep thresholds (b2_linearSleepTolerance etc.)
_SLEEP_LIN = 0.01
_SLEEP_ANG = 2.0 / 180.0 * math.pi
_TIME_TO_SLEEP = 0.5
_SUBSTEPS = 4
_FRICTION = 0.1


@functools.lru_cache(maxsize=4)
def _step_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
  """The legs' contact points and one substep's gravity on ``device``, made
  once: a host-to-device copy inside a step could not be captured."""
  gravity = torch.tensor(
    [0.0, np.float32(GRAVITY) * np.float32(DT / _SUBSTEPS)],
    dtype=torch.float32, device=device,
  )
  return torch.from_numpy(_CONTACT_PTS).to(device), gravity


def _terrain(keys: torch.Tensor) -> torch.Tensor:
  """Terrain knots of ``[N, 2]`` keys -> smooth_y ``[N, 11]``: 12 uniform
  heights, the flat helipad across the middle 5 knots, 3-point smoothing
  (wrapping at the left edge)."""
  height = prng.uniform(keys, (CHUNKS + 1,), 0.0, VIEWPORT_H / 2)
  mid = torch.arange(CHUNKS + 1, device=keys.device)
  flat = (mid >= CHUNKS // 2 - 2) & (mid <= CHUNKS // 2 + 2)
  height = torch.where(flat, np.float32(HELIPAD_Y).item(), height)
  prev = torch.cat([height[:, CHUNKS:], height[:, : CHUNKS - 1]], 1)
  return (prev + height[:, :CHUNKS] + height[:, 1:]) * prng.inv32(3)


def _ground_height(smooth_y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """Piecewise-linear terrain height ``[N, P]`` at ``x`` ``[N, P]`` (the
  chunks are evenly spaced), by gathering the two knots; a NaN ``x``
  gathers knot 0, as XLA converts NaN to the integer 0, and gives NaN."""
  f = torch.clamp(x * prng.inv32(VIEWPORT_W / (CHUNKS - 1)), 0.0, CHUNKS - 1 - 1e-6)
  i = torch.floor(f)
  t = f - i
  i = torch.clamp(i.to(torch.int64), 0, CHUNKS - 2)
  y0 = torch.gather(smooth_y, 1, i)
  y1 = torch.gather(smooth_y, 1, i + 1)
  return y0 * (1 - t) + y1 * t


class LunarLanderEnv(FuncEnv):
  """LunarLander-v2 (discrete)."""

  name = "LunarLander"
  continuous = False

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"reward_threshold": 200.0}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"obs": ArraySpec(np.float32, (8,), -10.0, 10.0)}

  @classmethod
  def action_spec(cls, cfg: Any) -> Dict[str, ArraySpec]:
    if cls.continuous:
      return {"action": ArraySpec(np.float32, (-1, 2), -1.0, 1.0)}
    return {"action": ArraySpec(np.int32, (-1,), 0, 3)}

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor) -> Tuple[Any, Any, Dict]:
    del state
    n, dev = keys.shape[0], keys.device
    kt, kf, kstep = prng.split(keys, 3).unbind(1)
    force = prng.uniform(kf, (2,), -INITIAL_RANDOM, INITIAL_RANDOM)
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    st = {
      "smooth_y": _terrain(kt),
      "pos": torch.stack([
        torch.full((n,), VIEWPORT_W / 2, dtype=torch.float32, device=dev),
        torch.full((n,), VIEWPORT_H, dtype=torch.float32, device=dev),
      ], 1),
      "vel": force * (DT / TOTAL_MASS),  # ApplyForceToCenter for one step
      "angle": zeros,
      "omega": zeros,
      "ground_contact": torch.zeros(n, 2, dtype=torch.float32, device=dev),
      "crashed": torch.zeros(n, dtype=torch.bool, device=dev),
      "sleep_time": zeros,
      "prev_shaping": zeros,
      "first": torch.ones(n, dtype=torch.bool, device=dev),
    }
    # the reference's Reset runs one zero-action step to produce obs
    # (lunar_lander_env.cc:313-317)
    if cls.continuous:
      zero = torch.zeros(n, 2, dtype=torch.float32, device=dev)
    else:
      zero = torch.zeros(n, dtype=torch.int32, device=dev)
    st, obs, _, _, _ = cls._physics_step(cfg, st, zero, kstep)
    return st, obs, {}

  @classmethod
  def step(
    cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor
  ) -> Tuple[Any, Any, torch.Tensor, torch.Tensor, Dict]:
    return cls._physics_step(cfg, state, action, keys)

  # ------------------------------------------------------------------ core

  @classmethod
  def _engines(cls, action: torch.Tensor):
    """(main power, side power, side direction), each ``[N]`` float32."""
    n = action.shape[0]
    if cls.continuous:
      a = torch.clamp(action.reshape(n, 2), -1.0, 1.0)
      m_power = torch.where(
        a[:, 0] > 0.0, (torch.clamp(a[:, 0], 0.0, 1.0) + 1.0) * 0.5, 0.0
      )
      direction = torch.sign(a[:, 1])
      s_power = torch.where(
        a[:, 1].abs() > 0.5, torch.clamp(a[:, 1].abs(), 0.5, 1.0), 0.0
      )
    else:
      a = action.reshape(n).to(torch.int32)
      m_power = (a == 2).to(torch.float32)
      direction = (a - 2).to(torch.float32)
      s_power = ((a == 1) | (a == 3)).to(torch.float32)
    return m_power, s_power, direction

  @classmethod
  def _physics_step(
    cls, cfg: Any, st: Any, action: torch.Tensor, keys: torch.Tensor
  ) -> Tuple[Any, Any, torch.Tensor, torch.Tensor, Dict]:
    kd = prng.split(keys, 1)[:, 0]
    disp = prng.uniform(kd, (2,), -1.0, 1.0) * prng.inv32(SCALE)
    d0, d1 = disp[:, 0], disp[:, 1]
    m_power, s_power, direction = cls._engines(action)

    angle = st["angle"]
    tip0, tip1 = torch.sin(angle), torch.cos(angle)
    side0, side1 = -tip1, tip0

    # main engine impulse (reaction on the lander only; the particle gets
    # the forward impulse, lunar_lander_env.cc:236-250)
    tmp = 4.0 / SCALE + 2.0 * d0
    ox_m = tip0 * tmp + side0 * d1
    oy_m = -tip1 * tmp - side1 * d1
    imp_main_x = -ox_m * MAIN_ENGINE_POWER * m_power
    imp_main_y = -oy_m * MAIN_ENGINE_POWER * m_power

    # side engine
    tmp_s = 3.0 * d1 + direction * SIDE_ENGINE_AWAY
    ox_s = tip0 * d0 + side0 * tmp_s
    oy_s = -tip1 * d0 - side1 * tmp_s
    imp_side_x = -ox_s * SIDE_ENGINE_POWER * s_power
    imp_side_y = -oy_s * SIDE_ENGINE_POWER * s_power
    pos_side_x = ox_s - tip0 * prng.mul32(17.0, prng.inv32(SCALE))
    pos_side_y = oy_s + tip1 * SIDE_ENGINE_HEIGHT

    # linear + angular impulse application (J = r x P)
    vel = st["vel"] + torch.stack(
      [imp_main_x + imp_side_x, imp_main_y + imp_side_y], 1
    ) * prng.inv32(TOTAL_MASS)
    omega = st["omega"] + (
      ox_m * imp_main_y - oy_m * imp_main_x
      + pos_side_x * imp_side_y - pos_side_y * imp_side_x
    ) * prng.inv32(TOTAL_I)

    pos = st["pos"]
    smooth_y = st["smooth_y"]
    crashed = st["crashed"]
    n = pos.shape[0]
    leg_contact = torch.zeros(n, 2, dtype=torch.bool, device=pos.device)
    pts, gravity = _step_constants(pos.device)
    sub_dt = DT / _SUBSTEPS
    for _ in range(_SUBSTEPS):
      vel = vel + gravity
      pos = pos + vel * sub_dt
      angle = angle + omega * sub_dt
      # world-frame contact points: r = rot(angle) @ pt
      c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
      rx = pts[:, 0] * c - pts[:, 1] * s
      ry = pts[:, 0] * s + pts[:, 1] * c
      wx, wy = pos[:, :1] + rx, pos[:, 1:] + ry
      pen = _ground_height(smooth_y, wx) - wy
      touching = pen > 0.0
      rx, ry = wx - pos[:, :1], wy - pos[:, 1:]
      # contact impulses: kill downward normal velocity at touching points
      vpt_y = vel[:, 1:] + omega[:, None] * rx
      vpt_x = vel[:, :1] - omega[:, None] * ry
      denom_n = 1.0 / TOTAL_MASS + rx**2 * prng.inv32(TOTAL_I)
      jn = torch.where(touching & (vpt_y < 0), -vpt_y / denom_n, 0.0)
      # friction impulse limited by mu * jn
      denom_t = 1.0 / TOTAL_MASS + ry**2 * prng.inv32(TOTAL_I)
      lim = _FRICTION * jn
      jt = torch.minimum(torch.maximum(-vpt_x / denom_t, -lim), lim)
      vel = vel + torch.stack([jt.sum(1), jn.sum(1)], 1) * prng.inv32(TOTAL_MASS)
      omega = omega + (rx * jn - ry * jt).sum(1) * prng.inv32(TOTAL_I)
      # positional correction (Baumgarte-style) to resolve penetration
      max_pen = torch.where(touching, pen, 0.0).amax(1)
      pos = torch.stack([pos[:, 0], pos[:, 1] + max_pen * 0.5], 1)
      # contact bookkeeping
      crashed = crashed | touching[:, :_N_HULL_PTS].any(1)
      leg_contact = leg_contact | touching[:, _N_HULL_PTS:].reshape(n, 2, 2).any(2)

    ground_contact = leg_contact.to(torch.float32)

    # sleep detection (box2d b2Island::Solve sleep logic)
    slow = ((vel * vel).sum(1) < _SLEEP_LIN**2) & (omega.abs() < _SLEEP_ANG)
    sleep_time = torch.where(slow, st["sleep_time"] + DT, 0.0)
    asleep = sleep_time >= _TIME_TO_SLEEP

    obs = torch.stack([
      (pos[:, 0] - VIEWPORT_W / 2) * prng.inv32(VIEWPORT_W / 2),
      (pos[:, 1] - HELIPAD_Y - LEG_DOWN) * prng.inv32(VIEWPORT_H / 2),
      vel[:, 0] * prng.mul32(VIEWPORT_W / 2, prng.inv32(FPS)),
      vel[:, 1] * prng.mul32(VIEWPORT_H / 2, prng.inv32(FPS)),
      angle,
      omega * prng.mul32(20.0, prng.inv32(FPS)),
      ground_contact[:, 0],
      ground_contact[:, 1],
    ], 1)

    # |(x, y)| with the first square fused into the add, as XLA-CPU does
    shaping = (
      -100.0 * (
        torch.sqrt(prng.fma32(obs[:, 0], obs[:, 0], obs[:, 1]**2))
        + torch.sqrt(prng.fma32(obs[:, 2], obs[:, 2], obs[:, 3]**2))
        + obs[:, 4].abs()
      )
      + 10.0 * (obs[:, 6] + obs[:, 7])
    )
    reward = torch.where(st["first"], 0.0, shaping - st["prev_shaping"])
    reward = reward - (m_power * 0.3 + s_power * 0.03)

    term_crash = crashed | (obs[:, 0].abs() >= 1.0)
    reward = torch.where(term_crash, -100.0, reward)
    reward = torch.where(~term_crash & asleep, 100.0, reward)
    term = term_crash | asleep

    new_st = {
      "smooth_y": smooth_y,
      "pos": pos,
      "vel": vel,
      "angle": angle,
      "omega": omega,
      "ground_contact": ground_contact,
      "crashed": crashed,
      "sleep_time": sleep_time,
      "prev_shaping": shaping,
      "first": torch.zeros_like(st["first"]),
    }
    return new_st, obs, reward, term, {}


class LunarLanderContinuousEnv(LunarLanderEnv):
  """LunarLanderContinuous-v2."""

  name = "LunarLanderContinuous"
  continuous = True
