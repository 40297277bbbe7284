"""BipedalWalker (normal + hardcore) — the port's batched PyTorch version.

Counterpart of ``envpool_tpu/envs/box2d/bipedal_walker.py`` (a
generalized-coordinate re-derivation of ``envpool/box2d/bipedal_walker_env.cc``,
not the Box2D solver): the walker is q = [hull_x, hull_y, hull_angle, and
the absolute angles of upper leg 1, lower leg 1, upper leg 2, lower leg 2],
with Euler-Lagrange dynamics ``M(q) qdd = gravity + motors - (Mdot qd -
dT/dq)``, 8 substeps of a linear solve, projected contact impulses of 9
points with friction, a positional correction and the joint limits, then a
10-ray lidar ray-march over the heightfield. Same constants, state keys,
key use, terrain state machine, obs, reward and termination, written over
``[N, ...]`` tensors.

Dynamics in closed form. The JAX package takes the Jacobians, ``M`` and the
Coriolis terms from ``jax.jacfwd``, ``jax.grad`` and ``jax.jvp`` of the
body kinematics. Here every point the step needs (the 5 centres of mass
and the 9 contact points) is ``p + sum_k R(a_k) v[point, k]`` for the
hull position ``p``, the 5 body angles ``a`` and constant body-frame
vectors ``v``, so its Jacobian column for angle ``k`` is ``R(a_k + pi/2)
v[point, k]`` and ``Mdot qd - dT/dq = sum_b m_b J_b^T Jdot_b qd`` with
``Jdot_b qd = -sum_k R(a_k) v[b, k] qd_k^2``: a few batched tensor ops per
substep in place of nested forward-mode autodiff. The two agree to float32
rounding (``tests/test_torch_bipedal_walker.py`` holds the step to a
tolerance from states carried over from the JAX package). The solve and
the inverse are ``torch.linalg.solve_ex`` and ``inv_ex``, which never read
the result back to the host; products run with TF32 off on the card.

Matched to XLA's float32 arithmetic, not tolerated: the terrain (a
division by a constant becomes a multiplication by its reciprocal,
``prng.inv32``; XLA-CPU contracts the walk's ``0.8 * vel + 0.01 * sign(...)``
and the stairs' ``base + steps * rise`` into fused multiply-adds; bit for
bit against the JAX package) and the
lidar fractions (numpy's float32 ``linspace``, which is ``jnp.linspace``'s,
not torch's). The one-hot terrain lookups, a TPU workaround, are gathers.
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
from envpool_torch.ops.image import no_tf32

from .lunar_lander import poly_mass

FPS = 50.0
DT = 1.0 / FPS
SCALE = 30.0
MOTORS_TORQUE = 80.0
SPEED_HIP = 4.0
SPEED_KNEE = 6.0
LIDAR_RANGE = 160.0 / SCALE
INITIAL_RANDOM = 5.0
LEG_DOWN = -8.0 / SCALE
LEG_W = 8.0 / SCALE
LEG_H = 34.0 / SCALE
VIEWPORT_W = 600.0 / SCALE
VIEWPORT_H = 400.0 / SCALE
TERRAIN_STEP = 14.0 / SCALE
TERRAIN_LENGTH = 200
TERRAIN_GRASS = 10
TERRAIN_STARTPAD = 20
TERRAIN_HEIGHT = VIEWPORT_H / 4
LIDAR_NUM = 10
LIDAR_SAMPLES = 64
FRICTION = 2.5
GRAVITY = -10.0
_SUBSTEPS = 8
_N_OBSTACLES = 12

_HULL_POLY = np.asarray(
  [[-30, 9], [6, 9], [34, 1], [34, -8], [-30, -8]], dtype=np.float64
) / SCALE


HULL_M, HULL_I, HULL_C = poly_mass(_HULL_POLY, 5.0)
ULEG_M = 1.0 * LEG_W * LEG_H
ULEG_I = ULEG_M * (LEG_W ** 2 + LEG_H ** 2) / 12
LLEG_M = 1.0 * (0.8 * LEG_W) * LEG_H
LLEG_I = LLEG_M * ((0.8 * LEG_W) ** 2 + LEG_H ** 2) / 12

_MASSES = np.asarray([HULL_M, ULEG_M, LLEG_M, ULEG_M, LLEG_M])
_INERTIAS = np.asarray([HULL_I, ULEG_I, LLEG_I, ULEG_I, LLEG_I])

# lidar directions (bipedal_walker_env.cc:317-321)
_LIDAR_DIR = np.stack([
  np.asarray([math.sin(1.5 * i / 10.0), -math.cos(1.5 * i / 10.0)])
  for i in range(LIDAR_NUM)
]) * LIDAR_RANGE
# the ray-march's sample fractions: float32 linspace as jnp.linspace makes
# it (torch.linspace differs in the last bit at about half the entries)
LIDAR_FRACTIONS = np.linspace(
  np.float32(0.0), np.float32(1.0), LIDAR_SAMPLES, dtype=np.float32
)

# contact points in body frames: lower-leg soles + hull vertices
_SOLE = np.asarray([
  [-0.4 * LEG_W, -LEG_H / 2], [0.4 * LEG_W, -LEG_H / 2]
])

# joints: hip1 couples (hull=2 -> 3), knee1 (3 -> 4), hip2 (2 -> 5), knee2
# (5 -> 6); joint angle and velocity are child minus parent (box2d)
_PARENT = [2, 3, 2, 5]
_CHILD = [3, 4, 5, 6]
_JOINT_REF = [-0.05, 0.0, 0.05, 0.0]
_JOINT_LO = [-0.8, -1.6, -0.8, -1.6]
_JOINT_HI = [1.1, -0.1, 1.1, -0.1]
_MOTOR_SPEED = [SPEED_HIP, SPEED_KNEE, SPEED_HIP, SPEED_KNEE]


def _point_table() -> np.ndarray:
  """``v[point, k]``: body-frame vectors with which point = hull position +
  sum_k R(angle_k) v[point, k], angles (hull, upper 1, lower 1, upper 2,
  lower 2). Points: the 5 centres of mass (hull, upper 1, lower 1, upper
  2, lower 2), then the contact points (2 soles of lower leg 1, 2 of lower
  leg 2, 5 hull vertices)."""
  half = LEG_H / 2
  pivot = [0.0, LEG_DOWN]
  v = np.zeros((14, 5, 2))
  v[0, 0] = HULL_C
  for leg, (ku, kl) in enumerate(((1, 2), (3, 4))):
    com_u, com_l = 1 + 2 * leg, 2 + 2 * leg
    v[com_u, 0] = pivot
    v[com_u, ku] = [0.0, -half]
    v[com_l, 0] = pivot
    v[com_l, ku] = [0.0, -2 * half]
    v[com_l, kl] = [0.0, -half]
    for j in range(2):
      sole = 5 + 2 * leg + j
      v[sole] = v[com_l]
      v[sole, kl] = _SOLE[j] + [0.0, -half]
  v[9:14, 0] = _HULL_POLY
  return v


@functools.lru_cache(maxsize=4)
def _constants(device: torch.device) -> Dict[str, torch.Tensor]:
  v = _point_table().astype(np.float32)
  # R(a) v = cos(a) v + sin(a) (-v_y, v_x)
  v_perp = np.stack([-v[..., 1], v[..., 0]], -1)
  rot_inertia = np.zeros(7, np.float32)
  rot_inertia[2:] = _INERTIAS
  dirs = _LIDAR_DIR.astype(np.float32)
  host = {
    "v": v,
    "v_perp": v_perp,
    "masses": _MASSES.astype(np.float32),
    "rot_inertia": np.diag(rot_inertia),
    "eye": np.broadcast_to(np.eye(2, dtype=np.float32), (14, 2, 2)).copy(),
    "ref": np.asarray(_JOINT_REF, np.float32),
    # the joints' body indices as device tensors: indexing with a host list
    # would copy it to the device at every step
    "child": np.asarray(_CHILD, np.int64),
    "parent": np.asarray(_PARENT, np.int64),
    "lo": np.asarray(_JOINT_LO, np.float32),
    "hi": np.asarray(_JOINT_HI, np.float32),
    "motor_speed": np.asarray(_MOTOR_SPEED, np.float32),
    # a constant product XLA folds: the lidar's ray offsets
    "ray": dirs[:, None, :] * LIDAR_FRACTIONS[None, :, None],
    "fractions": LIDAR_FRACTIONS,
    "init_q": np.asarray([
      TERRAIN_STEP * TERRAIN_STARTPAD / 2, TERRAIN_HEIGHT + 2 * LEG_H,
      0.0, -0.05, -0.15, 0.05, -0.05,
    ], np.float32),
  }
  return {k: torch.from_numpy(x).to(device) for k, x in host.items()}


def _grass(keys: torch.Tensor) -> torch.Tensor:
  """The reference's grass random walk (``bipedal_walker_env.cc:123-128``)
  of ``[N, 2]`` keys -> terrain heights ``[N, 200]``, in XLA-CPU's
  rounding: the noise scaled by the float32 reciprocal of SCALE, the
  velocity update one fused multiply-add."""
  k1 = prng.split(keys, 2)[:, 0]
  noise = prng.uniform(k1, (TERRAIN_LENGTH,), -1.0, 1.0) * prng.inv32(SCALE)
  height = float(np.float32(TERRAIN_HEIGHT))
  y = torch.full((keys.shape[0],), height, device=keys.device)
  vel = torch.zeros_like(y)
  ys = []
  for i in range(TERRAIN_LENGTH):
    vel = prng.fma32(vel, float(np.float32(0.8)), torch.sign(height - y) * 0.01)
    if i > TERRAIN_STARTPAD:
      vel = vel + noise[:, i]
    y = y + vel
    ys.append(y)
  return torch.stack(ys, 1)


def _terrain_heights(keys: torch.Tensor, hardcore: bool) -> torch.Tensor:
  """Terrain heights ``[N, 200]``: the grass walk, and for hardcore its
  12 obstacle overlays (stump, stairs, pit) applied in order, each from
  the height at its start as the earlier ones left it."""
  if not hardcore:
    return _grass(keys)
  k1, k2 = prng.split(keys, 2).unbind(1)
  ys = _grass(k1)
  kinds = prng.randint(k2, (_N_OBSTACLES,), 1, 4)
  kpos, ksz, kdir = prng.split(prng.fold_in(k2, 1), 3).unbind(1)
  starts = prng.randint(
    kpos, (_N_OBSTACLES,), TERRAIN_STARTPAD + 5, TERRAIN_LENGTH - 20
  ).to(torch.int64)
  sizes = prng.randint(ksz, (_N_OBSTACLES,), 1, 3)
  stair_dir = (prng.randint(kdir, (_N_OBSTACLES,), 0, 2) * 2 - 1).to(torch.float32)
  idx = torch.arange(TERRAIN_LENGTH, device=keys.device)
  for o in range(_N_OBSTACLES):
    kind, start = kinds[:, o:o + 1], starts[:, o:o + 1]
    size = sizes[:, o:o + 1]
    base = torch.gather(ys, 1, start)
    past = idx >= start
    pit_y = base - 4 * TERRAIN_STEP
    stump_y = base + size.to(torch.float32) * TERRAIN_STEP
    stair_s = torch.clamp(torch.div(idx - start, 4, rounding_mode="floor"), 0, 3)
    # XLA-CPU: one fused multiply-add of the step count and the signed rise
    stairs_y = prng.fma32(
      stair_s.to(torch.float32), stair_dir[:, o:o + 1] * TERRAIN_STEP, base
    )
    ys = torch.where(
      kind == 3, torch.where(past & (idx < start + size + 2), pit_y, ys),
      torch.where(
        kind == 1, torch.where(past & (idx < start + size), stump_y, ys),
        torch.where(past & (idx < start + 16), stairs_y, ys),
      ),
    )
  return ys


def _ground_y(terrain: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """Heightfield height at ``x`` (``[N, ...]``) by gathering the two knots
  of ``terrain`` ``[N, 200]`` around it. A NaN ``x`` (a walker whose state
  blew up) gathers knot 0, as XLA converts NaN to the integer 0, and gives
  NaN."""
  f = torch.clamp(x * prng.inv32(TERRAIN_STEP), 0.0, TERRAIN_LENGTH - 1 - 1e-6)
  i = torch.floor(f)
  t = f - i
  i = torch.clamp(i.to(torch.int64), 0, TERRAIN_LENGTH - 2).reshape(x.shape[0], -1)
  y0 = torch.gather(terrain, 1, i).reshape(x.shape)
  y1 = torch.gather(terrain, 1, i + 1).reshape(x.shape)
  return y0 * (1 - t) + y1 * t


def _kinematics(c: Dict[str, torch.Tensor], q: torch.Tensor, qd: torch.Tensor):
  """Positions ``[N, 14, 2]``, Jacobians ``[N, 14, 2, 7]`` and ``Jdot qd``
  ``[N, 14, 2]`` of the point table's points at ``(q, qd)``."""
  a = q[:, 2:]
  cos, sin = torch.cos(a)[:, None, :, None], torch.sin(a)[:, None, :, None]
  rv = cos * c["v"] + sin * c["v_perp"]                 # [N, 14, 5, 2]
  pos = q[:, None, :2] + rv.sum(2)
  # d/da R(a) v = R(a + pi/2) v = (-(R v)_y, (R v)_x)
  d_angle = torch.stack([-rv[..., 1], rv[..., 0]], -1)   # [N, 14, 5, 2]
  jac = torch.cat([
    c["eye"].expand(q.shape[0], 14, 2, 2), d_angle.transpose(2, 3)
  ], 3)
  jdot_qd = -(rv * (qd[:, None, 2:, None] ** 2)).sum(2)
  return pos, jac, jdot_qd


class BipedalWalkerEnv(FuncEnv):
  """BipedalWalker-v3."""

  name = "BipedalWalker"
  hardcore = False

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"reward_threshold": 300.0}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"obs": ArraySpec(np.float32, (24,), -10.0, 10.0)}

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 4), -1.0, 1.0)}

  @classmethod
  def start_state(cls, keys: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The reset's state before its zero-action physics step, and that
    step's keys."""
    n, dev = keys.shape[0], keys.device
    kt, kf, ks = prng.split(keys, 3).unbind(1)
    # lower-leg angles chosen so the knee joints start AT their upper limit
    # (-0.1), as in the JAX package
    q = _constants(dev)["init_q"].expand(n, 7)
    force = prng.uniform(kf, (), -INITIAL_RANDOM, INITIAL_RANDOM)
    qd = torch.zeros(n, 7, dtype=torch.float32, device=dev)
    qd[:, 0] = force * prng.mul32(DT, prng.inv32(float(_MASSES.sum())))
    st = {
      "q": q, "qd": qd, "terrain": _terrain_heights(kt, cls.hardcore),
      "contacts": torch.zeros(n, 4, dtype=torch.float32, device=dev),
      "hull_contact": torch.zeros(n, dtype=torch.bool, device=dev),
      "prev_shaping": torch.zeros(n, dtype=torch.float32, device=dev),
      "first": torch.ones(n, dtype=torch.bool, device=dev),
    }
    return st, ks

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor) -> Tuple[Any, Any, Dict]:
    del state
    st, ks = cls.start_state(keys)
    zero = torch.zeros(keys.shape[0], 4, dtype=torch.float32, device=keys.device)
    st, obs, _, _, _ = cls._physics_step(cfg, st, zero, ks)
    return st, obs, {}

  @classmethod
  def step(cls, cfg, state, action, keys):
    return cls._physics_step(cfg, state, action, keys)

  # ------------------------------------------------------------------- core

  @classmethod
  def _physics_step(cls, cfg, st, action, keys):
    del keys
    with no_tf32(st["q"].device):
      return cls._dynamics(st, action)

  @classmethod
  def _dynamics(cls, st, action):
    q, qd = st["q"], st["qd"]
    n = q.shape[0]
    c = _constants(q.device)
    a = torch.clamp(action.reshape(n, 4), -1.0, 1.0)
    clip_abs = torch.clamp(a.abs(), 0.0, 1.0)
    target = c["motor_speed"] * torch.sign(a)
    max_tau = MOTORS_TORQUE * clip_abs

    terrain = st["terrain"]
    hull_contact = st["hull_contact"]
    leg_contact = torch.zeros(n, 2, dtype=torch.bool, device=q.device)
    sub_dt = DT / _SUBSTEPS
    masses = c["masses"]
    for _ in range(_SUBSTEPS):
      pos, jac, jdot_qd = _kinematics(c, q, qd)
      jac_com = jac[:, :5]
      # M = sum_b m_b J_b^T J_b + the bodies' rotational inertias
      mj = (jac_com * masses[:, None, None]).reshape(n, 10, 7)
      mass = mj.transpose(1, 2) @ jac_com.reshape(n, 10, 7) + c["rot_inertia"]
      grav = GRAVITY * (mj[:, 1::2]).sum(1)
      # Coriolis: Mdot qd - dT/dq = sum_b m_b J_b^T (Jdot_b qd)
      coriolis = (mj * jdot_qd[:, :5].reshape(n, 10, 1)).sum(1)
      # motor generalized torques with speed control
      jvel = qd[:, c["child"]] - qd[:, c["parent"]]
      tau = torch.clamp(30.0 * (target - jvel), -max_tau, max_tau)
      gen = grav - coriolis
      t0, t1, t2, t3 = tau.unbind(1)
      gen = torch.stack([
        gen[:, 0], gen[:, 1], gen[:, 2] - t0 - t2, gen[:, 3] + t0 - t1,
        gen[:, 4] + t1, gen[:, 5] + t2 - t3, gen[:, 6] + t3,
      ], 1)
      qdd = torch.linalg.solve_ex(mass, gen[:, :, None]).result[:, :, 0]
      qd = qd + qdd * sub_dt

      # contact impulses: soles of both lower legs + hull vertices
      m_inv = torch.linalg.inv_ex(mass).inverse
      pts, jpts = pos[:, 5:], jac[:, 5:].reshape(n, 18, 7)     # rows (point, x|y)
      pen = _ground_y(terrain, pts[..., 0]) - pts[..., 1]
      touching = pen > 0.0
      vel = torch.bmm(jpts, qd[:, :, None]).reshape(n, 9, 2)
      w = (torch.bmm(jpts, m_inv) * jpts).sum(2).reshape(n, 9, 2)
      vt, vn = vel.unbind(2)
      wt, wn = w.unbind(2)
      jpts = jpts.reshape(n, 9, 2, 7)
      jn = torch.where(touching & (vn < 0), -vn / (wn + 1e-9), 0.0)
      lim = FRICTION * jn
      jt = torch.clamp(torch.where(touching, -vt / (wt + 1e-9), 0.0), -lim, lim)
      impulse = (jn[..., None] * jpts[:, :, 1]).sum(1) + (jt[..., None] * jpts[:, :, 0]).sum(1)
      qd = qd + (m_inv @ impulse[:, :, None])[:, :, 0]
      # positional correction along y through the heaviest contact
      max_pen = torch.where(touching, pen, 0.0).amax(1)
      q = torch.cat([q[:, :1], q[:, 1:2] + 0.4 * max_pen[:, None], q[:, 2:]], 1)
      q = q + qd * sub_dt

      # joint limits: project angles, zero relative velocity at the stop
      jang = q[:, c["child"]] - q[:, c["parent"]] - c["ref"]
      corr = torch.clamp(jang, c["lo"], c["hi"]) - jang
      q = torch.cat([q[:, :3], q[:, 3:] + corr], 1)
      jvel2 = qd[:, c["child"]] - qd[:, c["parent"]]
      qd = torch.cat([qd[:, :3], qd[:, 3:] + torch.where(corr.abs() > 0.0, -jvel2, 0.0)], 1)

      leg_contact = leg_contact | touching[:, :4].reshape(n, 2, 2).any(2)
      hull_contact = hull_contact | touching[:, 4:].any(1)

    # lidar ray-march over the heightfield (64 samples per ray); the first
    # hit by argmax over the mask as integers
    sample = q[:, None, None, :2] + c["ray"]                   # [N, 10, 64, 2]
    below = sample[..., 1] < _ground_y(terrain, sample[..., 0])
    first_hit = torch.argmax(below.to(torch.uint8), dim=2)
    lidar = torch.where(below.any(2), c["fractions"][first_hit], 1.0)

    jang = q[:, c["child"]] - q[:, c["parent"]] - c["ref"]
    jvel = qd[:, c["child"]] - qd[:, c["parent"]]
    ground = leg_contact.repeat_interleave(2, 1).to(torch.float32)
    obs = torch.cat([
      torch.stack([
        q[:, 2],
        qd[:, 2] * prng.mul32(2.0, prng.inv32(FPS)),
        qd[:, 0] * prng.mul32(prng.mul32(0.3, VIEWPORT_W), prng.inv32(FPS)),
        qd[:, 1] * prng.mul32(prng.mul32(0.3, VIEWPORT_H), prng.inv32(FPS)),
        jang[:, 0], jvel[:, 0] * prng.inv32(SPEED_HIP),
        jang[:, 1] + 1.0, jvel[:, 1] * prng.inv32(SPEED_KNEE),
        ground[:, 1],
        jang[:, 2], jvel[:, 2] * prng.inv32(SPEED_HIP),
        jang[:, 3] + 1.0, jvel[:, 3] * prng.inv32(SPEED_KNEE),
        ground[:, 3],
      ], 1),
      lidar,
    ], 1)

    shaping = q[:, 0] * prng.mul32(130.0, prng.inv32(SCALE)) - 5.0 * obs[:, 0].abs()
    reward = torch.where(st["first"], 0.0, shaping - st["prev_shaping"])
    reward = reward - 0.00035 * MOTORS_TORQUE * clip_abs.sum(1)
    fell = hull_contact | (q[:, 0] < 0)
    reward = torch.where(fell, -100.0, reward)
    success = q[:, 0] > (TERRAIN_LENGTH - TERRAIN_GRASS) * TERRAIN_STEP
    term = fell | success

    new_st = {
      "q": q, "qd": qd, "terrain": terrain,
      "contacts": ground,
      "hull_contact": hull_contact,
      "prev_shaping": shaping,
      "first": torch.zeros_like(st["first"]),
    }
    return new_st, obs, reward, term, {}


class BipedalWalkerHardcoreEnv(BipedalWalkerEnv):
  """BipedalWalkerHardcore-v3."""

  name = "BipedalWalkerHardcore"
  hardcore = True
