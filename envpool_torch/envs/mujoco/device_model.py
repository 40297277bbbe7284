"""The on-device MuJoCo model as data.

The port's copy of ``DeviceModel`` and its extraction
(``envpool_tpu/envs/mujoco/device_engine.py:95-383``). The JAX package
builds the model at run time with ``mujoco`` from gymnasium's XML assets;
the card's machine has neither package. So the constants are extracted once
where both are installed and committed as data, one ``.npz`` per model
under ``models/``, and the port loads them with numpy alone
(``load_model``). ``mujoco`` is imported only inside the extractor, which
serves to regenerate the data and the tests that hold it equal to the JAX
package's extraction::

  python -m envpool_torch.envs.mujoco.device_model --write

The model carries the contact tables of
``envpool_tpu/envs/mujoco/device_collision.py`` (``ContactData``, extracted
by ``extract_contacts``, the port's copy of it), or None where the JAX
package's is None. The port's engine has every family the extractor
writes: the plane-capsule/sphere, capsule-capsule, plane-cylinder,
sphere/capsule-cylinder, plane-box and sphere/capsule-box narrow phase,
joint-limit and limited-tendon rows and free joints. Every gym device model
is written; ``models/refused.json`` lists those the loader refuses, with
the reason (none: ``check_supported`` refuses nothing).

The dm_control replicas (``dmc/assets.py``, the port's copy of the JAX
package's) are written the same way under ``models/dmc/``, one file per
model variant of ``dmc.assets.DMC_XMLS`` (``load_dmc_model``), with their
own refusal list ``models/dmc/refused.json``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

# mjtJoint enum values (mujoco/mjmodel.h)
_JNT_FREE, _JNT_BALL, _JNT_SLIDE, _JNT_HINGE = 0, 1, 2, 3
# mjtGeom enum values (mujoco/mjmodel.h)
_GEOM_PLANE, _GEOM_SPHERE, _GEOM_CAPSULE, _GEOM_CYLINDER = 0, 2, 3, 5
_GEOM_BOX = 6

MODELS_DIR = Path(__file__).resolve().parent / "models"
DMC_MODELS_DIR = MODELS_DIR / "dmc"

# the XML assets of the JAX package's gym device tier
# (``envpool_tpu/envs/mujoco/device_tasks.py``), written by ``--write``
GYM_DEVICE_XMLS = (
  "reacher.xml", "inverted_pendulum.xml", "inverted_double_pendulum.xml",
  "swimmer.xml", "half_cheetah.xml", "hopper.xml", "walker2d.xml",
  "ant.xml", "humanoid.xml", "humanoidstandup.xml", "pusher.xml",
)


class DeviceModel(NamedTuple):
  """Static extraction of an mjModel: python structure + numpy constants."""

  nq: int
  nv: int
  nbody: int
  parent: Tuple[int, ...]              # body -> parent body id
  body_pos: np.ndarray                 # [nbody, 3]
  body_rotm: np.ndarray                # [nbody, 3, 3]
  body_mass: np.ndarray                # [nbody]
  body_ipos: np.ndarray                # [nbody, 3] com offset, body frame
  body_inertia_w: np.ndarray           # [nbody, 3, 3] I_c in body frame
  body_joints: Tuple[Tuple[int, ...], ...]   # per body: joint ids, in order
  body_dofs: Tuple[Tuple[int, ...], ...]     # per body: dof ids, in order
  jnt_type: Tuple[int, ...]
  jnt_axis: np.ndarray                 # [njnt, 3] (body frame)
  jnt_pos: np.ndarray                  # [njnt, 3] (body frame)
  jnt_dof: Tuple[int, ...]             # joint -> first dof index
  jnt_qadr: Tuple[int, ...]            # joint -> first qpos index
  jnt_limited: Tuple[bool, ...]
  jnt_range: np.ndarray                # [njnt, 2]
  jnt_margin: np.ndarray               # [njnt]
  jnt_solref: np.ndarray               # [njnt, 2] (timeconst, dampratio)
  jnt_solimp: np.ndarray               # [njnt, 5] (d0, dmax, width, mid, pow)
  jnt_stiffness: np.ndarray            # [njnt]
  qpos_spring: np.ndarray              # [nq]
  dof_body: Tuple[int, ...]            # dof -> body id
  dof_damping: np.ndarray              # [nv]
  dof_armature: np.ndarray             # [nv]
  ancestor: Tuple[Tuple[bool, ...], ...]  # [nbody][nbody] a is ancestor-or-self
  # actuators (motor/general with fixed gain, joint transmission)
  act_dof: Tuple[int, ...]             # joint-transmission dof (-1: tendon)
  act_trn: np.ndarray                  # [nu, nv] constant actuator moment
  act_gear: np.ndarray                 # [nu]
  ctrl_range: np.ndarray               # [nu, 2]
  force_range: np.ndarray              # [nu, 2] (+-inf when unlimited)
  timestep: float
  integrator: int                      # 0=Euler (implicit damping), 1=RK4
  gravity: np.ndarray                  # [3]
  # fluid model (mj_passive inertia-box model): per-body equivalent
  # inertia box dims, inertia-frame rotation, and the medium constants
  density: float
  viscosity: float
  wind: np.ndarray                     # [3]
  body_ibox: np.ndarray                # [nbody, 3]
  body_irotm: np.ndarray               # [nbody, 3, 3] body->inertia frame
  init_qpos: np.ndarray                # [nq] (qpos0)
  body_name2id: Dict[Optional[str], int]
  site_body: Tuple[int, ...]
  site_pos: np.ndarray                 # [nsite, 3] (body frame)
  site_name2id: Dict[Optional[str], int]
  site_size: np.ndarray                # [nsite, 3]
  site_type: Tuple[int, ...]           # mjtGeom (touch-sensor zones)
  geom_body: Tuple[int, ...]
  geom_pos: np.ndarray                 # [ngeom, 3] (body frame)
  geom_rotm: np.ndarray                # [ngeom, 3, 3] (body frame)
  geom_size: np.ndarray                # [ngeom, 3]
  geom_name2id: Dict[Optional[str], int]
  dof_invweight0: np.ndarray           # [nv] (diag-approx for limit rows)
  # contact tables (ContactData) or None when the model has no admissible
  # geom pairs and no limited tendons
  contacts: Any


_NAME_FIELDS = ("body_name2id", "site_name2id", "geom_name2id")


def _quat2rotm(q: np.ndarray) -> np.ndarray:
  w, x, y, z = q
  return np.array([
    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ])


def _inertia_boxes(m) -> np.ndarray:
  """Equivalent inertia-box dims per body (mj_inertiaBoxFluidModel):
  box_i = sqrt(6 (I_j + I_k - I_i) / (2 m)) i.e. inverting the solid-box
  inertia I_i = m/12 (d_j^2 + d_k^2)."""
  out = np.zeros((m.nbody, 3))
  for b in range(m.nbody):
    mass = float(m.body_mass[b])
    if mass <= 0:
      continue
    ii = np.asarray(m.body_inertia[b], dtype=np.float64)
    for i in range(3):
      j, k = (i + 1) % 3, (i + 2) % 3
      out[b, i] = np.sqrt(max(1e-15, ii[j] + ii[k] - ii[i]) / mass * 6.0)
  return out


class ContactData(NamedTuple):
  """Static (numpy) candidate-contact tables for one model."""

  # geom tables
  geom_body: np.ndarray        # [ngeom] int
  geom_size: np.ndarray        # [ngeom, 3]
  geom_pos: np.ndarray         # [ngeom, 3] (body frame)
  geom_rotm: np.ndarray        # [ngeom, 3, 3] (body frame)
  # plane-capsule pairs (plane first); spheres are capsules with hl=0,
  # contributing ONE candidate point instead of two
  pc_plane: Tuple[int, ...]    # [n_pc] plane geom id
  pc_cap: Tuple[int, ...]      # [n_pc] capsule/sphere geom id
  pc_two: Tuple[bool, ...]     # [n_pc] True -> 2 endpoint candidates
  # capsule-capsule (incl. sphere) pairs: one candidate point each
  cc_g1: Tuple[int, ...]       # [n_cc]
  cc_g2: Tuple[int, ...]       # [n_cc]
  # plane-cylinder pairs: FOUR candidate points each (deepest rim,
  # +-120deg face rims gated on tilt<45deg, far side-line endpoint)
  pcy_plane: Tuple[int, ...]   # [n_pcy]
  pcy_cyl: Tuple[int, ...]     # [n_pcy]
  # capsule/sphere-cylinder pairs (capsule first, mj type order): one
  # analytic closest-point candidate each
  cyc_cap: Tuple[int, ...]     # [n_cyc]
  cyc_cyl: Tuple[int, ...]     # [n_cyc]
  # plane-box pairs: EIGHT corner candidates each (mjc_PlaneBox emits
  # the below-margin corners in the same enumeration order)
  pb_plane: Tuple[int, ...]    # [n_pb]
  pb_box: Tuple[int, ...]      # [n_pb]
  # sphere/capsule-box pairs (sphere/capsule first, mj type order):
  # spheres contribute ONE closest-point candidate; capsules THREE
  # (one per endpoint sphere + one golden-section mid-segment point)
  sb_cap: Tuple[int, ...]      # [n_sb]
  sb_box: Tuple[int, ...]      # [n_sb]
  sb_three: Tuple[bool, ...]   # [n_sb] True -> capsule (3 candidates)
  # per candidate-point constants, aligned with the concatenation
  # [pc endpoints (1 or 2 per pair), cc points, pcy (4 per pair), cyc]
  point_b1: np.ndarray         # [P] int body of geom1
  point_b2: np.ndarray         # [P] int body of geom2
  point_g1: np.ndarray         # [P] int geom1 id
  point_g2: np.ndarray         # [P] int geom2 id
  point_sgn: np.ndarray        # [P, nv] +-1/0: dof influence on b2 - b1
  point_K: np.ndarray          # [P]
  point_B: np.ndarray          # [P]
  point_solimp: np.ndarray     # [P, 5]
  point_incmargin: np.ndarray  # [P] includemargin = margin - gap
  point_diagA: np.ndarray      # [P] position-independent diag approx
  point_mu: np.ndarray         # [P, 2] tangential friction
  point_condim: np.ndarray     # [P] 1 or 3
  # joint-limit rows
  lim_dof: Tuple[int, ...]     # [L] dof index (velocity/M space)
  lim_qadr: Tuple[int, ...]    # [L] qpos index
  lim_lo: np.ndarray           # [L]
  lim_hi: np.ndarray           # [L]
  lim_margin: np.ndarray       # [L]
  lim_K: np.ndarray            # [L]
  lim_B: np.ndarray            # [L]
  lim_solimp: np.ndarray       # [L, 5]
  lim_diagA: np.ndarray        # [L] dof_invweight0
  # limited spatial tendon rows (2-site tendons, e.g. ball_in_cup's
  # string): one row per tendon, nearer-limit side selected at runtime
  # like joint limits. efc order: after joint limits, before contacts.
  ten_site_body: np.ndarray    # [T, 2] body id per endpoint site
  ten_site_pos: np.ndarray     # [T, 2, 3] site offset in body frame
  ten_lo: np.ndarray           # [T]
  ten_hi: np.ndarray           # [T]
  ten_margin: np.ndarray       # [T]
  ten_K: np.ndarray            # [T]
  ten_B: np.ndarray            # [T]
  ten_solimp: np.ndarray       # [T, 5]
  ten_diagA: np.ndarray        # [T] tendon_invweight0
  ten_anc: np.ndarray          # [T, 2, nv] dof influences each endpoint
  nrows: int                   # total constraint rows
  # Newton solve depth: fitted per problem size — 6/6 converges the
  # planar models (nv<=9) to mj's optimum; wide free-root problems
  # (ant: nv=14, ~100 rows) need 8/8 (verified to 1e-15 over random
  # deep-penetration states in tests)
  newton_iters: int
  newton_ls: int


def _mix(a1, a2, w1, w2):
  """solmix-weighted combination of solref/solimp (equal priority)."""
  s = w1 + w2
  if s < 1e-12:
    w1 = w2 = 0.5
  else:
    w1, w2 = w1 / s, w2 / s
  return w1 * np.asarray(a1, np.float64) + w2 * np.asarray(a2, np.float64)


def extract_contacts(m) -> ContactData:
  """Candidate-pair tables from an mjModel (MuJoCo's collision filters).

  Pair admission mirrors ``mj_collision``: contype/conaffinity bitmasks,
  same-body exclusion, and the parent-child filter (skipped when the
  parent is the world body). Geom pairs are enumerated exhaustively at
  build time — there is no runtime broadphase; inactive candidates cost
  one masked row block each.
  """
  if int(m.opt.cone) != 0:
    raise NotImplementedError("device engine supports pyramidal cones only")
  if m.npair:
    raise NotImplementedError("explicit <pair> contacts unsupported")
  # <exclude> body pairs (mj_collision's signature filter): packed as
  # (body1 << 16) + body2 in exclude_signature
  excluded = set()
  for e in range(m.nexclude):
    sig = int(m.exclude_signature[e])
    ba, bb = sig >> 16, sig & 0xFFFF
    excluded.add((min(ba, bb), max(ba, bb)))

  nv = int(m.nv)
  timestep = float(m.opt.timestep)
  gb = np.asarray(m.geom_bodyid, dtype=np.int64)

  # dof -> body, ancestor table (dof's body is ancestor-or-self of b)
  dof_body = np.asarray(m.dof_bodyid, dtype=np.int64)
  anc = np.zeros((m.nbody, m.nbody), dtype=bool)
  for b in range(m.nbody):
    a = b
    while True:
      anc[a][b] = True
      if a == 0:
        break
      a = int(m.body_parentid[a])

  pairs = []
  for g1 in range(m.ngeom):
    for g2 in range(g1 + 1, m.ngeom):
      b1, b2 = int(gb[g1]), int(gb[g2])
      if b1 == b2:
        continue
      if (min(b1, b2), max(b1, b2)) in excluded:
        continue
      # parent-child filter (mj default filterparent; world parent exempt)
      if (int(m.body_parentid[b2]) == b1 and b1 != 0) or (
        int(m.body_parentid[b1]) == b2 and b2 != 0
      ):
        continue
      t1, t2 = int(m.geom_contype[g1]), int(m.geom_contype[g2])
      a1, a2 = int(m.geom_conaffinity[g1]), int(m.geom_conaffinity[g2])
      if not ((t1 & a2) or (t2 & a1)):
        continue
      k1, k2 = int(m.geom_type[g1]), int(m.geom_type[g2])
      for k in (k1, k2):
        if k not in (
          _GEOM_PLANE, _GEOM_SPHERE, _GEOM_CAPSULE, _GEOM_CYLINDER,
          _GEOM_BOX,
        ):
          raise NotImplementedError(
            f"geom type {k} unsupported by the device contact engine"
          )
      if k1 == _GEOM_PLANE and k2 == _GEOM_PLANE:
        continue
      if k1 == _GEOM_CYLINDER and k2 == _GEOM_CYLINDER:
        raise NotImplementedError("cylinder-cylinder contacts unsupported")
      if _GEOM_BOX in (k1, k2) and (
        min(k1, k2) == _GEOM_CYLINDER or k1 == k2
      ):
        raise NotImplementedError("cylinder-box/box-box unsupported")
      # order by geom type (mj_collideGeoms' type-sorted collision
      # table: plane first, sphere/capsule before cylinder; contact
      # normal then points geom1 -> geom2). Fresh names: rebinding the
      # loop variables here would corrupt later iterations.
      if k1 > k2:
        pairs.append((g2, g1, k2, k1))
      else:
        pairs.append((g1, g2, k1, k2))

  def _combine(g1, g2):
    """MuJoCo contact-parameter mixing for equal geom priority."""
    if int(m.geom_priority[g1]) != int(m.geom_priority[g2]):
      hi = g1 if m.geom_priority[g1] > m.geom_priority[g2] else g2
      fric = np.asarray(m.geom_friction[hi], np.float64)
      solref = np.asarray(m.geom_solref[hi], np.float64)
      solimp = np.asarray(m.geom_solimp[hi], np.float64)
      condim = int(m.geom_condim[hi])
    else:
      fric = np.maximum(m.geom_friction[g1], m.geom_friction[g2])
      w1 = float(m.geom_solmix[g1])
      w2 = float(m.geom_solmix[g2])
      solref = _mix(m.geom_solref[g1], m.geom_solref[g2], w1, w2)
      # negative (direct) solref entries use min, but gym models are std
      if m.geom_solref[g1][0] <= 0 or m.geom_solref[g2][0] <= 0:
        solref = np.minimum(m.geom_solref[g1], m.geom_solref[g2])
      solimp = _mix(m.geom_solimp[g1], m.geom_solimp[g2], w1, w2)
      condim = max(int(m.geom_condim[g1]), int(m.geom_condim[g2]))
    # margins/gaps ADD (each geom's margin expands its own surface):
    # mj_collideGeoms uses margin = margin1 + margin2, gap likewise
    incmargin = (
      float(m.geom_margin[g1]) + float(m.geom_margin[g2])
    ) - (float(m.geom_gap[g1]) + float(m.geom_gap[g2]))
    if condim not in (1, 3):
      raise NotImplementedError("device contacts support condim 1/3 only")
    return fric, solref, solimp, condim, incmargin

  def _kb(solref, solimp):
    tc, dr = float(solref[0]), float(solref[1])
    tc = max(tc, 2.0 * timestep)  # MuJoCo clamps timeconst at 2*timestep
    dmax = float(solimp[1])
    return (
      1.0 / max(1e-15, dmax * dmax * tc * tc * dr * dr),
      2.0 / max(1e-15, dmax * tc),
    )

  pc_plane, pc_cap, pc_two = [], [], []
  cc_g1, cc_g2 = [], []
  pcy_plane, pcy_cyl = [], []
  cyc_cap, cyc_cyl = [], []
  pb_plane, pb_box = [], []
  sb_cap, sb_box, sb_three = [], [], []
  pt = {k: [] for k in (
    "b1", "b2", "g1", "g2", "K", "B", "solimp", "inc", "diagA", "mu",
    "condim",
  )}
  iw = np.asarray(m.body_invweight0, np.float64)

  def _add_points(g1, g2, n_pts):
    fric, solref, solimp, condim, inc = _combine(g1, g2)
    K, B = _kb(solref, solimp)
    b1, b2 = int(gb[g1]), int(gb[g2])
    base = float(iw[b1, 0] + iw[b2, 0])
    mu = float(fric[0])
    if condim == 3:
      diag_a = 2.0 * mu * mu * (1.0 + mu * mu) * base
    else:
      diag_a = base
    for _ in range(n_pts):
      pt["b1"].append(b1)
      pt["b2"].append(b2)
      pt["g1"].append(g1)
      pt["g2"].append(g2)
      pt["K"].append(K)
      pt["B"].append(B)
      pt["solimp"].append(np.asarray(solimp, np.float64))
      pt["inc"].append(inc)
      pt["diagA"].append(diag_a)
      # condim-3 tangents BOTH use the sliding friction fric[0]
      # (fric[1] is torsional, condim>=4 only): mjContact.friction[:2]
      pt["mu"].append([float(fric[0]), float(fric[0])])
      pt["condim"].append(condim)

  for g1, g2, k1, k2 in pairs:
    if k2 == _GEOM_BOX and k1 == _GEOM_PLANE:
      pb_plane.append(g1)
      pb_box.append(g2)
    elif k2 == _GEOM_BOX:  # sphere/capsule (type-sorted first) vs box
      sb_cap.append(g1)
      sb_box.append(g2)
      sb_three.append(k1 == _GEOM_CAPSULE)
    elif k1 == _GEOM_PLANE and k2 == _GEOM_CYLINDER:
      pcy_plane.append(g1)
      pcy_cyl.append(g2)
    elif k1 == _GEOM_PLANE:
      pc_plane.append(g1)
      pc_cap.append(g2)
      pc_two.append(k2 == _GEOM_CAPSULE)
    elif k2 == _GEOM_CYLINDER:  # sphere/capsule (type-sorted first) vs cyl
      cyc_cap.append(g1)
      cyc_cyl.append(g2)
    else:  # sphere/capsule vs sphere/capsule: one candidate point
      cc_g1.append(g1)
      cc_g2.append(g2)

  # the per-point constant table MUST follow contact_points' family
  # segment order [pc, cc, pcy, cyc, pb, sb], not pair-enumeration
  # order — models mixing families interleave them in `pairs`
  for i, (gp, gc) in enumerate(zip(pc_plane, pc_cap)):
    _add_points(gp, gc, 2 if pc_two[i] else 1)
  for g1, g2 in zip(cc_g1, cc_g2):
    _add_points(g1, g2, 1)
  for gp, gc in zip(pcy_plane, pcy_cyl):
    _add_points(gp, gc, 4)
  for g1, g2 in zip(cyc_cap, cyc_cyl):
    _add_points(g1, g2, 1)
  for gp, gx in zip(pb_plane, pb_box):
    _add_points(gp, gx, 8)
  for i, (g1, g2) in enumerate(zip(sb_cap, sb_box)):
    _add_points(g1, g2, 3 if sb_three[i] else 1)

  n_pts = len(pt["b1"])
  sgn = np.zeros((n_pts, nv))
  for p in range(n_pts):
    for d in range(nv):
      db = dof_body[d]
      sgn[p, d] = float(anc[db][pt["b2"][p]]) - float(anc[db][pt["b1"][p]])

  # joint limits (1-dof hinge/slide; free joints are never limited)
  lim_dof, lim_qadr, lim_lo, lim_hi, lim_margin = [], [], [], [], []
  lim_K, lim_B, lim_solimp, lim_diag = [], [], [], []
  dof_iw = np.asarray(m.dof_invweight0, np.float64)
  for j in range(m.njnt):
    if not m.jnt_limited[j]:
      continue
    d = int(m.jnt_dofadr[j])
    K, B = _kb(m.jnt_solref[j], m.jnt_solimp[j])
    lim_dof.append(d)
    lim_qadr.append(int(m.jnt_qposadr[j]))
    lim_lo.append(float(m.jnt_range[j, 0]))
    lim_hi.append(float(m.jnt_range[j, 1]))
    lim_margin.append(float(m.jnt_margin[j]))
    lim_K.append(K)
    lim_B.append(B)
    lim_solimp.append(np.asarray(m.jnt_solimp[j], np.float64))
    lim_diag.append(float(dof_iw[d]))

  # limited 2-site spatial tendons (e.g. ball_in_cup's string): one
  # nearest-side limit row each, efc-ordered after joint limits
  _WRAP_SITE = 3  # mjtWrap
  ten_body, ten_spos, ten_lo, ten_hi, ten_mar = [], [], [], [], []
  ten_K, ten_B, ten_imp, ten_diag, ten_anc = [], [], [], [], []
  for t in range(m.ntendon):
    if not bool(m.tendon_limited[t]):
      continue
    adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
    wtypes = [int(m.wrap_type[adr + i]) for i in range(num)]
    if num != 2 or any(w != _WRAP_SITE for w in wtypes):
      raise NotImplementedError(
        "only 2-site spatial tendon limits supported"
      )
    sites = [int(m.wrap_objid[adr + i]) for i in range(num)]
    bodies = [int(m.site_bodyid[s]) for s in sites]
    K, B = _kb(m.tendon_solref_lim[t], m.tendon_solimp_lim[t])
    ten_body.append(bodies)
    ten_spos.append([np.asarray(m.site_pos[s], np.float64) for s in sites])
    ten_lo.append(float(m.tendon_range[t, 0]))
    ten_hi.append(float(m.tendon_range[t, 1]))
    ten_mar.append(float(m.tendon_margin[t]))
    ten_K.append(K)
    ten_B.append(B)
    ten_imp.append(np.asarray(m.tendon_solimp_lim[t], np.float64))
    ten_diag.append(float(m.tendon_invweight0[t]))
    ten_anc.append([
      [float(anc[dof_body[d]][b]) for d in range(nv)] for b in bodies
    ])
  n_ten = len(ten_body)

  rows = len(lim_dof) + n_ten
  for c in pt["condim"]:
    rows += 2 * (c - 1) if c > 1 else 1
  deep = nv > 9 or rows > 70
  # humanoid-scale problems (nv ~27, ~350 rows) leave 8-iteration
  # solves ~0.3 in qvel from mj's optimum at contact-transition
  # substeps (warm start far from the new active set); 16/12 restores
  # ~1e-12 per-substep parity (measured, dm humanoid substep 2)
  wide = nv > 20 or rows > 200

  return ContactData(
    geom_body=gb,
    geom_size=np.asarray(m.geom_size, np.float64),
    geom_pos=np.asarray(m.geom_pos, np.float64),
    geom_rotm=np.stack([
      _quat2rotm(np.asarray(m.geom_quat[g], np.float64))
      for g in range(m.ngeom)
    ]) if m.ngeom else np.zeros((0, 3, 3)),
    pc_plane=tuple(pc_plane),
    pc_cap=tuple(pc_cap),
    pc_two=tuple(pc_two),
    cc_g1=tuple(cc_g1),
    cc_g2=tuple(cc_g2),
    pcy_plane=tuple(pcy_plane),
    pcy_cyl=tuple(pcy_cyl),
    cyc_cap=tuple(cyc_cap),
    cyc_cyl=tuple(cyc_cyl),
    pb_plane=tuple(pb_plane),
    pb_box=tuple(pb_box),
    sb_cap=tuple(sb_cap),
    sb_box=tuple(sb_box),
    sb_three=tuple(sb_three),
    point_b1=np.asarray(pt["b1"], np.int64),
    point_b2=np.asarray(pt["b2"], np.int64),
    point_g1=np.asarray(pt["g1"], np.int64),
    point_g2=np.asarray(pt["g2"], np.int64),
    point_sgn=sgn,
    point_K=np.asarray(pt["K"], np.float64),
    point_B=np.asarray(pt["B"], np.float64),
    point_solimp=(
      np.stack(pt["solimp"]) if n_pts else np.zeros((0, 5))
    ),
    point_incmargin=np.asarray(pt["inc"], np.float64),
    point_diagA=np.asarray(pt["diagA"], np.float64),
    point_mu=np.asarray(pt["mu"], np.float64).reshape(n_pts, 2),
    point_condim=np.asarray(pt["condim"], np.int64),
    lim_dof=tuple(lim_dof),
    lim_qadr=tuple(lim_qadr),
    lim_lo=np.asarray(lim_lo, np.float64),
    lim_hi=np.asarray(lim_hi, np.float64),
    lim_margin=np.asarray(lim_margin, np.float64),
    lim_K=np.asarray(lim_K, np.float64),
    lim_B=np.asarray(lim_B, np.float64),
    lim_solimp=(
      np.stack(lim_solimp) if lim_dof else np.zeros((0, 5))
    ),
    lim_diagA=np.asarray(lim_diag, np.float64),
    ten_site_body=(
      np.asarray(ten_body, np.int64) if n_ten else np.zeros((0, 2), np.int64)
    ),
    ten_site_pos=(
      np.asarray(ten_spos, np.float64) if n_ten else np.zeros((0, 2, 3))
    ),
    ten_lo=np.asarray(ten_lo, np.float64),
    ten_hi=np.asarray(ten_hi, np.float64),
    ten_margin=np.asarray(ten_mar, np.float64),
    ten_K=np.asarray(ten_K, np.float64),
    ten_B=np.asarray(ten_B, np.float64),
    ten_solimp=(
      np.stack(ten_imp) if n_ten else np.zeros((0, 5))
    ),
    ten_diagA=np.asarray(ten_diag, np.float64),
    ten_anc=(
      np.asarray(ten_anc, np.float64) if n_ten
      else np.zeros((0, 2, nv))
    ),
    nrows=rows,
    newton_iters=16 if wide else (8 if deep else 6),
    newton_ls=12 if wide else (8 if deep else 6),
  )


def extract_model(xml_path: str) -> DeviceModel:
  """Pull the constants the engine needs out of a host-side mjModel."""
  import mujoco
  return _extract_model(mujoco.MjModel.from_xml_path(xml_path))


def extract_model_string(xml: str) -> DeviceModel:
  """Like :func:`extract_model` but from an MJCF string (the dmc
  replicas)."""
  import mujoco
  return _extract_model(mujoco.MjModel.from_xml_string(xml))


def _extract_model(m) -> DeviceModel:
  import mujoco

  for j in range(m.njnt):
    if m.jnt_type[j] not in (_JNT_SLIDE, _JNT_HINGE, _JNT_FREE):
      raise NotImplementedError(
        "device engine supports free/hinge/slide joints only"
      )
    if m.jnt_type[j] == _JNT_FREE:
      b = int(m.jnt_bodyid[j])
      if int(m.body_jntnum[b]) != 1:
        raise NotImplementedError("free joint must be its body's only joint")
      if float(m.jnt_stiffness[j]) != 0.0:
        raise NotImplementedError("springs on free joints not supported")
  for t in range(m.ntendon):
    if (
      float(m.tendon_stiffness[t]) != 0.0
      or float(m.tendon_damping[t]) != 0.0
      or float(m.tendon_frictionloss[t]) != 0.0
    ):
      raise NotImplementedError("tendon stiffness/damping not supported")
  if m.neq:
    raise NotImplementedError("equality constraints not supported")
  if np.any(np.asarray(m.dof_frictionloss) != 0.0):
    raise NotImplementedError("dof frictionloss not supported")

  body_joints: List[Tuple[int, ...]] = []
  body_dofs: List[Tuple[int, ...]] = []
  for b in range(m.nbody):
    adr, num = int(m.body_jntadr[b]), int(m.body_jntnum[b])
    body_joints.append(tuple(range(adr, adr + num)) if num else ())
    dofs: List[int] = []
    for j in body_joints[-1]:
      nd = 6 if m.jnt_type[j] == _JNT_FREE else 1
      dofs.extend(range(int(m.jnt_dofadr[j]), int(m.jnt_dofadr[j]) + nd))
    body_dofs.append(tuple(dofs))

  # I_c rotated into the body frame: R_i diag(inertia) R_i^T
  inertia_w = np.zeros((m.nbody, 3, 3))
  for b in range(m.nbody):
    ri = _quat2rotm(np.asarray(m.body_iquat[b], dtype=np.float64))
    inertia_w[b] = ri @ np.diag(m.body_inertia[b]) @ ri.T

  ancestor = np.zeros((m.nbody, m.nbody), dtype=bool)
  for b in range(m.nbody):
    a = b
    while True:
      ancestor[a][b] = True
      if a == 0:
        break
      a = int(m.body_parentid[a])

  act_dof: List[int] = []
  act_trn = np.zeros((m.nu, m.nv))
  _TRN_JOINT, _TRN_TENDON = 0, 3  # mjtTrn
  _WRAP_JOINT = 1                 # mjtWrap
  for u in range(m.nu):
    # joint transmission, or a fixed tendon: the actuator moment is a
    # constant row over dofs, so tau = act_trn.T @ clamped_force
    trn = int(m.actuator_trntype[u])
    if trn == _TRN_JOINT:
      jid = int(m.actuator_trnid[u, 0])
      d = int(m.jnt_dofadr[jid])
      act_dof.append(d)
      act_trn[u, d] = 1.0
    elif trn == _TRN_TENDON:
      t = int(m.actuator_trnid[u, 0])
      adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
      if any(int(m.wrap_type[adr + i]) != _WRAP_JOINT for i in range(num)):
        raise NotImplementedError(
          "tendon actuators supported on FIXED tendons only"
        )
      for i in range(num):
        jid = int(m.wrap_objid[adr + i])
        act_trn[u, int(m.jnt_dofadr[jid])] = float(m.wrap_prm[adr + i])
      act_dof.append(-1)  # no single dof; consumers use act_trn
    else:
      raise NotImplementedError("only joint/fixed-tendon actuators")

  fr = np.asarray(m.actuator_forcerange, dtype=np.float64).reshape(m.nu, 2)
  flim = np.asarray(m.actuator_forcelimited, dtype=bool).reshape(m.nu)
  fr = np.where(
    flim[:, None], fr,
    np.array([-np.inf, np.inf])[None, :].repeat(m.nu, 0),
  )
  cr = np.asarray(m.actuator_ctrlrange, dtype=np.float64).reshape(m.nu, 2)
  clim = np.asarray(m.actuator_ctrllimited, dtype=bool).reshape(m.nu)
  cr = np.where(
    clim[:, None], cr,
    np.array([-np.inf, np.inf])[None, :].repeat(m.nu, 0),
  )

  def names(obj, count):
    return {mujoco.mj_id2name(m, obj, i): i for i in range(count)}

  contacts = extract_contacts(m)
  if contacts.point_b1.shape[0] == 0 and contacts.ten_site_body.shape[0] == 0:
    contacts = None  # limit-only models use the closed-form solve path

  return DeviceModel(
    nq=int(m.nq), nv=int(m.nv), nbody=int(m.nbody),
    parent=tuple(int(p) for p in m.body_parentid),
    body_pos=np.asarray(m.body_pos, dtype=np.float64),
    body_rotm=np.stack([
      _quat2rotm(np.asarray(m.body_quat[b], dtype=np.float64))
      for b in range(m.nbody)
    ]),
    body_mass=np.asarray(m.body_mass, dtype=np.float64),
    body_ipos=np.asarray(m.body_ipos, dtype=np.float64),
    body_inertia_w=inertia_w,
    body_joints=tuple(body_joints),
    body_dofs=tuple(body_dofs),
    jnt_type=tuple(int(t) for t in m.jnt_type),
    jnt_axis=np.asarray(m.jnt_axis, dtype=np.float64),
    jnt_pos=np.asarray(m.jnt_pos, dtype=np.float64),
    jnt_dof=tuple(int(d) for d in m.jnt_dofadr),
    jnt_qadr=tuple(int(a) for a in m.jnt_qposadr),
    jnt_limited=tuple(bool(x) for x in m.jnt_limited),
    jnt_range=np.asarray(m.jnt_range, dtype=np.float64).reshape(m.njnt, 2),
    jnt_margin=np.asarray(m.jnt_margin, dtype=np.float64),
    jnt_solref=np.asarray(m.jnt_solref, dtype=np.float64).reshape(m.njnt, 2),
    jnt_solimp=np.asarray(m.jnt_solimp, dtype=np.float64).reshape(m.njnt, 5),
    jnt_stiffness=np.asarray(m.jnt_stiffness, dtype=np.float64),
    qpos_spring=np.asarray(m.qpos_spring, dtype=np.float64),
    dof_body=tuple(int(b) for b in m.dof_bodyid),
    dof_damping=np.asarray(m.dof_damping, dtype=np.float64),
    dof_armature=np.asarray(m.dof_armature, dtype=np.float64),
    ancestor=tuple(tuple(bool(x) for x in row) for row in ancestor),
    act_dof=tuple(act_dof),
    act_trn=act_trn,
    act_gear=np.asarray(m.actuator_gear[:, 0], dtype=np.float64),
    ctrl_range=cr,
    force_range=fr,
    timestep=float(m.opt.timestep),
    integrator=int(m.opt.integrator),
    gravity=np.asarray(m.opt.gravity, dtype=np.float64),
    density=float(m.opt.density),
    viscosity=float(m.opt.viscosity),
    wind=np.asarray(m.opt.wind, dtype=np.float64),
    body_ibox=_inertia_boxes(m),
    body_irotm=np.stack([
      _quat2rotm(np.asarray(m.body_iquat[b], dtype=np.float64))
      for b in range(m.nbody)
    ]),
    init_qpos=np.array(m.qpos0, dtype=np.float64, copy=True),
    body_name2id=names(mujoco.mjtObj.mjOBJ_BODY, m.nbody),
    site_body=tuple(int(b) for b in m.site_bodyid),
    site_pos=np.asarray(m.site_pos, dtype=np.float64),
    site_name2id=names(mujoco.mjtObj.mjOBJ_SITE, m.nsite),
    site_size=np.asarray(m.site_size, dtype=np.float64),
    site_type=tuple(int(t) for t in m.site_type),
    geom_body=tuple(int(b) for b in m.geom_bodyid),
    geom_pos=np.asarray(m.geom_pos, dtype=np.float64),
    geom_rotm=np.stack([
      _quat2rotm(np.asarray(m.geom_quat[g], dtype=np.float64))
      for g in range(m.ngeom)
    ]) if m.ngeom else np.zeros((0, 3, 3)),
    geom_size=np.asarray(m.geom_size, dtype=np.float64),
    geom_name2id=names(mujoco.mjtObj.mjOBJ_GEOM, m.ngeom),
    dof_invweight0=np.asarray(m.dof_invweight0, dtype=np.float64),
    contacts=contacts,
  )


def check_supported(mdl: DeviceModel) -> None:
  """Refuse what the port's engine does not have. It has every contact
  family ``extract_contacts`` writes, as the JAX engine does (the extractor
  refuses the rest: mesh geoms, elliptic cones, condim 4 and 6, explicit
  pairs), so no model is refused and ``refused.json`` is empty."""
  del mdl


# ------------------------------------------------------------ data files


def _to_json(value: Any) -> Any:
  if isinstance(value, tuple):
    return [_to_json(v) for v in value]
  return value


_CONTACT_PREFIX = "contacts."


def save_model(mdl: DeviceModel, path: Path) -> None:
  """One ``.npz``: the array fields (the contact tables' under
  ``contacts.<field>``), and the rest as a JSON string (name tables as
  ``[name, id]`` pairs, since a name may be None; the contact tables'
  tuples and integers as an object)."""
  meta, arrays = {}, {}
  for name, value in mdl._asdict().items():
    if isinstance(value, np.ndarray):
      arrays[name] = value
    elif name in _NAME_FIELDS:
      meta[name] = [[k, v] for k, v in value.items()]
    elif name == "contacts" and value is not None:
      meta[name] = {}
      for field, x in value._asdict().items():
        if isinstance(x, np.ndarray):
          arrays[_CONTACT_PREFIX + field] = x
        else:
          meta[name][field] = _to_json(x)
    else:
      meta[name] = _to_json(value)
  with open(path, "wb") as f:
    np.savez_compressed(f, meta=np.array(json.dumps(meta)), **arrays)


def _from_json(name: str, value: Any) -> Any:
  if name in _NAME_FIELDS:
    return {k: v for k, v in value}
  if isinstance(value, list):
    return tuple(tuple(v) if isinstance(v, list) else v for v in value)
  return value


def read_model(path: Path) -> DeviceModel:
  """A model written by ``save_model`` (numpy only)."""
  with np.load(path, allow_pickle=False) as data:
    meta = json.loads(str(data["meta"]))
    contacts = meta.pop("contacts")
    fields = {k: _from_json(k, v) for k, v in meta.items()}
    arrays = {k: np.array(data[k]) for k in data.files if k != "meta"}
  fields.update({k: v for k, v in arrays.items()
                 if not k.startswith(_CONTACT_PREFIX)})
  if contacts is not None:
    contacts = {k: _from_json(k, v) for k, v in contacts.items()}
    contacts.update({k[len(_CONTACT_PREFIX):]: v for k, v in arrays.items()
                     if k.startswith(_CONTACT_PREFIX)})
    contacts = ContactData(**contacts)
  return DeviceModel(contacts=contacts, **fields)


def refused_models(models_dir: Path = MODELS_DIR) -> Dict[str, str]:
  """Models the writer refused: name -> reason (the gym device models by
  xml name; with ``DMC_MODELS_DIR``, the dmc variants by name)."""
  with open(models_dir / "refused.json") as f:
    return json.load(f)


@functools.lru_cache(maxsize=16)
def load_model(xml_name: str) -> DeviceModel:
  """The committed model of a gym asset, e.g. ``"reacher.xml"``."""
  reason = refused_models().get(xml_name)
  if reason is not None:
    raise NotImplementedError(reason)
  mdl = read_model(MODELS_DIR / (Path(xml_name).stem + ".npz"))
  check_supported(mdl)
  return mdl


@functools.lru_cache(maxsize=32)
def load_dmc_model(name: str) -> DeviceModel:
  """The committed model of a dm_control variant of
  ``dmc.assets.DMC_XMLS``, e.g. ``"cartpole_three_poles"``."""
  reason = refused_models(DMC_MODELS_DIR).get(name)
  if reason is not None:
    raise NotImplementedError(reason)
  mdl = read_model(DMC_MODELS_DIR / f"{name}.npz")
  check_supported(mdl)
  return mdl


def gym_asset(xml_name: str) -> str:
  """Path of a gymnasium MuJoCo asset (where gymnasium is installed)."""
  import gymnasium
  return os.path.join(
    os.path.dirname(gymnasium.__file__), "envs", "mujoco", "assets", xml_name
  )


def _write_all(out_dir: Path, models) -> Dict[str, str]:
  """Save each ``(name, file stem, model)`` to ``<stem>.npz`` and list
  those the engine refuses in ``refused.json``."""
  out_dir.mkdir(parents=True, exist_ok=True)
  refused = {}
  for name, stem, mdl in models:
    try:
      check_supported(mdl)
    except NotImplementedError as err:
      refused[name] = str(err)
    save_model(mdl, out_dir / f"{stem}.npz")
  with open(out_dir / "refused.json", "w") as f:
    json.dump(refused, f, indent=1, sort_keys=True)
    f.write("\n")
  return refused


def write_models(out_dir: Path = MODELS_DIR) -> Dict[str, str]:
  """Extract every gym device model from gymnasium's assets to
  ``<stem>.npz`` and every dm_control variant from the replicas to
  ``dmc/<name>.npz``, each directory with its ``refused.json``. Returns the
  gym models' refusals."""
  from .dmc.assets import DMC_XMLS
  _write_all(out_dir / "dmc", (
    (name, name, extract_model_string(xml)) for name, xml in DMC_XMLS.items()
  ))
  return _write_all(out_dir, (
    (xml, Path(xml).stem, extract_model(gym_asset(xml)))
    for xml in GYM_DEVICE_XMLS
  ))


def main(argv: Sequence[str] = ()) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--write", action="store_true",
                      help="regenerate models/ from gymnasium's assets and "
                           "the dmc replicas")
  args = parser.parse_args(list(argv))
  if not args.write:
    parser.print_help()
    return 2
  refused = write_models()
  from .dmc.assets import DMC_XMLS
  print(f"wrote {len(GYM_DEVICE_XMLS)} gym and {len(DMC_XMLS)} dmc models "
        f"to {MODELS_DIR}; refused {sorted(refused)}, dmc "
        f"{sorted(refused_models(DMC_MODELS_DIR))}")
  return 0


if __name__ == "__main__":
  import sys
  sys.exit(main(sys.argv[1:]))
