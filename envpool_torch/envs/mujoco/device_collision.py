"""Contacts for the port's on-device MuJoCo engine: narrow phase, constraint
rows and the primal Newton solve, batched.

Counterpart of ``envpool_tpu/envs/mujoco/device_collision.py``, function
for function and with the same names, over the contact tables of
``device_model.ContactData``. The JAX package writes one env and ``vmap``s
it; here every function takes the batch: ``q`` ``[N, nq]``, ``v``
``[N, nv]`` and the kinematics of ``device_engine._kin_ctx`` (per body
``[N, 3]`` positions and ``[N, 3, 3]`` rotations, the motion subspaces
``S`` ``[N, nv, 6]``).

- Candidate contacts are the model's constants; the narrow phase evaluates
  every candidate and masks the inactive ones, so shapes are fixed and a
  step reads nothing back to the host.
- The rows are MuJoCo's soft constraints in the JAX order: joint limits,
  then the limited tendons, then the condim-1 points, then the four
  pyramid facets of each condim-3 point (``contact_wrenches`` and the dmc
  touch sensors rely on it).
- The solve is MuJoCo's primal Newton over qacc with an exact
  piecewise-quadratic line search, ``iters`` and ``ls_iters`` Python loops
  of the model's depth with no early exit; the active set is a mask. The
  Hessian ``M + J' diag(w) J`` is one float32-true ``matmul`` (TF32 held
  off, ``ops.image.no_tf32``), the JAX code's ``Precision.HIGHEST``; the
  factor is the engine's floored Cholesky (``_psd_solver``).

The families the port has, every one the extractor writes:
plane-capsule/sphere and capsule-capsule (spheres are capsules with zero
half-length), plane-cylinder (four rim candidates, two of them gated in
below 45 degrees of tilt) and sphere/capsule-cylinder (the solid
cylinder's signed distance and a golden-section search of fixed length
along the capsule axis), plane-box (eight corner candidates, the lower
ones gated in) and sphere/capsule-box (the box SDF and the same search),
condim 1 and 3, joint-limit rows and the rows of limited 2-site spatial
tendons.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from envpool_torch.ops.image import no_tf32

from .device_engine import _ByIdentity, _mm3, _mv, _psd_solver, _vm
from .device_model import ContactData, DeviceModel

Tensor = torch.Tensor


def _family_arrays(cd: ContactData, geoms, prefix: str) -> Dict[str, np.ndarray]:
  """Pose constants of a static tuple of geom ids: their bodies, and their
  offsets and rotations in those bodies' frames."""
  gs = np.asarray(geoms, np.int64)
  return {
    prefix + "body": cd.geom_body[gs],
    prefix + "gpos": cd.geom_pos[gs],
    prefix + "grot": cd.geom_rotm[gs],
  }


def _contact_arrays(mdl: DeviceModel) -> Dict[str, np.ndarray]:
  """The constants of the contact pass, derived from the tables."""
  cd = mdl.contacts
  out: Dict[str, np.ndarray] = {}
  if cd.pc_plane:
    caps = np.asarray(cd.pc_cap, np.int64)
    two = np.asarray(cd.pc_two, bool)
    out.update(_family_arrays(cd, cd.pc_plane, "pcp_"))
    out.update(_family_arrays(cd, cd.pc_cap, "pcc_"))
    out.update(
      pc_r=cd.geom_size[caps, 0],
      pc_hl=np.where(two, cd.geom_size[caps, 1], 0.0),
      pc_two=two[:, None],
      # the candidate rows: pair 0's endpoints, pair 1's ... (a sphere
      # gives one)
      pc_rows=np.asarray([i * 2 + e for i in range(len(two))
                          for e in range(2 if two[i] else 1)], np.int64),
    )
  if cd.cc_g1:
    g1 = np.asarray(cd.cc_g1, np.int64)
    g2 = np.asarray(cd.cc_g2, np.int64)
    out.update(_family_arrays(cd, cd.cc_g1, "cc1_"))
    out.update(_family_arrays(cd, cd.cc_g2, "cc2_"))
    out.update(cc_r1=cd.geom_size[g1, 0], cc_r2=cd.geom_size[g2, 0],
               cc_hl1=cd.geom_size[g1, 1], cc_hl2=cd.geom_size[g2, 1])
  if cd.pcy_plane:
    cyls = np.asarray(cd.pcy_cyl, np.int64)
    out.update(_family_arrays(cd, cd.pcy_plane, "pcyp_"))
    out.update(_family_arrays(cd, cd.pcy_cyl, "pcyc_"))
    out.update(pcy_r=cd.geom_size[cyls, 0], pcy_h=cd.geom_size[cyls, 1])
  if cd.cyc_cap:
    caps = np.asarray(cd.cyc_cap, np.int64)
    cyls = np.asarray(cd.cyc_cyl, np.int64)
    out.update(_family_arrays(cd, cd.cyc_cap, "cycc_"))
    out.update(_family_arrays(cd, cd.cyc_cyl, "cycy_"))
    out.update(cyc_rcap=cd.geom_size[caps, 0], cyc_hl=cd.geom_size[caps, 1],
               cyc_R=cd.geom_size[cyls, 0], cyc_H=cd.geom_size[cyls, 1])
  if cd.pb_plane:
    sz = cd.geom_size[np.asarray(cd.pb_box, np.int64)]           # [npb, 3]
    out.update(_family_arrays(cd, cd.pb_plane, "pbp_"))
    out.update(_family_arrays(cd, cd.pb_box, "pbb_"))
    # the box corners in mjc_PlaneBox's order: i&1 -> +x, i&2 -> +y, i&4 -> +z
    signs = np.array([[1.0 if i & (1 << k) else -1.0 for k in range(3)]
                      for i in range(8)])
    out.update(pb_corners=signs[None] * sz[:, None])          # [npb, 8, 3]
  if cd.sb_cap:
    caps = np.asarray(cd.sb_cap, np.int64)
    three = np.asarray(cd.sb_three, bool)
    out.update(_family_arrays(cd, cd.sb_cap, "sbc_"))
    out.update(_family_arrays(cd, cd.sb_box, "sbb_"))
    out.update(
      sb_r=cd.geom_size[caps, 0],
      sb_hl=np.where(three, cd.geom_size[caps, 1], 0.0),
      sb_size=cd.geom_size[np.asarray(cd.sb_box, np.int64)],    # [ns, 3]
      # the candidate rows: a sphere keeps its first of three, a capsule
      # all three (both endpoints, then the mid-segment point)
      sb_rows=np.asarray([p * 3 + e for p in range(len(three))
                          for e in range(3 if three[p] else 1)], np.int64),
    )
  T = cd.ten_site_body.shape[0]
  if T:
    out.update(ten_body=cd.ten_site_body, ten_spos=cd.ten_site_pos,
               ten_anc=cd.ten_anc[..., None],                   # [T, 2, nv, 1]
               ten_lo=cd.ten_lo, ten_hi=cd.ten_hi)
  one = np.where(cd.point_condim == 1)[0]
  pyr = np.where(cd.point_condim == 3)[0]
  # contact row -> its point: the condim-1 points, then 4 facets each
  rowpt = np.concatenate([one, np.repeat(pyr, 4)]).astype(np.int64)
  L = len(cd.lim_dof)
  lim_unit = np.zeros((L, mdl.nv))
  lim_unit[np.arange(L), np.asarray(cd.lim_dof, np.int64)] = 1.0
  P = cd.point_b1.shape[0]
  assign = np.zeros((P, mdl.nbody))
  for p in range(P):  # +wrench on body2, -wrench on body1, world excluded
    if int(cd.point_b2[p]) != 0:
      assign[p, int(cd.point_b2[p])] += 1.0
    if int(cd.point_b1[p]) != 0:
      assign[p, int(cd.point_b1[p])] -= 1.0
  # the limits', the tendons' and the points' soft-constraint constants
  # side by side: [L limits, T tendons, P points]; the impedance spline's
  # endpoints clamped as mj_assignImpedance does
  si = np.concatenate([cd.lim_solimp, cd.ten_solimp, cd.point_solimp])
  mid, power = si[:, 3], si[:, 4]
  out.update(
    e_y=np.array([0.0, 1.0, 0.0]), e_z=np.array([0.0, 0.0, 1.0]),
    margin=np.concatenate([cd.lim_margin, cd.ten_margin, cd.point_incmargin]),
    width=si[:, 2],
    K=np.concatenate([cd.lim_K, cd.ten_K, cd.point_K]),
    diagA=np.concatenate([cd.lim_diagA, cd.ten_diagA, cd.point_diagA]),
    imp_d0=np.clip(si[:, 0], 1e-4, 0.9999),
    imp_dmax=np.clip(si[:, 1], 1e-4, 0.9999),
    imp_mid=mid, imp_power=power,
    imp_a=1.0 / mid ** (power - 1), imp_b=1.0 / (1.0 - mid) ** (power - 1),
    # constraint row -> its entry of [L limits, T tendons, P points]
    row_idx=np.concatenate([np.arange(L + T), L + T + rowpt]).astype(np.int64),
    row_B=np.concatenate([cd.lim_B, cd.ten_B, cd.point_B[rowpt]]),
    pt_sgn=cd.point_sgn[:, None, :],                    # [P, 1, nv]
    pyr_mu=cd.point_mu[pyr][:, :, None],                # [Pp, 2, 1]
    pyr_sign=np.array([1.0, -1.0])[:, None],           # [2, 1]
    one=one, pyr=pyr,
    # point order of [condim-1 points, condim-3 points]
    pt_order=np.argsort(np.concatenate([one, pyr])).astype(np.int64),
    assign_t=assign.T,                                  # [nbody, P]
    lim_unit=lim_unit,
    lim_lo=cd.lim_lo, lim_hi=cd.lim_hi,
    lim_qadr=np.asarray(cd.lim_qadr, np.int64),
  )
  return out


_INDEX_KEYS = ("pc_rows", "row_idx", "one", "pyr", "pt_order", "lim_qadr",
               "pcp_body", "pcc_body", "cc1_body", "cc2_body", "pcyp_body",
               "pcyc_body", "cycc_body", "cycy_body", "pbp_body", "pbb_body",
               "sbc_body", "sbb_body", "sb_rows", "ten_body")


@functools.lru_cache(maxsize=64)
def _contact_table(key: _ByIdentity, dtype: torch.dtype,
                   device: torch.device) -> Dict[str, Tensor]:
  out = {}
  for k, v in _contact_arrays(key.mdl).items():
    if k in _INDEX_KEYS:
      out[k] = torch.as_tensor(v, dtype=torch.int64, device=device)
    elif v.dtype == bool:
      out[k] = torch.as_tensor(v, dtype=torch.bool, device=device)
    else:
      out[k] = torch.as_tensor(v, dtype=dtype, device=device)
  return out


def _cconsts(mdl: DeviceModel, like: Tensor) -> Dict[str, Tensor]:
  """The contact constants in ``like``'s dtype and device, made once per
  (model, dtype, device)."""
  return _contact_table(_ByIdentity(mdl), like.dtype, like.device)


# ------------------------------------------------------------ narrow phase


def _make_frames_v(n: Tensor, c: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
  """mju_makeFrame over ``[..., 3]`` normals: t1 = normalize(n x tmp), t2 =
  n x t1, tmp = +z when the normal is far from z, else +y."""
  tmp = torch.where((torch.abs(n[..., 2]) < 0.5)[..., None], c["e_z"], c["e_y"])
  t1 = torch.linalg.cross(n, tmp)
  t1 = t1 / torch.sqrt((t1 * t1).sum(-1, keepdim=True) + 1e-30)
  return t1, torch.linalg.cross(n, t1)


def _geom_poses(c: Dict[str, Tensor], xpos: Tensor, xmat: Tensor,
                prefix: str, world: bool) -> Tuple[Tensor, Tensor]:
  """World poses ``([N, n, 3], [N, n, 3, 3])`` of a family's geoms from the
  stacked body poses ``xpos`` ``[N, nbody, 3]`` and ``xmat``. Geoms of the
  world body (``world``) keep their model frames, as the JAX code's
  products with the world's identity frame give them exactly."""
  gp, gr = c[prefix + "gpos"], c[prefix + "grot"]
  n = xpos.shape[0]
  if world:
    return gp.expand(n, *gp.shape), gr.expand(n, *gr.shape)
  X = xpos[:, c[prefix + "body"]]
  R = xmat[:, c[prefix + "body"]]
  return X + _mv(R, gp), _mm3(R, gr)


def _all_world(cd: ContactData, geoms) -> bool:
  return all(int(cd.geom_body[g]) == 0 for g in geoms)


def contact_points(mdl: DeviceModel, xpos: List[Tensor], xmat: List[Tensor]):
  """Narrow phase over all candidates.

  Returns (pos ``[N, P, 3]``, dist ``[N, P]``, n, t1, t2 ``[N, P, 3]``,
  gate ``[N, P]``), in the tables' point order. ``gate`` is a condition of
  activation beyond the margin test: True everywhere but at the
  plane-cylinder face rims, which count only below 45 degrees of tilt, and
  at the plane-box corners, where it keeps the lower half of the box.
  Plane-capsule: one
  candidate per endpoint sphere (``mjc_PlaneCapsule``): dist = n.(e - p0)
  - r, pos = e - n (r + dist/2); the first tangent is the capsule axis
  projected onto the plane (mju_makeFrame where that is degenerate, and
  for spheres). Capsule-capsule: the closest points of the axis segments
  (clamped parametric solve), one candidate. Plane-cylinder: four rim
  points (``mjc_PlaneCylinder``' regimes). Sphere/capsule-cylinder: one
  closest-point candidate. Plane-box: the eight corners (``mjc_PlaneBox``'
  order). Sphere/capsule-box: the closest point of the box to each
  endpoint sphere and to the capsule-axis point that a 48-step
  golden-section search finds. Normals point geom1 -> geom2, as
  mjContact.frame does.
  """
  pos, dist, frame, gate = _points(mdl, xpos, xmat)
  if gate is None:
    gate = torch.ones_like(dist, dtype=torch.bool)
  return pos, dist, frame[:, :, 0], frame[:, :, 1], frame[:, :, 2], gate


def _point_box_v(c: Tensor, size: Tensor):
  """Points ``c`` ``[..., 3]`` against solid boxes of half-sizes ``size``
  (broadcast), in the box frames: (surface point ``[..., 3]``, signed
  distance ``[...]``, outward unit normal ``[..., 3]``). Outside, the
  closest surface point (a clamp) and the separation along it; inside, the
  nearest face with negative distance, ties split evenly (the JAX code's
  ``_point_box_v``)."""
  qv = torch.abs(c) - size
  out = torch.clamp_min(qv, 0.0)
  od = torch.sqrt((out * out).sum(-1) + 1e-30)
  outside = qv.amax(-1) > 0
  cl = torch.minimum(torch.maximum(c, -size), size)
  n_out = (c - cl) / od[..., None]
  qi = size - torch.abs(c)
  qmin = qi.amin(-1, keepdim=True)
  oh = (qi == qmin).to(c.dtype)
  oh = oh / oh.sum(-1, keepdim=True)
  sgn = torch.where(c >= 0, 1.0, -1.0).to(c.dtype)
  n_in = oh * sgn
  face = c * (1.0 - oh) + oh * sgn * size
  sdist = torch.where(outside, od, -qmin[..., 0])
  nrm = torch.where(outside[..., None], n_out, n_in)
  surf = torch.where(outside[..., None], cl, face)
  return surf, sdist, nrm


_GOLDEN = float((np.sqrt(5.0) - 1.0) / 2.0)


def _points(mdl: DeviceModel, xpos: List[Tensor], xmat: List[Tensor]):
  """``contact_points`` with the contact frames stacked: (pos, dist, frame
  ``[N, P, 3, 3]`` whose rows are n, t1, t2, gate ``[N, P]`` or None where
  every candidate is gated in)."""
  cd = mdl.contacts
  c = _cconsts(mdl, xpos[0])
  X = torch.stack(xpos, 1)                                  # [N, nbody, 3]
  R = torch.stack(xmat, 1)
  blocks = []
  if cd.pc_plane:
    ppos, prot = _geom_poses(c, X, R, "pcp_", _all_world(cd, cd.pc_plane))
    n = prot[..., 2]                                        # [N, np, 3]
    cpos, crot = _geom_poses(c, X, R, "pcc_", False)
    r, hl = c["pc_r"], c["pc_hl"]
    axis = crot[..., 2]
    # tangent along the in-plane axis projection (mjc_PlaneCapsule)
    proj = axis - (axis * n).sum(-1, keepdim=True) * n
    pn = torch.sqrt((proj * proj).sum(-1, keepdim=True))
    mf1, _ = _make_frames_v(n, c)
    use_proj = (pn > 1e-10) & c["pc_two"]
    t1 = torch.where(use_proj, proj / torch.clamp_min(pn, 1e-30), mf1)
    t2 = torch.linalg.cross(n, t1)
    half = hl[:, None] * axis
    ends = torch.stack([cpos - half, cpos + half], 2)       # [N, np, 2, 3]
    dist2 = (n[:, :, None] * (ends - ppos[:, :, None])).sum(-1) - r[:, None]
    pos2 = ends - n[:, :, None] * (r[:, None] + 0.5 * dist2)[..., None]
    npairs = len(cd.pc_plane)
    frame = torch.stack([n, t1, t2], 2)                     # [N, np, 3, 3]
    pos2 = pos2.reshape(-1, 2 * npairs, 3)
    dist2 = dist2.reshape(-1, 2 * npairs)
    frame = frame.repeat_interleave(2, 1)
    if not all(cd.pc_two):  # a sphere gives one candidate: gather the rows
      rows = c["pc_rows"]
      pos2, dist2, frame = pos2[:, rows], dist2[:, rows], frame[:, rows]
    blocks.append((pos2, dist2, frame, None))
  if cd.cc_g1:
    p1, r1m = _geom_poses(c, X, R, "cc1_", _all_world(cd, cd.cc_g1))
    p2, r2m = _geom_poses(c, X, R, "cc2_", _all_world(cd, cd.cc_g2))
    r1, r2, hl1, hl2 = c["cc_r1"], c["cc_r2"], c["cc_hl1"], c["cc_hl2"]
    a1, a2 = r1m[..., 2], r2m[..., 2]
    d12 = p2 - p1
    A = (a1 * a1).sum(-1)
    Bq = (a1 * a2).sum(-1)
    C = (a2 * a2).sum(-1)
    D_ = (a1 * d12).sum(-1)
    E = (a2 * d12).sum(-1)
    den = A * C - Bq * Bq
    s = torch.where(torch.abs(den) > 1e-12, (C * D_ - Bq * E) / den, 0.0)
    s = torch.clamp(s, -hl1, hl1)
    t = torch.clamp((Bq * s - E) / torch.clamp_min(C, 1e-12), -hl2, hl2)
    s = torch.clamp((Bq * t + D_) / torch.clamp_min(A, 1e-12), -hl1, hl1)
    q1 = p1 + s[..., None] * a1
    q2 = p2 + t[..., None] * a2
    diff = q2 - q1
    sep = torch.sqrt((diff * diff).sum(-1) + 1e-30)
    n = diff / sep[..., None]
    dist = sep - r1 - r2
    pos = q1 + n * (r1 + 0.5 * dist)[..., None]
    t1, t2 = _make_frames_v(n, c)
    blocks.append((pos, dist, torch.stack([n, t1, t2], 2), None))
  if cd.pcy_plane:
    blocks.append(_plane_cylinder(cd, c, X, R))
  if cd.cyc_cap:
    blocks.append(_capsule_cylinder(cd, c, X, R))
  if cd.pb_plane:
    blocks.append(_plane_box(cd, c, X, R))
  if cd.sb_cap:
    blocks.append(_sphere_capsule_box(cd, c, X, R))
  if len(blocks) == 1:
    return blocks[0]
  gates = [b[3] for b in blocks]
  gate = None
  if any(g is not None for g in gates):
    gate = torch.cat([
      torch.ones_like(b[1], dtype=torch.bool) if g is None else g
      for b, g in zip(blocks, gates)], 1)
  return tuple(torch.cat([b[k] for b in blocks], 1) for k in range(3)) + (gate,)


_C120, _S120 = -0.5, float(np.sqrt(3.0) / 2.0)


def _plane_cylinder(cd: ContactData, c: Dict[str, Tensor], X: Tensor,
                    R: Tensor):
  """Plane-cylinder: four candidates per pair, ``mjc_PlaneCylinder``'
  regimes: the deepest point of the rim nearer the plane, the two points
  of that rim at +-120 degrees from it (gated in only below 45 degrees of
  tilt, where the face rests), and the deepest point of the far rim (the
  side resting). Each is a plane-point contact midway between the point
  and the plane. Where the axis is exactly normal to the plane, the
  radial direction is the cylinder's local x projected onto the plane.
  The tangents are mju_makeFrame's of the plane normal."""
  ppos, prot = _geom_poses(c, X, R, "pcyp_", _all_world(cd, cd.pcy_plane))
  cpos, crot = _geom_poses(c, X, R, "pcyc_", _all_world(cd, cd.pcy_cyl))
  n = prot[..., 2]                                          # [N, npcy, 3]
  r, h = c["pcy_r"][:, None], c["pcy_h"][:, None]
  ax = crot[..., 2]
  prj = (ax * n).sum(-1, keepdim=True)
  flip = torch.where(prj > 0, -1.0, 1.0).to(ax.dtype)
  axf = flip * ax                      # the axis pointing toward the plane
  prjf = flip * prj                    # <= 0
  raw = prjf * axf - n                 # the radial direction of descent
  slen = torch.sqrt(torch.clamp_min(1.0 - prjf * prjf, 0.0))
  cx = crot[..., 0]
  fb = cx - (cx * n).sum(-1, keepdim=True) * n
  fb = fb / torch.sqrt((fb * fb).sum(-1, keepdim=True) + 1e-30)
  d_r = torch.where(slen > 1e-10, raw / torch.clamp_min(slen, 1e-30), fb)
  t_perp = torch.linalg.cross(axf, d_r)
  e_lo = cpos + h * axf
  face = (slen < -prjf)[..., 0]        # tilt below 45 degrees
  cands = torch.stack([
    e_lo + r * d_r,
    e_lo + r * (_C120 * d_r + _S120 * t_perp),
    e_lo + r * (_C120 * d_r - _S120 * t_perp),
    cpos - h * axf + r * d_r,
  ], 2)                                                     # [N, npcy, 4, 3]
  dist4 = (n[:, :, None] * (cands - ppos[:, :, None])).sum(-1)
  pos4 = cands - n[:, :, None] * (0.5 * dist4)[..., None]
  yes = torch.ones_like(face)
  gate = torch.stack([yes, face, face, yes], 2)
  t1, t2 = _make_frames_v(n, c)
  frame = torch.stack([n, t1, t2], 2).repeat_interleave(4, 1)
  return pos4.flatten(1, 2), dist4.flatten(1), frame, gate.flatten(1)


def _capsule_cylinder(cd: ContactData, c: Dict[str, Tensor], X: Tensor,
                      R: Tensor):
  """Sphere/capsule-cylinder: one closest-point candidate per pair. The
  signed distance of a point to the solid cylinder is exact; the capsule
  axis point that minimises it (convex along a line) is found by 48 steps
  of golden-section search, as for the boxes. Outside, the contact is
  along the segment to the closest surface point (side, rim or face);
  inside, along the nearer exit (side or face), the depth MPR reports for
  a swept sphere. Normal capsule -> cylinder, the point midway between
  the two surfaces."""
  p1, r1m = _geom_poses(c, X, R, "cycc_", _all_world(cd, cd.cyc_cap))
  p2, r2m = _geom_poses(c, X, R, "cycy_", _all_world(cd, cd.cyc_cyl))
  a1, a2 = r1m[..., 2], r2m[..., 2]                         # [N, nc, 3]
  rcap, hl = c["cyc_rcap"], c["cyc_hl"]
  Rc, H = c["cyc_R"], c["cyc_H"]

  def radial(s):
    """Axis point C(s), its offset w from the cylinder's centre, axial
    coordinate z, radial vector and radius, for ``s`` ``[N, nc(, k)]``."""
    e = (slice(None), slice(None)) + ((None,) if s.ndim == 3 else ())
    cpt = p1[e] + s[..., None] * a1[e]
    w = cpt - p2[e]
    z = (w * a2[e]).sum(-1)
    rv = w - z[..., None] * a2[e]
    return cpt, z, rv, torch.sqrt((rv * rv).sum(-1) + 1e-30)

  def sdist(s):
    _, z, _, rho = radial(s)
    k = (slice(None),) + ((None,) if s.ndim == 3 else ())
    dz = torch.clamp_min(torch.abs(z) - H[k], 0.0)
    dr = torch.clamp_min(rho - Rc[k], 0.0)
    out = torch.sqrt(dz * dz + dr * dr)
    return torch.where(out > 0, out,
                       torch.maximum(rho - Rc[k], torch.abs(z) - H[k]))

  lo = (-hl).expand(X.shape[0], -1)
  hi = hl.expand(X.shape[0], -1)
  for _ in range(48):
    width = hi - lo
    x1 = hi - _GOLDEN * width
    x2 = lo + _GOLDEN * width
    sd = sdist(torch.stack([x1, x2], -1))
    take_lo = sd[..., 0] < sd[..., 1]
    lo, hi = torch.where(take_lo, lo, x1), torch.where(take_lo, x2, hi)
  cpt, z, rv, rho = radial(0.5 * (lo + hi))
  rhat = rv / rho[..., None]
  inside = ((rho <= Rc) & (torch.abs(z) <= H))[..., None]
  sgnz = torch.where(z >= 0, 1.0, -1.0).to(z.dtype)
  zc = torch.minimum(torch.maximum(z, -H), H)
  surf_out = p2 + zc[..., None] * a2 + torch.minimum(rho, Rc)[..., None] * rhat
  diff = cpt - surf_out
  dd = torch.sqrt((diff * diff).sum(-1) + 1e-30)
  n_out = -diff / dd[..., None]
  side = ((rho - Rc) >= (torch.abs(z) - H))[..., None]
  surf_in = torch.where(side, p2 + z[..., None] * a2 + Rc[:, None] * rhat,
                        p2 + (sgnz * H)[..., None] * a2 + rv)
  n_in = torch.where(side, -rhat, -(sgnz[..., None] * a2))
  dist_in = torch.maximum(rho - Rc, torch.abs(z) - H) - rcap
  nrm = torch.where(inside, n_in, n_out)
  dist = torch.where(inside[..., 0], dist_in, dd - rcap)
  surf = torch.where(inside, surf_in, surf_out)
  pos = 0.5 * ((cpt + rcap[:, None] * nrm) + surf)
  t1, t2 = _make_frames_v(nrm, c)
  return pos, dist, torch.stack([nrm, t1, t2], 2), None


def _plane_box(cd: ContactData, c: Dict[str, Tensor], X: Tensor, R: Tensor):
  """Plane-box: eight corner candidates per pair (``mjc_PlaneBox``' order:
  i&1 -> +x, i&2 -> +y, i&4 -> +z), each a plane-point contact midway
  between the corner and the plane. ``mjc_PlaneBox`` emits only the
  corners of the box's lower half (corner offset . plane normal <= 0),
  whatever their depth: that is the gate."""
  ppos, prot = _geom_poses(c, X, R, "pbp_", _all_world(cd, cd.pb_plane))
  n = prot[..., 2]                                          # [N, npb, 3]
  bpos, brot = _geom_poses(c, X, R, "pbb_", False)
  offs = _mv(brot[:, :, None], c["pb_corners"])             # [N, npb, 8, 3]
  corners = bpos[:, :, None] + offs
  dist8 = (n[:, :, None] * (corners - ppos[:, :, None])).sum(-1)
  pos8 = corners - n[:, :, None] * (0.5 * dist8)[..., None]
  lower = (offs * n[:, :, None]).sum(-1) <= 0
  t1, t2 = _make_frames_v(n, c)
  frame = torch.stack([n, t1, t2], 2).repeat_interleave(8, 1)
  return pos8.flatten(1, 2), dist8.flatten(1), frame, lower.flatten(1)


def _sphere_capsule_box(cd: ContactData, c: Dict[str, Tensor], X: Tensor,
                        R: Tensor):
  """Sphere/capsule-box: the closest box point to each candidate sphere of
  the capsule (a sphere has one, a capsule three: its endpoints and the
  axis point nearest the box). The axis point minimises the box's signed
  distance along the segment (convex along a line), found by 48 steps of
  golden-section search: a Python loop of fixed length, the bracket
  updated per lane by ``torch.where``, both probes of a step evaluated in
  one pass."""
  cpos, crot = _geom_poses(c, X, R, "sbc_", False)
  bpos, brot = _geom_poses(c, X, R, "sbb_", False)
  r, hl, sz = c["sb_r"], c["sb_hl"], c["sb_size"]
  axis = crot[..., 2]                                       # [N, ns, 3]
  brot2 = brot[:, :, None]                                  # [N, ns, 1, 3, 3]

  def sdist_s(s):
    """The boxes' signed distance of the axis points C(s) ``[N, ns, k]``."""
    cw = cpos[:, :, None] + s[..., None] * axis[:, :, None]
    cb = _vm(cw - bpos[:, :, None], brot2)                  # box frames
    qv = torch.abs(cb) - sz[:, None]
    out = torch.clamp_min(qv, 0.0)
    od = torch.sqrt((out * out).sum(-1) + 1e-30)
    inner = qv.amax(-1)
    return torch.where(inner > 0, od, inner)

  lo = (-hl).expand(X.shape[0], -1)
  hi = hl.expand(X.shape[0], -1)
  for _ in range(48):
    width = hi - lo
    x1 = hi - _GOLDEN * width
    x2 = lo + _GOLDEN * width
    sd = sdist_s(torch.stack([x1, x2], -1))
    take_lo = sd[..., 0] < sd[..., 1]
    lo, hi = torch.where(take_lo, lo, x1), torch.where(take_lo, x2, hi)
  s_mid = 0.5 * (lo + hi)
  cands = torch.stack([cpos - hl[:, None] * axis, cpos + hl[:, None] * axis,
                       cpos + s_mid[..., None] * axis], 2)  # [N, ns, 3, 3]
  cb = _vm(cands - bpos[:, :, None], brot2)                 # box frames
  surf, sdist, outward = _point_box_v(cb, sz[:, None])
  dist3 = sdist - r[:, None]
  nrm3 = -_mv(brot2, outward)                               # geom1 -> geom2
  ps = cands + nrm3 * r[:, None, None]
  surf_w = bpos[:, :, None] + _mv(brot2, surf)
  pos3 = 0.5 * (ps + surf_w)
  pos3, dist3, nrm3 = pos3.flatten(1, 2), dist3.flatten(1), nrm3.flatten(1, 2)
  if not all(cd.sb_three):  # a sphere keeps one candidate
    rows = c["sb_rows"]
    pos3, dist3, nrm3 = pos3[:, rows], dist3[:, rows], nrm3[:, rows]
  t1, t2 = _make_frames_v(nrm3, c)
  return pos3, dist3, torch.stack([nrm3, t1, t2], 2), None


def _impedance_v(c: Dict[str, Tensor], x: Tensor) -> Tensor:
  """MuJoCo impedance d(x) ``[N, R]`` of rows with per-row solimp (the
  ``imp_*`` constants, endpoints clamped to [mjMINIMP, mjMAXIMP] = [1e-4,
  0.9999] as mj_assignImpedance does)."""
  x = torch.clamp(x, 0.0, 1.0)
  y = torch.where(x <= c["imp_mid"], c["imp_a"] * x ** c["imp_power"],
                  1.0 - c["imp_b"] * (1.0 - x) ** c["imp_power"])
  return c["imp_d0"] + y * (c["imp_dmax"] - c["imp_d0"])


# ------------------------------------------------------- row assembly


def _pick(x: Tensor, idx: np.ndarray, t: Tensor, dim: int = 1) -> Tensor:
  """``x`` indexed by the constant ``idx`` along ``dim`` (``t`` the same
  index on the device): a view where ``idx`` is a contiguous range."""
  if len(idx) and np.array_equal(idx, np.arange(idx[0], idx[0] + len(idx))):
    return x.narrow(dim, int(idx[0]), len(idx))
  return x.index_select(dim, t)


def _tendon_rows(cd: ContactData, c: Dict[str, Tensor], X: Tensor, R: Tensor,
                 S: Tensor):
  """The limited 2-site spatial tendons: (length ``[N, T]``, dL/dq ``[N, T,
  nv]``). dL/dq = u . (V(p2) - V(p1)) with u the unit vector p1 -> p2 and
  V(p) the velocity Jacobian of site point p, [S_lin + S_ang x p], over the
  dofs that move the site's body."""
  body = c["ten_body"]                                      # [T, 2]
  p = X[:, body] + _mv(R[:, body], c["ten_spos"])           # [N, T, 2, 3]
  Sa = S[:, None, None, :, :3]                              # [N, 1, 1, nv, 3]
  Vd = S[:, None, None, :, 3:] + torch.linalg.cross(Sa, p[:, :, :, None])
  Jp = Vd * c["ten_anc"]                                    # [N, T, 2, nv, 3]
  diff = p[:, :, 1] - p[:, :, 0]
  length = torch.sqrt((diff * diff).sum(-1) + 1e-30)
  u = diff / length[..., None]
  return length, _mv(Jp[:, :, 1] - Jp[:, :, 0], u)


def assemble_rows(mdl: DeviceModel, cd: ContactData, q: Tensor, v: Tensor, ctx):
  """All constraint rows of the batch -> (J ``[N, m, nv]``, aref, D, mask
  ``[N, m]``).

  Row order: joint limits, then the limited tendons, then the condim-1
  points' normal rows, then per condim-3 point its pyramid facets (n + mu
  t1, n - mu t1, n + mu t2, n - mu t2), mirroring mjData.efc_* (limits
  before contacts). A limit row is +-e_dof by the nearer limit, a tendon
  row +-dL/dq by the nearer limit of its length; a contact row is the
  point's frame direction through the point-velocity Jacobian,
  n.(S_lin + S_ang x pos) = [pos x n; n].S per dof, signed by the dof's
  influence on body2 - body1. All rows share one impedance pass:
    aref = -B J.v - K imp (dist - margin),  D = 1/R,
    R = (1 - imp)/imp diagApprox,  active: dist < margin (and the gate).
  """
  xpos, xmat, S, _ = ctx
  c = _cconsts(mdl, q)
  P = cd.point_b1.shape[0]
  T = cd.ten_site_body.shape[0]
  with no_tf32(q.device):
    # the limits' distances to the nearer limit, then the tendons', then
    # the points'
    ql = q[:, c["lim_qadr"]]
    dist_lo = ql - c["lim_lo"]
    dist_hi = c["lim_hi"] - ql
    use_lo = dist_lo < dist_hi
    s = torch.where(use_lo, 1.0, -1.0).to(q.dtype)
    dists = [torch.where(use_lo, dist_lo, dist_hi)]
    J_l = [s[:, :, None] * c["lim_unit"]]
    if T:
      length, dLdq = _tendon_rows(cd, c, torch.stack(xpos, 1),
                                  torch.stack(xmat, 1), S)
      dist_lo = length - c["ten_lo"]
      dist_hi = c["ten_hi"] - length
      use_lo = dist_lo < dist_hi
      dists.append(torch.where(use_lo, dist_lo, dist_hi))
      J_l.append(torch.where(use_lo, 1.0, -1.0).to(q.dtype)[..., None] * dLdq)
    gate = None
    if P:
      pos, dist, frame, gate = _points(mdl, xpos, xmat)
      dists.append(dist)
    dist = torch.cat(dists, 1)
    active = dist < c["margin"]
    if gate is not None:
      active = torch.cat([active[:, :-P], active[:, -P:] & gate], 1)
    off = dist - c["margin"]
    imp = _impedance_v(c, torch.abs(off) / c["width"])
    kpos = c["K"] * imp * off
    D = 1.0 / ((1.0 - imp) / imp * c["diagA"])
    if P:
      # Jacobian rows of each point's frame: [pos x f; f] . S_d
      G = torch.cat([torch.linalg.cross(pos[:, :, None], frame), frame], -1)
      Jf = torch.matmul(G.flatten(1, 2), S.transpose(1, 2))
      Jf = Jf.unflatten(1, (-1, 3)) * c["pt_sgn"]            # [N, P, 3, nv]
      one = np.where(cd.point_condim == 1)[0]
      pyr = np.where(cd.point_condim == 3)[0]
      if len(one):
        J_l.append(_pick(Jf, one, c["one"])[:, :, 0])
      if len(pyr):
        Jp = _pick(Jf, pyr, c["pyr"])
        # (t1, +), (t1, -), (t2, +), (t2, -) facets of each point
        facets = Jp[:, :, :1, None] + c["pyr_sign"] * (Jp[:, :, 1:] * c["pyr_mu"])[:, :, :, None]
        J_l.append(facets.flatten(1, 3))
    J = torch.cat(J_l, 1)
    rows = c["row_idx"]
    aref = -c["row_B"] * torch.matmul(J, v[:, :, None])[..., 0] - kpos[:, rows]
  return J, aref, D[:, rows], active[:, rows]


# ---------------------------------------------------------------- solver


def newton_qacc(floor, M: Tensor, a0: Tensor, J: Tensor, aref: Tensor,
                D: Tensor, mask: Tensor, iters: int = 6, ls_iters: int = 6,
                start=None):
  """MuJoCo's primal Newton solve over qacc (solver=Newton, pyramidal).

  Minimizes  0.5 (a-a0)' M (a-a0) + 0.5 sum_i w_i(a) D_i (J_i a - aref_i)^2
  with w_i(a) = mask_i AND (J_i a - aref_i < 0), by ``iters`` damped Newton
  steps, each with ``ls_iters`` 1-D Newton steps on phi'(alpha) (the exact
  piecewise-quadratic line search), alpha in [0, 2]. ``floor`` is the
  per-dof pivot floor of the Hessian's Cholesky factor (``_psd_solver``).
  Fixed depth, no early exit and no host read. Returns (qacc, efc_force).
  An inactive row's D is dropped, not multiplied by 0: it is inf where
  both bodies are static (a receptacle placed by ``fk``'s ``mut`` over the
  floor: diagApprox 0), and XLA turns the JAX code's ``D * mask`` into
  that select.
  """
  Dm = torch.where(mask, D, 0.0)
  a = a0 if start is None else start
  with no_tf32(M.device):
    for _ in range(iters):
      r = torch.matmul(J, a[:, :, None])[..., 0] - aref
      w = Dm * (r < 0)
      Mda = _mv(M, a - a0)
      grad = Mda + torch.matmul((w * r)[:, None], J)[:, 0]
      # H = M + J' diag(w) J, float32-true (the JAX code's HIGHEST)
      H = torch.baddbmm(M, J.transpose(1, 2), J * w[:, :, None])
      delta = -_psd_solver(H, floor)(grad)
      p = torch.matmul(J, delta[:, :, None])[..., 0]
      q2 = (delta * _mv(M, delta)).sum(-1, keepdim=True)
      q1 = (delta * Mda).sum(-1, keepdim=True)
      Dp = Dm * p
      alpha = torch.ones_like(q1)
      for _ in range(ls_iters):
        ra = torch.addcmul(r, alpha, p)
        wp = torch.where(ra < 0, Dp, 0.0)
        gh = torch.matmul(wp[:, None], torch.stack([ra, p], -1))[:, 0]
        g = torch.addcmul(q1, q2, alpha) + gh[:, :1]
        h = torch.clamp_min(q2 + gh[:, 1:], 1e-30)
        alpha = torch.clamp(torch.addcdiv(alpha, g, h, value=-1), 0.0, 2.0)
      a = torch.addcmul(a, alpha, delta)
    r = torch.matmul(J, a[:, :, None])[..., 0] - aref
  return a, torch.clamp_min(-(Dm * r), 0.0)


# ------------------------------------------------------ contact wrenches


def contact_wrenches(cd: ContactData, mdl: DeviceModel, q: Tensor, v: Tensor,
                     ctx, f_rows: Tensor, nbody: int) -> Tensor:
  """Per-body external contact wrench about the world origin ``[N, nbody,
  6]`` (torque, force).

  Rebuilds each point's world force from the solved row forces (pyramid
  facets: F = n sum(lam) + mu1 t1 (lam1 - lam2) + mu2 t2 (lam3 - lam4);
  condim-1: F = n lam) and adds +wrench to body2 and -wrench to body1, as
  mj_rnePostConstraint's cfrc_ext does, skipping the world body. The row
  layout is ``assemble_rows``': limits, tendons, condim-1 points, 4 facets
  per condim-3 point. The narrow phase is evaluated again here.
  """
  del v  # the JAX signature's
  if not cd.point_b1.shape[0]:
    return q.new_zeros(q.shape[0], nbody, 6)
  xpos, xmat = ctx[0], ctx[1]
  c = _cconsts(mdl, q)
  pos, _, frame, _ = _points(mdl, xpos, xmat)
  L = len(cd.lim_dof) + cd.ten_site_body.shape[0]  # rows before contacts
  one = np.where(cd.point_condim == 1)[0]
  pyr = np.where(cd.point_condim == 3)[0]
  F_l = []
  if len(one):
    lam = f_rows[:, L:L + len(one)]
    F_l.append(_pick(frame, one, c["one"])[:, :, 0] * lam[..., None])
  if len(pyr):
    lam = f_rows[:, L + len(one):].unflatten(1, (-1, 2, 2))   # [N, Pp, 2, 2]
    # per point: (sum(lam), mu1 (lam1 - lam2), mu2 (lam3 - lam4)) . (n, t1, t2)
    coef = torch.cat([lam.sum((2, 3))[..., None],
                      (lam * c["pyr_sign"][:, 0]).sum(3) * c["pyr_mu"][..., 0]], 2)
    F_l.append(_vm(coef, _pick(frame, pyr, c["pyr"])))
  F = F_l[0] if len(F_l) == 1 else torch.cat(F_l, 1)[:, c["pt_order"]]
  wrench = torch.cat([torch.linalg.cross(pos, F), F], -1)   # [N, P, 6]
  with no_tf32(q.device):
    return torch.matmul(c["assign_t"], wrench)
