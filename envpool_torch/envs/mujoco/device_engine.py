"""On-device MuJoCo, the port's batched PyTorch engine: smooth dynamics,
joint limits, fluid forces, free joints, contacts, Euler and RK4.

Counterpart of ``envpool_tpu/envs/mujoco/device_engine.py``, function for
function and with the same names, over the constants of a
``device_model.DeviceModel``. The JAX package writes one env's ``(q, v)``
as Python loops over bodies and dofs, ``vmap``s it and lets XLA fuse the
unrolled program. Eager PyTorch launches every op, so here each function
takes the batch (``q`` ``[N, nq]``, ``v`` ``[N, nv]``, ``ctrl`` ``[N, nu]``)
and also batches over bodies, dofs and limited joints wherever the tree
puts no order on them:

- the spatial inertias, the bias wrenches and the fluid forces of all
  bodies are one pass each over ``[N, nbody - 1, ...]``;
- sums over a subtree or a root path (composite inertias, subtree
  wrenches, body velocities, the velocities up to each dof in the
  Newton-Euler pass) are products with constant 0/1 ancestor masks;
- the limit rows of all limited joints are one pass over ``[N, nlim]``.

Only forward kinematics walks the tree, body by body. The results are
those of the JAX code up to the order of a few sums
(``tests/test_torch_device_mujoco.py`` holds float64 to 1e-12 relative).

Scope: kinematic trees of hinge, slide and free joints (a free joint's
quaternion integrated as ``mj_integratePos`` does), motor actuators, joint
damping, armature and springs, gravity, the inertia-box fluid model,
MuJoCo's soft joint-limit constraint, and contacts and limited tendons
through ``device_collision.py`` (the plane-capsule/sphere, capsule-capsule,
plane-cylinder, sphere/capsule-cylinder, plane-box and sphere/capsule-box
narrow phase, pyramidal rows, tendon rows and the primal Newton solve,
warm-started along each env-step's substeps as ``mjData.qacc_warmstart``
is), and per-env overrides of body poses (``fk``'s ``mut``).

Every function works in the dtype of ``q``: the tasks run float32, the
tests float64, where the engine matches the JAX engine under x64 and
``mj_step`` to the JAX package's tolerances. Small products are the JAX
code's elementwise multiply-and-sum (``_mm3``, ``_mv``, ``_vm``); the
matmuls that remain (the contact rows, the Newton Hessian, the quaternion
products) hold TF32 off, so float32 stays float32 on the card;
``precise_matmul``, a TPU workaround for its bf16 matrix passes, has no
counterpart. Nothing in a step reads the device back to the host: the
divergence guard is a per-lane ``torch.where``, the Newton solve has a
fixed depth.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from envpool_torch.core import graph
from envpool_torch.ops.image import no_tf32

from .device_model import DeviceModel, _JNT_FREE, _JNT_HINGE

Tensor = torch.Tensor


class _ByIdentity:
  """A model as a cache key, hashed by identity (a model holds numpy
  arrays, so it has no value hash)."""

  __slots__ = ("mdl",)

  def __init__(self, mdl: DeviceModel):
    self.mdl = mdl

  def __hash__(self):
    return id(self.mdl)

  def __eq__(self, other):
    return isinstance(other, _ByIdentity) and other.mdl is self.mdl


def _quat_rot_table() -> np.ndarray:
  """[16, 9]: the entries of (R - I) / 2 of a unit quaternion (w, x, y, z)
  as sums of its products q_i q_j (flattened row-major), e.g. R_01 / 2 =
  xy - wz, (R_00 - 1) / 2 = -(yy + zz)."""
  w, x, y, z = range(4)
  entries = [
    [(y, y, -1), (z, z, -1)], [(x, y, 1), (w, z, -1)], [(x, z, 1), (w, y, 1)],
    [(x, y, 1), (w, z, 1)], [(x, x, -1), (z, z, -1)], [(y, z, 1), (w, x, -1)],
    [(x, z, 1), (w, y, -1)], [(y, z, 1), (w, x, 1)], [(x, x, -1), (y, y, -1)],
  ]
  out = np.zeros((16, 9))
  for k, terms in enumerate(entries):
    for i, j, sign in terms:
      out[4 * i + j, k] = sign
  return out


_QUAT_ROT = _quat_rot_table()


def _limited(mdl: DeviceModel) -> List[int]:
  return [j for j in range(len(mdl.jnt_type)) if mdl.jnt_limited[j]]


def _limit_dofs(mdl: DeviceModel) -> List[int]:
  return sorted({mdl.jnt_dof[j] for j in _limited(mdl)})


def _fluid_bodies(mdl: DeviceModel) -> List[int]:
  return [b for b in range(1, mdl.nbody) if float(mdl.body_mass[b]) > 0]


def _constant_arrays(mdl: DeviceModel) -> Dict[str, np.ndarray]:
  """Float constants of the batched passes, derived from the model. Moving
  bodies are 1..nbody-1, indexed from 0 in the ``[N, nbody - 1, ...]``
  passes."""
  nv, nb = mdl.nv, mdl.nbody
  anc = np.asarray(mdl.ancestor, np.float64)           # [a, b]: a above b
  dof_anc = anc[np.ix_(mdl.dof_body, mdl.dof_body)]    # body(i) above body(j)
  out = {k: v for k, v in mdl._asdict().items() if isinstance(v, np.ndarray)}
  out.update(
    # the quaternion's products (w, x, y, z)^2 -> (R - I) / 2, row-major
    quat_rot=_QUAT_ROT,
    mask_a=dof_anc,
    mask_b=dof_anc.T * (1.0 - dof_anc),
    armature_diag=np.diag(mdl.dof_armature),
    damping_diag=np.diag(mdl.dof_damping),
    eye3=np.eye(3),
    eye_nv=np.eye(nv),
    lim_unit=np.eye(nv)[:, _limit_dofs(mdl)],
    acc0=np.concatenate([np.zeros(3), -mdl.gravity]),
    # [b, b']: moving body b is an ancestor-or-self of b' (subtree sums)
    subtree=anc[1:, 1:],
    # [b, d]: dof d moves moving body b (root-path sums)
    path=anc[np.ix_(mdl.dof_body, range(1, nb))].T,
    mass_m=mdl.body_mass[1:, None, None],
  )
  # [d, d']: dof d' lies on the root path up to and including dof d (a
  # body's joints form a serial chain in joint order); a free joint's three
  # rotations act as one block on the velocity before them (mj_comVel's
  # free case), so none of them lies on another's chain
  chain = np.zeros((nv, nv))
  for d in range(nv):
    for e in range(nv):
      bd, be = mdl.dof_body[d], mdl.dof_body[e]
      chain[d, e] = float(anc[be, bd] and (be != bd or e <= d))
  for j, kind in enumerate(mdl.jnt_type):
    if kind == _JNT_FREE:
      rot = range(mdl.jnt_dof[j] + 3, mdl.jnt_dof[j] + 6)
      for d in rot:
        for e in rot:
          chain[d, e] = float(e == d)
  out["chain"] = chain
  # fluid_force's per-body constants (bodies with mass only)
  fb = _fluid_bodies(mdl)
  box = mdl.body_ibox[fb]
  diam = box.mean(1)
  out.update(
    fluid_ipos=mdl.body_ipos[fb], fluid_irotm=mdl.body_irotm[fb],
    fluid_visc_t=(np.pi * diam ** 3 * mdl.viscosity)[:, None],
    fluid_visc_f=(3.0 * np.pi * diam * mdl.viscosity)[:, None],
    fluid_bj=np.stack(
      [box[:, 1] * box[:, 2], box[:, 0] * box[:, 2], box[:, 0] * box[:, 1]], 1
    ),
    fluid_bt=np.stack([
      box[:, 0] * (box[:, 1] ** 4 + box[:, 2] ** 4),
      box[:, 1] * (box[:, 0] ** 4 + box[:, 2] ** 4),
      box[:, 2] * (box[:, 0] ** 4 + box[:, 1] ** 4),
    ], 1) / 64.0,
    fluid_msk=anc[np.ix_(mdl.dof_body, fb)].T,       # [b, d]
  )
  # limit rows, one per limited joint, with MuJoCo's constants
  lim = _limited(mdl)
  si = mdl.jnt_solimp[lim].reshape(-1, 5)
  tc = np.maximum(mdl.jnt_solref[lim, 0], 2.0 * mdl.timestep)
  dr = mdl.jnt_solref[lim, 1]
  dmax_raw = si[:, 1]
  mid, power = si[:, 3], si[:, 4]
  out.update(
    lim_lo=mdl.jnt_range[lim, 0], lim_hi=mdl.jnt_range[lim, 1],
    lim_margin=mdl.jnt_margin[lim], lim_width=si[:, 2],
    lim_k=1.0 / (dmax_raw * dmax_raw * tc * tc * dr * dr),
    lim_b=2.0 / (dmax_raw * tc),
    lim_invw=mdl.dof_invweight0[[mdl.jnt_dof[j] for j in lim]],
    # the impedance spline (mj_assignImpedance clamps d0 and dmax)
    imp_d0=np.clip(si[:, 0], 1e-4, 0.9999),
    imp_dmax=np.clip(si[:, 1], 1e-4, 0.9999),
    imp_mid=mid, imp_power=power,
    imp_a=1.0 / mid ** (power - 1), imp_b=1.0 / (1.0 - mid) ** (power - 1),
  )
  return out


@functools.lru_cache(maxsize=64)
def _const_table(key: _ByIdentity, dtype: torch.dtype,
                 device: torch.device) -> Dict[str, Tensor]:
  mdl = key.mdl
  out = {
    k: torch.as_tensor(v, dtype=dtype, device=device)
    for k, v in _constant_arrays(mdl).items()
  }
  lim = _limited(mdl)

  def index(values):
    return torch.as_tensor(list(values), dtype=torch.int64, device=device)

  rot = [False] * mdl.nv  # hinges and free rotations are rotational
  for j, kind in enumerate(mdl.jnt_type):
    if kind == _JNT_FREE:
      rot[mdl.jnt_dof[j] + 3:mdl.jnt_dof[j] + 6] = [True] * 3
    else:
      rot[mdl.jnt_dof[j]] = kind == _JNT_HINGE
  out.update(
    dof_body_m=index(b - 1 for b in mdl.dof_body),
    fluid_body_m=index(b - 1 for b in _fluid_bodies(mdl)),
    lim_qadr=index(mdl.jnt_qadr[j] for j in lim),
    # (0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2) of a flattened 3x3
    inertia_upper=index((0, 4, 8, 1, 2, 5)),
    lim_dof=index(mdl.jnt_dof[j] for j in lim),
    rot_dof=torch.as_tensor(rot, dtype=torch.bool, device=device)[:, None],
  )
  return out


def consts_on(mdl: DeviceModel, dtype: torch.dtype,
              device: torch.device) -> Dict[str, Tensor]:
  """The model's arrays, and constants derived from them, as tensors of
  ``dtype`` (index tensors int64) on ``device``, made once per (model,
  dtype, device): made per call, each would be a host-to-device copy
  inside the step."""
  return _const_table(_ByIdentity(mdl), dtype, device)


def _consts(mdl: DeviceModel, like: Tensor) -> Dict[str, Tensor]:
  """``consts_on`` in ``like``'s dtype and device."""
  return consts_on(mdl, like.dtype, like.device)


def _masked_sum(mask: Tensor, x: Tensor) -> Tensor:
  """``out[:, i] = sum_j mask[i, j] x[:, j]`` for ``x`` ``[N, J, ...]``."""
  m = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
  return (m * x[:, None]).sum(2)


# --------------------------------------------------------------- dynamics


def _skew(x: Tensor, eye3: Tensor) -> Tensor:
  """[..., 3] -> [..., 3, 3] cross-product matrix in one launch: its column
  j is x x e_j, whose entries are x's, their negatives and products with 0
  (exact; a non-finite lane stays non-finite, as with the JAX code's
  ``0 * x``)."""
  e = eye3.view((1,) * (x.ndim - 1) + (3, 3))
  return torch.linalg.cross(x[..., None, :], e).transpose(-1, -2)


def _rotm_axis_angle(axis: Tensor, angle: Tensor, eye3: Tensor) -> Tensor:
  """Rotation matrices ``[N, 3, 3]`` about world unit axes ``[N, 3]`` by
  ``angle`` ``[N]`` (Rodrigues; ``eye3`` is the identity on their device).
  The versine is 2 sin^2(a/2): the cancellation in 1 - cos(a) loses
  precision near 0 in both dtypes."""
  s = torch.sin(angle)[:, None, None]
  sh = torch.sin(0.5 * angle)
  vers = (2.0 * sh * sh)[:, None, None]
  k = _skew(axis, eye3)
  return torch.addcmul(torch.addcmul(eye3, s, k), vers, _mm3(k, k))


def _quat2rotm(qt: Tensor, c: Dict[str, Tensor]) -> Tensor:
  """Quaternions ``[N, 4]`` (w, x, y, z) -> rotation matrices ``[N, 3, 3]``,
  normalised first as mj_kinematics' mju_normalize4 does: I + 2 (the
  products' signed sums), e.g. R_01 = 2 (xy - wz), R_00 = 1 - 2 (yy + zz).
  The sums of +-1 multiples are exact, so this is the JAX code's
  expression entry for entry."""
  qt = qt / torch.sqrt((qt * qt).sum(-1, keepdim=True))
  qq = (qt[:, :, None] * qt[:, None, :]).flatten(1)          # [N, 16]
  with no_tf32(qt.device):
    flat = torch.addmm(c["eye3"].flatten(), qq, c["quat_rot"], alpha=2.0)
  return flat.view(-1, 3, 3)


def _mv_const(A: Tensor, x: np.ndarray, xt: Tensor) -> Optional[Tensor]:
  """``A @ x`` for a constant ``x`` (``xt`` on the device): None where x is
  0, the column where it is a unit vector, else ``_mv``. Exact for the
  finite rotations it is given."""
  nz = np.flatnonzero(x)
  if not len(nz):
    return None
  if len(nz) == 1 and x[nz[0]] == 1.0:
    return A[..., nz[0]]
  return _mv(A, xt)


def fk(mdl: DeviceModel, q: Tensor,
       mut: Optional[Dict[int, Tuple[Tensor, Tensor]]] = None):
  """mj_kinematics: world pose per body + world anchor/axis per dof.

  Returns (xpos [nbody] of [N, 3], xmat [nbody] of [N, 3, 3],
  anchors {dof: [N, 3]} of rotational dofs, axes {dof: [N, 3]}). A free
  joint gives 6 dofs: 3 world-axis slides and 3 rotations about the body's
  axes through its origin (MuJoCo's cdof convention). Products
  with the model's constant frames skip what is exact without them: a
  body whose parent is the world takes its local frame as its world frame,
  an identity local rotation or a zero offset is not applied, a unit axis
  selects a column, a joint whose reference is 0 takes q as its
  displacement (the JAX code multiplies by 1 and adds 0).

  ``mut`` (optional), ``{body id: (pos [N, 3], rotm [N, 3, 3])}``,
  overrides those bodies' local frames (body_pos, body_quat) per env: the
  counterpart of tasks that set mjModel body poses per episode
  (manipulator's receptacle and target). An overridden body takes none of
  the constant frames' shortcuts but the world parent's, which is exact
  for any frame.
  """
  c = _consts(mdl, q)
  n = q.shape[0]
  xpos: List[Tensor] = [q.new_zeros(n, 3)] * mdl.nbody
  xmat: List[Tensor] = [c["eye3"].expand(n, 3, 3)] * mdl.nbody
  anchors: Dict[int, Tensor] = {}
  axes: Dict[int, Tensor] = {}
  for b in range(1, mdl.nbody):
    p = mdl.parent[b]
    if mut is not None and b in mut:
      pos, rot = mut[b]
      if p != 0:
        pos = xpos[p] + _mv(xmat[p], pos)
        rot = _mm3(xmat[p], rot)
    elif p == 0:
      pos = c["body_pos"][b].expand(n, 3)
      rot = c["body_rotm"][b].expand(n, 3, 3)
    else:
      off = _mv_const(xmat[p], mdl.body_pos[b], c["body_pos"][b])
      pos = xpos[p] if off is None else xpos[p] + off
      rot = xmat[p]
      if not np.array_equal(mdl.body_rotm[b], np.eye(3)):
        rot = _mm3(rot, c["body_rotm"][b])
    for j in mdl.body_joints[b]:
      d = mdl.jnt_dof[j]
      qa = mdl.jnt_qadr[j]
      if mdl.jnt_type[j] == _JNT_FREE:
        # the pose comes from q (body_pos is folded into qpos0); the dofs are
        # 3 world slides and 3 rotations about the body's axes through its
        # origin
        pos = q[:, qa:qa + 3]
        rot = _quat2rotm(q[:, qa + 3:qa + 7], c)
        for i in range(3):
          axes[d + i] = c["eye3"][i].expand(n, 3)
          axes[d + 3 + i] = rot[:, :, i]
          anchors[d + 3 + i] = pos
        continue
      axis_w = _mv_const(rot, mdl.jnt_axis[j], c["jnt_axis"][j])
      # displacement from the reference pose (the XML ``ref`` is in qpos0)
      qj = q[:, qa]
      if mdl.init_qpos[qa] != 0.0:
        qj = qj - c["init_qpos"][qa]
      if mdl.jnt_type[j] == _JNT_HINGE:
        jpos, jpos_t = mdl.jnt_pos[j], c["jnt_pos"][j]
        off = _mv_const(rot, jpos, jpos_t)
        anchor = pos if off is None else pos + off
        r = _rotm_axis_angle(axis_w, qj, c["eye3"])
        rot = _mm3(r, rot)
        off = _mv_const(rot, jpos, jpos_t)
        pos = anchor if off is None else anchor - off
        anchors[d] = anchor  # rotational dofs only (see _motion_subspaces)
      else:  # slide
        pos = pos + axis_w * qj[:, None]
      axes[d] = axis_w
    xpos[b] = pos
    xmat[b] = rot
  return xpos, xmat, anchors, axes


def _motion_subspaces(mdl: DeviceModel, anchors, axes) -> Tensor:
  """World-origin Plucker motion subspaces ``[N, nv, 6]``: [a; anchor x a]
  for rotational dofs, [0; a] for translational ones."""
  a = torch.stack([axes[d] for d in range(mdl.nv)], 1)
  p = torch.stack([anchors.get(d, axes[d]) for d in range(mdl.nv)], 1)
  rot = _consts(mdl, a)["rot_dof"]
  return torch.cat(
    [a * rot, torch.where(rot, torch.linalg.cross(p, a), a)], -1
  )


def _mm3(A: Tensor, B: Tensor) -> Tensor:
  """Small matmul ``[..., n, k] @ [..., k, m]`` as broadcast multiply and
  sum, the JAX code's form (on the card it needs no TF32 guard)."""
  return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _mv(A: Tensor, x: Tensor) -> Tensor:
  """[..., n, k] @ [..., k] as multiply and sum (see ``_mm3``)."""
  return (A * x[..., None, :]).sum(-1)


def _vm(x: Tensor, A: Tensor) -> Tensor:
  """[..., k] @ [..., k, m] as multiply and sum (see ``_mm3``)."""
  return (x[..., :, None] * A).sum(-2)


def _spatial_inertias(mdl: DeviceModel, xpos, xmat) -> Tensor:
  """6x6 spatial inertias ``[N, nbody - 1, 6, 6]`` of the moving bodies
  about the world origin."""
  c = _consts(mdl, xpos[0])
  pos = torch.stack(xpos[1:], 1)                            # [N, B, 3]
  rot = torch.stack(xmat[1:], 1)                            # [N, B, 3, 3]
  mass = c["mass_m"]
  com = pos + (rot * c["body_ipos"][1:, None, :]).sum(-1)
  ic = _mm3(_mm3(rot, c["body_inertia_w"][1:]), rot.transpose(-1, -2))
  cx = _skew(com, c["eye3"])
  cxt = cx.transpose(-1, -2)
  top = torch.cat([ic + mass * _mm3(cx, cxt), mass * cx], -1)
  bot = torch.cat([mass * cxt, (mass * c["eye3"]).expand_as(cx)], -1)
  return torch.cat([top, bot], -2)


def _kin_ctx(mdl: DeviceModel, q: Tensor, mut=None):
  """One forward-kinematics pass shared by all dynamics terms (``mut`` as
  ``fk``'s): (xpos, xmat, S ``[N, nv, 6]``, Is ``[N, nbody - 1, 6, 6]``)."""
  xpos, xmat, anchors, axes = fk(mdl, q, mut)
  S = _motion_subspaces(mdl, anchors, axes)
  Is = _spatial_inertias(mdl, xpos, xmat)
  return xpos, xmat, S, Is


def mass_matrix(mdl: DeviceModel, q: Tensor, ctx=None) -> Tensor:
  """CRB in world Plucker coordinates + armature (mj_crb semantics):
  M[i, j] = S_i . Ic[body(j)] S_j where body(i) is an ancestor of body(j),
  mirrored, selected by constant ancestor masks; Ic is the composite
  (subtree) inertia."""
  c = _consts(mdl, q)
  _, _, S, Is = ctx if ctx is not None else _kin_ctx(mdl, q)
  Ic = _masked_sum(c["subtree"], Is)                        # [N, B, 6, 6]
  IcS = _mv(Ic[:, c["dof_body_m"]], S)                      # [N, nv, 6]
  m_raw = _mm3(S, IcS.transpose(-1, -2))                    # [N, nv, nv]
  M = m_raw * c["mask_a"] + m_raw.transpose(-1, -2) * c["mask_b"]
  return M + c["armature_diag"]


def _cross_m(a: Tensor, b: Tensor) -> Tensor:
  """Plucker motion cross product a x_m b (``[..., 6]``)."""
  w, v = a[..., :3], a[..., 3:]
  w2, v2 = b[..., :3], b[..., 3:]
  cross = torch.linalg.cross
  return torch.cat([cross(w, w2), cross(w, v2) + cross(v, w2)], -1)


def _cross_f(a: Tensor, b: Tensor) -> Tensor:
  """Plucker force cross product a x_f b (dual of x_m)."""
  w, v = a[..., :3], a[..., 3:]
  n, f = b[..., :3], b[..., 3:]
  cross = torch.linalg.cross
  return torch.cat([cross(w, n) + cross(v, f), cross(w, f)], -1)


def body_velocities(mdl: DeviceModel, v: Tensor, S: Tensor) -> Tensor:
  """World-origin Plucker velocities ``[N, nbody - 1, 6]`` of the moving
  bodies: the sum of S_d v_d over the dofs on each body's root path."""
  return _masked_sum(_consts(mdl, v)["path"], S * v[:, :, None])


def bias_forces(mdl: DeviceModel, q: Tensor, v: Tensor, ctx=None) -> Tensor:
  """c(q, v) including gravity ``[N, nv]`` (mj_rne with flg_acc=0): a
  Newton-Euler pass with the base accelerating at -g.

  The 1-dof joints within a body form a serial chain of massless virtual
  bodies, so each dof's velocity-product term uses the velocity
  accumulated up to and including that dof (swimmer's 3-joint torso):
  acc_b = -g + sum over the dofs d on b's root path of
  vel_upto(d) x_m S_d v_d. A free joint's translations add no such term
  (their own products vanish) and its three rotations use the velocity
  before them. Then f_b = I_b acc_b + vel_b x_f I_b vel_b, summed over
  each subtree and projected on the dofs.
  """
  c = _consts(mdl, q)
  _, _, S, Is = ctx if ctx is not None else _kin_ctx(mdl, q)
  vj = S * v[:, :, None]                                    # [N, nv, 6]
  upto = _masked_sum(c["chain"], vj)                        # [N, nv, 6]
  vel = _masked_sum(c["path"], vj)                          # [N, B, 6]
  acc = c["acc0"] + _masked_sum(c["path"], _cross_m(upto, vj))
  f = _mv(Is, acc) + _cross_f(vel, _mv(Is, vel))            # [N, B, 6]
  F = _masked_sum(c["subtree"], f)
  return (S * F[:, c["dof_body_m"]]).sum(-1)


def actuator_force(mdl: DeviceModel, ctrl: Tensor) -> Tensor:
  """Clamped motor controls ``[N, nu]`` -> qfrc_actuator ``[N, nv]``
  (mj_fwdActuation): gear-scaled, force-clamped, projected through the
  constant actuator moment rows."""
  c = _consts(mdl, ctrl)
  cl = torch.clamp(ctrl, c["ctrl_range"][:, 0], c["ctrl_range"][:, 1])
  force = cl * c["act_gear"]
  force = torch.clamp(force, c["force_range"][:, 0], c["force_range"][:, 1])
  return _vm(force, c["act_trn"])


def passive_spring_force(mdl: DeviceModel, q: Tensor) -> Tensor:
  """Joint springs: -stiffness * (q - qpos_spring) (mj_passive)."""
  cols = [q.new_zeros(q.shape[0])] * mdl.nv
  for j in range(len(mdl.jnt_type)):
    d, qa = mdl.jnt_dof[j], mdl.jnt_qadr[j]
    stiff = float(mdl.jnt_stiffness[j])
    if stiff and mdl.jnt_type[j] != _JNT_FREE:
      cols[d] = -stiff * (q[:, qa] - float(mdl.qpos_spring[qa]))
  return torch.stack(cols, -1)


def _has_springs(mdl: DeviceModel) -> bool:
  return any(float(s) != 0.0 for s in mdl.jnt_stiffness)


def _tiny(dtype: torch.dtype) -> float:
  return 1e-7 if dtype == torch.float32 else 1e-14


def _psd_solver(A: Tensor, floor=None) -> Callable[[Tensor], Tensor]:
  """Factor tiny SPD systems ``A`` ``[N, n, n]`` once; the returned solve
  takes right-hand sides ``[N, n]`` or ``[N, n, k]``.

  The JAX engine's ``_solve_psd``: a column-by-column Cholesky, with closed
  forms for n = 1 and 2. Each pivot is floored at a dtype epsilon times a
  constant per-dof scale ``floor`` (for dof-space systems 1/dof_invweight0,
  the mass-matrix diagonal's magnitude): in float32 the pivots of
  ill-conditioned systems can round to <= 0, and sqrt would NaN the lane.
  The floor engages only where rounding has already destroyed the pivot,
  so float64 results do not see it; ``torch.linalg.cholesky`` has no such
  floor. The substitutions are ``torch.linalg.solve_triangular`` against
  the factor. The JAX code calls ``_solve_psd`` once per right-hand side and
  leaves the common factor to XLA; eager, the factor is made once.
  """
  n = A.shape[-1]
  tiny = _tiny(A.dtype)
  flo = np.ones(n) if floor is None else np.asarray(floor, np.float64)
  if n == 1:
    piv = torch.clamp_min(A[:, 0], tiny * float(flo[0]))   # [N, 1]

    def solve1(b):
      return b / (piv[:, :, None] if b.ndim == 3 else piv)
    return solve1
  if n == 2:
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    det = torch.clamp_min(det, tiny * float(flo[0] * flo[1]))

    def solve2(b):
      e = (slice(None),) + ((None,) if b.ndim == 3 else ())
      a00, a01, a10, a11, dt = (
        A[:, 0, 0][e], A[:, 0, 1][e], A[:, 1, 0][e], A[:, 1, 1][e], det[e]
      )
      x0 = (a11 * b[:, 0] - a01 * b[:, 1]) / dt
      x1 = (a00 * b[:, 1] - a10 * b[:, 0]) / dt
      return torch.stack([x0, x1], 1)
    return solve2
  # right-looking: each column is taken out of the remaining matrix as soon
  # as it is made (4 launches per column where the JAX code's dot products
  # with the columns made so far take 8). The entries above the diagonal
  # of each column are never read and the final ``tril`` drops them.
  cols: List[Tensor] = []
  S = A
  for j in range(n):
    piv = torch.sqrt(torch.clamp_min(S[:, j, j], tiny * float(flo[j])))
    cols.append(S[:, :, j] / piv[:, None])
    if j < n - 1:
      S = torch.addcmul(S, cols[j][:, :, None], cols[j][:, None, :], value=-1)
  L = torch.stack(cols, -1).tril()                          # [N, n, n]

  def solve(b):
    # the two triangular substitutions, one launch each
    vec = b.ndim == 2
    r = b[:, :, None] if vec else b
    y = torch.linalg.solve_triangular(L, r, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(1, 2), y, upper=True)
    return x[:, :, 0] if vec else x
  return solve


def _solve_psd(A: Tensor, b: Tensor, floor=None) -> Tensor:
  """Solve ``A x = b`` for tiny SPD ``A`` ``[N, n, n]`` (see
  ``_psd_solver``)."""
  return _psd_solver(A, floor)(b)


def _dof_floor(mdl: DeviceModel) -> np.ndarray:
  """Constant per-dof pivot-floor scale: the mass-matrix diagonal's
  magnitude, approximated by 1/dof_invweight0."""
  return 1.0 / np.maximum(np.asarray(mdl.dof_invweight0, np.float64), 1e-9)


def _impedance(c: Dict[str, Tensor], x: Tensor) -> Tensor:
  """MuJoCo constraint impedance d(x) ``[N, nlim]`` of the limit rows, x =
  |pos - margin| / width, with the endpoints clamped to [mjMINIMP,
  mjMAXIMP] = [1e-4, 0.9999] (mj_assignImpedance)."""
  x = torch.clamp(x, 0.0, 1.0)
  y = torch.where(
    x <= c["imp_mid"], c["imp_a"] * x ** c["imp_power"],
    1.0 - c["imp_b"] * (1.0 - x) ** c["imp_power"],
  )
  return c["imp_d0"] + y * (c["imp_dmax"] - c["imp_d0"])


def limit_constraint_force(mdl: DeviceModel, q: Tensor, v: Tensor, Minv,
                           qacc_smooth: Tensor) -> Tensor:
  """Joint-limit constraint forces ``[N, nv]`` per MuJoCo's soft-constraint
  model (qfrc_constraint).

  For each limited joint the nearer limit gives a row J = +-e_dof, with
  tc_eff = max(solref[0], 2 timestep) as MuJoCo clamps it:
    aref = -2 vel/(dmax tc_eff) - imp pos / (dmax^2 tc_eff^2 dr^2)
    R    = (1 - imp)/imp dof_invweight0[dof]
  and the forces solve the dual QP  min 1/2 f'(A + R)f - f'(aref - a0),
  f >= 0 (a0 = J qacc_smooth): closed form for one row and for two (the
  KKT cases, an inactive row pinned to 0), 10 sweeps of projected
  Gauss-Seidel beyond. ``Minv`` is ``[N, nv, nv]`` or {dof: column
  ``[N, nv]``} of the limited dofs.
  """
  lim = _limited(mdl)
  if not lim:
    return q.new_zeros(q.shape[0], mdl.nv)
  c = _consts(mdl, q)
  dofs = c["lim_dof"]
  if isinstance(Minv, dict):
    cols = torch.stack([Minv[mdl.jnt_dof[j]] for j in lim], -1)  # [N, nv, n]
    mll = cols[:, dofs]
  else:
    mll = Minv[:, dofs][:, :, dofs]
  ql = q[:, c["lim_qadr"]]
  dist_lo = ql - c["lim_lo"]
  dist_hi = c["lim_hi"] - ql
  use_lo = dist_lo < dist_hi
  dist = torch.where(use_lo, dist_lo, dist_hi)
  s = torch.where(use_lo, 1.0, -1.0).to(q.dtype)
  act = dist < c["lim_margin"]
  pos = dist - c["lim_margin"]
  imp = _impedance(c, torch.abs(pos) / c["lim_width"])
  aref = -c["lim_b"] * (s * v[:, dofs]) - c["lim_k"] * imp * pos
  a0 = s * qacc_smooth[:, dofs]
  rreg = (1.0 - imp) / imp * c["lim_invw"]
  b_v = (aref - a0) * act
  # A = J Minv J^T over the limited dofs, with signs, + diag(R)
  A = s[:, :, None] * s[:, None, :] * mll + torch.diag_embed(rreg)
  n = len(lim)
  if n == 1:
    f = torch.clamp_min(b_v / A[:, 0], 0.0) * act
  elif n == 2:
    a00, a01, a10, a11 = A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1]
    b0, b1 = b_v[:, 0], b_v[:, 1]
    det = a00 * a11 - a01 * a10
    fu0 = (a11 * b0 - a01 * b1) / det
    fu1 = (a00 * b1 - a10 * b0) / det
    c10 = torch.clamp_min(b0 / a00, 0.0)
    c21 = torch.clamp_min(b1 / a11, 0.0)
    ok1 = b1 - a10 * c10 <= 0
    interior = (fu0 >= 0) & (fu1 >= 0)
    k0 = torch.where(interior, fu0, torch.where(ok1, c10, 0.0))
    k1 = torch.where(interior, fu1, torch.where(ok1, 0.0, c21))
    # an inactive row's force is pinned to zero: the other solves alone
    both = act[:, 0] & act[:, 1]
    f0 = torch.where(both, k0, torch.where(act[:, 0], c10, 0.0))
    f1 = torch.where(both, k1, torch.where(act[:, 1], c21, 0.0))
    f = torch.stack([f0, f1], 1)
  else:
    # projected Gauss-Seidel, in place on a fresh f; the projection and the
    # inactive rows' pin are one clamp to [0, inf) or [0, 0]
    f = torch.zeros_like(b_v)
    lo = torch.zeros_like(b_v)
    hi = torch.where(act, float("inf"), 0.0).to(f.dtype)
    for _ in range(10):
      for i in range(n):
        resid = b_v[:, i] - (A[:, i] * f).sum(-1)
        f[:, i] = torch.clamp(torch.addcdiv(f[:, i], resid, A[:, i, i]),
                              lo[:, i], hi[:, i])
  return q.new_zeros(q.shape[0], mdl.nv).index_add(1, dofs, s * f)


def fluid_force(mdl: DeviceModel, q: Tensor, v: Tensor, ctx=None) -> Tensor:
  """Medium viscosity and density forces ``[N, nv]``, MuJoCo's inertia-box
  fluid model (``mj_inertiaBoxFluidModel``). Per body with mass, in the
  inertia frame:

    viscous:  torque -pi d^3 mu w,  force -3 pi d mu v   (d = mean box)
    density:  force_i  -1/2 rho box_j box_k |v_i| v_i
              torque_i -rho box_i (box_j^4 + box_k^4) |w_i| w_i / 64

  applied at the body CoM, mapped to qfrc through the joint subspaces.
  """
  c = _consts(mdl, q)
  xpos, xmat, S, _ = ctx if ctx is not None else _kin_ctx(mdl, q)
  fb = _fluid_bodies(mdl)
  vel = body_velocities(mdl, v, S)                          # [N, B, 6]
  if len(fb) < mdl.nbody - 1:
    vel = vel[:, c["fluid_body_m"]]
  pos = torch.stack([xpos[b] for b in fb], 1)
  rot = torch.stack([xmat[b] for b in fb], 1)
  com = pos + _mv(rot, c["fluid_ipos"])
  ximat = _mm3(rot, c["fluid_irotm"])
  w_w = vel[..., :3]
  v_w = vel[..., 3:] + torch.linalg.cross(w_w, com)  # velocity at the CoM
  lw = _vm(w_w, ximat)
  lv = _vm(v_w - c["wind"], ximat)
  ltrq = torch.zeros_like(lw)
  lfrc = torch.zeros_like(lv)
  if mdl.viscosity > 0:
    ltrq = ltrq - c["fluid_visc_t"] * lw
    lfrc = lfrc - c["fluid_visc_f"] * lv
  if mdl.density > 0:
    lfrc = lfrc - 0.5 * mdl.density * c["fluid_bj"] * torch.abs(lv) * lv
    ltrq = ltrq - mdl.density * c["fluid_bt"] * torch.abs(lw) * lw
  f_w = _mv(ximat, lfrc)
  t_w = _mv(ximat, ltrq)
  # Plucker force about the world origin: [torque + com x f; f]
  F = torch.cat([t_w + torch.linalg.cross(com, f_w), f_w], -1)   # [N, B, 6]
  per_body = (S[:, None] * F[:, :, None]).sum(-1) * c["fluid_msk"]
  return per_body.sum(1)


def _qacc_smooth_parts(mdl: DeviceModel, q: Tensor, v: Tensor, tau: Tensor,
                       mut=None):
  """(M, qfrc_smooth, ctx) from one kinematics pass (``mut`` as ``fk``'s):
  qfrc_smooth = tau + springs - damping v - bias (+ fluid)."""
  c = _consts(mdl, q)
  ctx = _kin_ctx(mdl, q, mut)
  M = mass_matrix(mdl, q, ctx)
  bias = bias_forces(mdl, q, v, ctx)
  qfrc_smooth = tau
  if _has_springs(mdl):
    qfrc_smooth = qfrc_smooth + passive_spring_force(mdl, q)
  qfrc_smooth = qfrc_smooth - c["dof_damping"] * v - bias
  if mdl.density > 0 or mdl.viscosity > 0:
    qfrc_smooth = qfrc_smooth + fluid_force(mdl, q, v, ctx)
  return M, qfrc_smooth, ctx


def _has_contact_points(mdl: DeviceModel) -> bool:
  """True when the Newton row solve is needed (contact candidates or
  tendon-limit rows); limit-only models take the closed-form path."""
  return mdl.contacts is not None and (
    mdl.contacts.point_b1.shape[0] > 0
    or mdl.contacts.ten_site_body.shape[0] > 0
  )


def _contact_solve(mdl: DeviceModel, q: Tensor, v: Tensor, M: Tensor,
                   qfrc_smooth: Tensor, ctx, warm: Optional[Tensor] = None):
  """Unified limit + contact solve -> (qacc, qfrc_constraint, efc_force).

  ``warm`` (a previous solve's qacc) is MuJoCo's qacc_warmstart: mjData
  carries it between forward calls, so each RK4 stage and each substep of
  an env-step starts from the last solve; None is the cold start from
  qacc_smooth (the first substep of an env-step). Depth is always the
  model's full Newton budget.
  """
  from . import device_collision as dc
  flo = _dof_floor(mdl)
  qacc_sm = _psd_solver(M, flo)(qfrc_smooth)
  cd = mdl.contacts
  J, aref, D, mask = dc.assemble_rows(mdl, cd, q, v, ctx)
  qacc, f = dc.newton_qacc(
    flo, M, qacc_sm, J, aref, D, mask, iters=cd.newton_iters,
    ls_iters=cd.newton_ls, start=qacc_sm if warm is None else warm,
  )
  with no_tf32(q.device):
    qfrc = torch.matmul(f[:, None], J)[:, 0]
  return qacc, qfrc, f


def _qacc_smooth(mdl: DeviceModel, q: Tensor, v: Tensor, tau: Tensor) -> Tensor:
  """Plain forward dynamics: qacc = M^-1 (tau + passive - bias)."""
  M, qfrc_smooth, _ = _qacc_smooth_parts(mdl, q, v, tau)
  return _solve_psd(M, qfrc_smooth, floor=_dof_floor(mdl))


def _minv(mdl: DeviceModel, M: Tensor) -> Tensor:
  """Explicit inverse ``[N, nv, nv]`` of the tiny mass matrix by column
  solves (no pivot floor)."""
  return _solve_psd(M, _consts(mdl, M)["eye_nv"].expand(M.shape))


def _limit_minv_cols(mdl: DeviceModel, M: Tensor) -> Dict[int, Tensor]:
  """Minv columns ``[N, nv]`` for the limited dofs only (all the constraint
  solve needs), by unfloored solves against one factor of ``M``."""
  unit = _consts(mdl, M)["lim_unit"]                        # [nv, k]
  cols = _solve_psd(M, unit.expand(M.shape[0], -1, -1))
  return {d: cols[:, :, i] for i, d in enumerate(_limit_dofs(mdl))}


def _qacc_full(mdl: DeviceModel, q: Tensor, v: Tensor, tau: Tensor,
               warm: Optional[Tensor] = None, want_fext: bool = False,
               mut=None):
  """Forward dynamics with limit and contact constraints (mj_forward).

  ``want_fext`` (contact models) also returns the per-body external
  contact wrench about the world origin (cfrc_ext's precursor) and the
  row forces: (qacc, fext ``[N, nbody, 6]``, f ``[N, m]``). ``mut`` as
  ``fk``'s.
  """
  M, qfrc_smooth, ctx = _qacc_smooth_parts(mdl, q, v, tau, mut)
  if _has_contact_points(mdl):
    qacc, _, f = _contact_solve(mdl, q, v, M, qfrc_smooth, ctx, warm)
    if want_fext:
      from . import device_collision as dc
      fext = dc.contact_wrenches(mdl.contacts, mdl, q, v, ctx, f, mdl.nbody)
      return qacc, fext, f
    return qacc
  solve = _psd_solver(M, _dof_floor(mdl))
  qacc_sm = solve(qfrc_smooth)
  if not any(mdl.jnt_limited):
    return qacc_sm
  cols = _limit_minv_cols(mdl, M)
  qfrc_con = limit_constraint_force(mdl, q, v, cols, qacc_sm)
  return qacc_sm + solve(qfrc_con)


def _has_free(mdl: DeviceModel) -> bool:
  return _JNT_FREE in mdl.jnt_type


def _quat_mul(a: Tensor, b: Tensor) -> Tensor:
  """Quaternion products ``[N, 4]`` (w, x, y, z)."""
  aw, av = a[:, :1], a[:, 1:]
  bw, bv = b[:, :1], b[:, 1:]
  return torch.cat([aw * bw - (av * bv).sum(-1, keepdim=True),
                    aw * bv + bw * av + torch.linalg.cross(av, bv)], 1)


def integrate_pos(mdl: DeviceModel, q: Tensor, v: Tensor, h: float) -> Tensor:
  """mj_integratePos: q + h v, and a free joint's quaternion by the
  exponential map of its local angular velocity (mju_quatIntegrate), then
  normalised."""
  if not _has_free(mdl):
    return q + h * v
  parts, run = [], None  # run: (qpos start, dof start, count) of 1-dof joints
  for j in range(len(mdl.jnt_type)):
    d, qa = mdl.jnt_dof[j], mdl.jnt_qadr[j]
    if mdl.jnt_type[j] != _JNT_FREE:
      if run is not None and run[0] + run[2] == qa and run[1] + run[2] == d:
        run = (run[0], run[1], run[2] + 1)
      else:
        if run is not None:
          parts.append(q[:, run[0]:run[0] + run[2]] + h * v[:, run[1]:run[1] + run[2]])
        run = (qa, d, 1)
      continue
    if run is not None:
      parts.append(q[:, run[0]:run[0] + run[2]] + h * v[:, run[1]:run[1] + run[2]])
      run = None
    w = v[:, d + 3:d + 6]
    ang = torch.sqrt((w * w).sum(-1, keepdim=True) + 1e-30) * h
    # sin(ang/2)/|w| with the |w| -> 0 limit h/2
    s = torch.where(ang > 1e-12, torch.sin(ang / 2) / (ang / h), h / 2)
    # cos(ang/2) as 1 - 2 sin^2(ang/4): accurate for the small rotations
    # that are the common case
    sq = torch.sin(ang / 4)
    rot = torch.cat([1.0 - 2.0 * sq * sq, s * w], 1)
    quat = _quat_mul(q[:, qa + 3:qa + 7], rot)
    quat = quat / torch.sqrt((quat * quat).sum(-1, keepdim=True))
    parts += [q[:, qa:qa + 3] + h * v[:, d:d + 3], quat]
  if run is not None:
    parts.append(q[:, run[0]:run[0] + run[2]] + h * v[:, run[1]:run[1] + run[2]])
  return torch.cat(parts, 1)


def _guard(mdl: DeviceModel, q: Tensor, v: Tensor, last=None, aux=None):
  """mj_step's divergence guard (mj_checkPos/Vel/Acc, mjMAXVAL = 1e10), per
  lane: a lane with a non-finite or huge q or v restarts at (qpos0, 0), as
  mj_resetData does. Without it one diverged lane NaN-saturates until its
  episode ends. A restarted lane's warm start ``last`` is zeroed, and its
  derived fields ``aux`` (q, v, fext, f of the last forward evaluation)
  hold the reset state's: (qpos0, 0) and no forces."""
  qv = torch.cat([q, v], 1)
  bad = (~torch.isfinite(qv).all(1) | (torch.abs(qv) > 1e10).any(1))[:, None]
  qpos0 = _consts(mdl, q)["init_qpos"]
  q = torch.where(bad, qpos0, q)
  v = torch.where(bad, 0.0, v)
  if last is not None:
    last = torch.where(bad, 0.0, last)
  if aux is not None:
    aq, av, fext, f = aux
    aux = (torch.where(bad, qpos0, aq), torch.where(bad, 0.0, av),
           torch.where(bad[:, :, None], 0.0, fext), torch.where(bad, 0.0, f))
  return q, v, last, aux


def step_smooth(mdl: DeviceModel, q: Tensor, v: Tensor, ctrl: Optional[Tensor],
                nstep: int = 1, want_aux: bool = False,
                tau: Optional[Tensor] = None, mut=None):
  """mj_step x nstep, per the model's integrator, each step followed by the
  divergence guard. Returns (q, v), and with ``want_aux`` (contact models)
  (q, v, (q_fwd, v_fwd, fext, f)). ``tau`` (``[N, nv]``), where given,
  is the generalised actuator force in place of ``actuator_force(ctrl)``:
  dmc point_mass mixes its controls through fixed tendons itself. ``mut``,
  ``fk``'s per-env body-pose override, holds for every forward
  evaluation.

  - Euler (``mj_Euler``): qacc solves (M + h diag(damping)) qacc =
    tau + spring(q) - damping v - c(q, v) + qfrc_constraint, the
    implicit-damping system; then v += h qacc, q += h v (semi-implicit).
  - RK4 (``mj_RungeKutta``): the classic 4-stage tableau on (q, v) with
    the full forward dynamics per stage, damping explicit.

  Contact models warm-start each solve from the one before it, as
  ``mjData.qacc_warmstart`` does (every RK4 stage, every substep), and
  start cold from qacc_smooth on the first substep of the call. ``want_aux``
  returns the state of the last forward evaluation (RK4: stage 4 of the
  last substep; Euler: the last substep's state before integration), the
  per-body contact wrench about the world origin and the row forces
  there: what mjData's derived fields hold after ``mj_step``, which
  gymnasium's Humanoid reads for its observation and mass-centre reward.

  Constants are rounded to ``q``'s dtype as the JAX code's are.
  """
  contacts = _has_contact_points(mdl)
  if want_aux and not contacts:
    raise ValueError("want_aux requires a contact model")
  npdt = np.float32 if q.dtype == torch.float32 else np.float64
  h = npdt(mdl.timestep)
  half, h6 = float(npdt(0.5) * h), float(h / npdt(6.0))
  tau = actuator_force(mdl, ctrl) if tau is None else tau.to(q.dtype)

  def one_step(q, v, warm, aux_here):
    aux = None
    if mdl.integrator == 1:  # RK4
      a1 = _qacc_full(mdl, q, v, tau, warm, mut=mut)
      q2, v2 = integrate_pos(mdl, q, v, half), v + half * a1
      a2 = _qacc_full(mdl, q2, v2, tau, a1 if contacts else None, mut=mut)
      q3, v3 = integrate_pos(mdl, q, v2, half), v + half * a2
      a3 = _qacc_full(mdl, q3, v3, tau, a2 if contacts else None, mut=mut)
      q4, v4 = integrate_pos(mdl, q, v3, float(h)), v + float(h) * a3
      if aux_here:
        a4, fext, f4 = _qacc_full(mdl, q4, v4, tau, a3, want_fext=True,
                                  mut=mut)
        aux = (q4, v4, fext, f4)
      else:
        a4 = _qacc_full(mdl, q4, v4, tau, a3 if contacts else None, mut=mut)
      q = integrate_pos(mdl, q, (v + 2 * v2 + 2 * v3 + v4) / 6.0, float(h))
      v = v + h6 * (a1 + 2 * a2 + 2 * a3 + a4)
      last = a4 if contacts else None
    else:  # Euler with implicit damping
      M, qfrc, ctx = _qacc_smooth_parts(mdl, q, v, tau, mut)
      flo = _dof_floor(mdl)
      last = None
      if contacts:
        last, qfrc_con, f = _contact_solve(mdl, q, v, M, qfrc, ctx, warm)
        if aux_here:
          from . import device_collision as dc
          aux = (q, v, dc.contact_wrenches(mdl.contacts, mdl, q, v, ctx, f,
                                           mdl.nbody), f)
        qfrc = qfrc + qfrc_con
      elif any(mdl.jnt_limited):
        qacc_sm = _solve_psd(M, qfrc, floor=flo)
        qfrc = qfrc + limit_constraint_force(
          mdl, q, v, _limit_minv_cols(mdl, M), qacc_sm
        )
      A = M + float(h) * _consts(mdl, q)["damping_diag"]
      qacc = _solve_psd(A, qfrc, floor=flo)
      v = v + float(h) * qacc
      q = integrate_pos(mdl, q, v, float(h))
    return _guard(mdl, q, v, last, aux)

  # the warm-start chain: cold (None) on the first substep, then each
  # substep from the last solve; only the last substep's aux is kept. The
  # substeps between the first and the last run as one loop: a WHILE node of
  # the graph under capture (dmc cheetah settles 200 substeps in its reset)
  q, v, warm, aux = one_step(q, v, None, want_aux and nstep == 1)

  def middle(c):
    q, v, warm, _ = one_step(c[0], c[1], c[2] if contacts else None, False)
    return (q, v, warm) if contacts else (q, v)

  if nstep > 2:
    c = graph.fori_loop(nstep - 2, middle, (q, v, warm) if contacts else (q, v))
    q, v, warm = c[0], c[1], c[2] if contacts else None
  if nstep > 1:
    q, v, warm, aux = one_step(q, v, warm, want_aux)
  if want_aux:
    return q, v, aux
  return q, v


# --------------------------------------------------------------- readouts


def body_xpos(mdl: DeviceModel, q: Tensor, name: str) -> Tensor:
  """World position ``[N, 3]`` of a named body's frame origin."""
  xpos, _, _, _ = fk(mdl, q)
  return xpos[mdl.body_name2id[name]]


def body_xmat(mdl: DeviceModel, q: Tensor, name: str) -> Tensor:
  """World rotation matrix ``[N, 3, 3]`` of a named body (data.xmat)."""
  _, xmat, _, _ = fk(mdl, q)
  return xmat[mdl.body_name2id[name]]


def geom_xpos(mdl: DeviceModel, q: Tensor, name: str) -> Tensor:
  """World position ``[N, 3]`` of a named geom (data.geom_xpos)."""
  xpos, xmat, _, _ = fk(mdl, q)
  g = mdl.geom_name2id[name]
  b = mdl.geom_body[g]
  return xpos[b] + _mv(xmat[b], _consts(mdl, q)["geom_pos"][g])


def subtree_linvel(mdl: DeviceModel, q: Tensor, v: Tensor, name: str) -> Tensor:
  """mj_subtreeVel's subtree COM linear velocity ``[N, 3]`` of a named body
  (the ``subtreelinvel`` sensor dmc locomotion rewards read)."""
  return subtree_linvel_at(mdl, fk(mdl, q), v, name)


def subtree_linvel_at(mdl: DeviceModel, kin, v: Tensor, name: str) -> Tensor:
  """``subtree_linvel`` from a kinematics pass ``kin`` (``fk``'s outputs)
  the caller already made: the mass-weighted mean of the COM velocities of
  the subtree's bodies with mass, as one masked sum over them."""
  xpos, xmat, anchors, axes = kin
  vel = body_velocities(mdl, v, _motion_subspaces(mdl, anchors, axes))
  bodies, idx, ipos, mass, inv_msum = _subtree_table(
    _ByIdentity(mdl), name, v.dtype, v.device)
  vel = vel.index_select(1, idx)                            # [N, k, 6]
  pos = torch.stack([xpos[b] for b in bodies], 1)
  rot = torch.stack([xmat[b] for b in bodies], 1)
  com = pos + _mv(rot, ipos)
  lin = vel[..., 3:] + torch.linalg.cross(vel[..., :3], com)
  return (mass * lin).sum(1) * inv_msum


@functools.lru_cache(maxsize=64)
def _subtree_table(key: _ByIdentity, name: str, dtype: torch.dtype,
                   device: torch.device):
  """``subtree_linvel``'s constants: the subtree's bodies with mass, their
  rows of the moving-body passes, COM offsets and masses ``[k, 1]`` on the
  device, and the reciprocal of their total mass in ``dtype`` (XLA
  multiplies by it where the JAX code divides; see ``prng.inv32``)."""
  mdl = key.mdl
  root = mdl.body_name2id[name]
  bodies = [b for b in range(1, mdl.nbody)
            if mdl.ancestor[root][b] and float(mdl.body_mass[b]) != 0.0]
  msum = sum(float(mdl.body_mass[b]) for b in bodies)
  inv = (float(np.float32(1.0) / np.float32(msum)) if dtype == torch.float32
         else 1.0 / msum)
  return (bodies, torch.as_tensor([b - 1 for b in bodies], device=device),
          torch.as_tensor(mdl.body_ipos[bodies], dtype=dtype, device=device),
          torch.as_tensor(mdl.body_mass[bodies][:, None], dtype=dtype,
                          device=device), inv)


def site_xpos(mdl: DeviceModel, q: Tensor, name: str) -> Tensor:
  """World position ``[N, 3]`` of a named site."""
  xpos, xmat, _, _ = fk(mdl, q)
  s = mdl.site_name2id[name]
  b = mdl.site_body[s]
  return xpos[b] + _mv(xmat[b], _consts(mdl, q)["site_pos"][s])


def body_xipos(mdl: DeviceModel, q: Tensor, name: str) -> Tensor:
  """World position ``[N, 3]`` of a named body's centre of mass
  (data.xipos)."""
  xpos, xmat, _, _ = fk(mdl, q)
  b = mdl.body_name2id[name]
  return xpos[b] + _mv(xmat[b], _consts(mdl, q)["body_ipos"][b])


def com_quantities(mdl: DeviceModel, q: Tensor, v: Tensor, ctx=None):
  """mjData's com-based quantities at (q, v): (com0 ``[N, 3]``, xipos
  ``[N, nbody, 3]``, cinert ``[N, nbody, 10]``, cvel ``[N, nbody, 6]``).

  - ``com0`` = subtree_com[0], the mass-weighted mean of the bodies' CoMs;
  - ``cinert[b]`` = the upper triangle of the inertia about com0 in world
    axes by the parallel-axis theorem (Ixx, Iyy, Izz, Ixy, Ixz, Iyz), then
    m (xipos - com0), then m;
  - ``cvel[b]`` = [omega; v_origin + omega x com0], the world-origin
    Plucker velocity translated to com0.
  """
  c = _consts(mdl, q)
  xpos, xmat, S, _ = ctx if ctx is not None else _kin_ctx(mdl, q)
  pos = torch.stack(xpos, 1)                                # [N, nbody, 3]
  rot = torch.stack(xmat, 1)
  xipos = pos + _mv(rot, c["body_ipos"])
  mass = c["body_mass"]
  com0 = (mass[:, None] * xipos).sum(1) / mass.sum()
  ic = _mm3(_mm3(rot, c["body_inertia_w"]), rot.transpose(-1, -2))
  d = xipos - com0[:, None]
  dd = d[..., :, None] * d[..., None, :]
  mb = mass[:, None, None]
  ioff = ic + mb * ((d * d).sum(-1)[..., None, None] * c["eye3"] - dd)
  cinert = torch.cat([
    ioff.flatten(-2)[..., c["inertia_upper"]], mass[:, None] * d,
    mass.expand(q.shape[0], -1)[..., None],
  ], -1)
  vel = body_velocities(mdl, v, S)                          # moving bodies
  vel = torch.cat([vel.new_zeros(q.shape[0], 1, 6), vel], 1)
  w = vel[..., :3]
  cvel = torch.cat([w, vel[..., 3:] + torch.linalg.cross(w, com0[:, None].expand_as(w))], -1)
  return com0, xipos, cinert, cvel
