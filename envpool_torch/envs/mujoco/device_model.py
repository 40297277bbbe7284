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

The port has the engine's smooth dynamics and joint limits; contacts and
free joints come with a later slice. The extractor therefore records only
whether a model has contact rows (candidate geom pairs or limited tendons,
``contacts``), and ``check_supported`` refuses such models and free joints.
``models/refused.json`` lists the gym device models the writer refused,
with the reason.
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

MODELS_DIR = Path(__file__).resolve().parent / "models"

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
  # None when the model has no contact rows (the JAX package's contacts is
  # None then); else (candidate geom pairs, limited tendons), whose tables
  # the port does not have yet
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


def _contact_rows(m) -> Optional[Tuple[int, int]]:
  """(candidate geom pairs, limited tendons) under ``mj_collision``'s
  filters, as ``envpool_tpu/envs/mujoco/device_collision.py::
  extract_contacts`` admits them (every admitted pair gives at least one
  contact point there), or None when both are 0."""
  excluded = set()
  for e in range(m.nexclude):
    sig = int(m.exclude_signature[e])
    ba, bb = sig >> 16, sig & 0xFFFF
    excluded.add((min(ba, bb), max(ba, bb)))
  plane = 0  # mjGEOM_PLANE
  pairs = 0
  for g1 in range(m.ngeom):
    for g2 in range(g1 + 1, m.ngeom):
      b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
      if b1 == b2 or (min(b1, b2), max(b1, b2)) in excluded:
        continue
      if (int(m.body_parentid[b2]) == b1 and b1 != 0) or (
        int(m.body_parentid[b1]) == b2 and b2 != 0
      ):
        continue
      t1, t2 = int(m.geom_contype[g1]), int(m.geom_contype[g2])
      a1, a2 = int(m.geom_conaffinity[g1]), int(m.geom_conaffinity[g2])
      if not ((t1 & a2) or (t2 & a1)):
        continue
      if int(m.geom_type[g1]) == plane and int(m.geom_type[g2]) == plane:
        continue
      pairs += 1
  tendons = int(np.count_nonzero(np.asarray(m.tendon_limited)))
  return (pairs, tendons) if pairs or tendons else None


def extract_model(xml_path: str) -> DeviceModel:
  """Pull the constants the engine needs out of a host-side mjModel."""
  import mujoco
  return _extract_model(mujoco.MjModel.from_xml_path(xml_path))


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
    contacts=_contact_rows(m),
  )


def check_supported(mdl: DeviceModel) -> None:
  """Refuse what the port's engine does not have yet."""
  if mdl.contacts is not None:
    raise NotImplementedError("contacts: not yet ported")
  if _JNT_FREE in mdl.jnt_type:
    raise NotImplementedError("free joints: not yet ported")


# ------------------------------------------------------------ data files


def _to_json(value: Any) -> Any:
  if isinstance(value, tuple):
    return [_to_json(v) for v in value]
  return value


def save_model(mdl: DeviceModel, path: Path) -> None:
  """One ``.npz``: the array fields, and the rest as a JSON string (name
  tables as ``[name, id]`` pairs, since a name may be None)."""
  meta, arrays = {}, {}
  for name, value in mdl._asdict().items():
    if isinstance(value, np.ndarray):
      arrays[name] = value
    elif name in _NAME_FIELDS:
      meta[name] = [[k, v] for k, v in value.items()]
    else:
      meta[name] = _to_json(value)
  with open(path, "wb") as f:
    np.savez_compressed(f, meta=np.array(json.dumps(meta)), **arrays)


def _from_json(name: str, value: Any) -> Any:
  if name in _NAME_FIELDS:
    return {k: v for k, v in value}
  if name == "contacts":
    return None if value is None else tuple(value)
  if isinstance(value, list):
    return tuple(tuple(v) if isinstance(v, list) else v for v in value)
  return value


def read_model(path: Path) -> DeviceModel:
  """A model written by ``save_model`` (numpy only)."""
  with np.load(path, allow_pickle=False) as data:
    meta = json.loads(str(data["meta"]))
    fields = {k: _from_json(k, v) for k, v in meta.items()}
    fields.update({k: np.array(data[k]) for k in data.files if k != "meta"})
  return DeviceModel(**fields)


def refused_models() -> Dict[str, str]:
  """Gym device models the writer refused: xml name -> reason."""
  with open(MODELS_DIR / "refused.json") as f:
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


def gym_asset(xml_name: str) -> str:
  """Path of a gymnasium MuJoCo asset (where gymnasium is installed)."""
  import gymnasium
  return os.path.join(
    os.path.dirname(gymnasium.__file__), "envs", "mujoco", "assets", xml_name
  )


def write_models(out_dir: Path = MODELS_DIR) -> Dict[str, str]:
  """Extract every gym device model from gymnasium's assets: the supported
  ones to ``<stem>.npz``, the others to ``refused.json``."""
  out_dir.mkdir(parents=True, exist_ok=True)
  refused = {}
  for xml_name in GYM_DEVICE_XMLS:
    mdl = extract_model(gym_asset(xml_name))
    try:
      check_supported(mdl)
    except NotImplementedError as err:
      refused[xml_name] = str(err)
      continue
    save_model(mdl, out_dir / (Path(xml_name).stem + ".npz"))
  with open(out_dir / "refused.json", "w") as f:
    json.dump(refused, f, indent=1, sort_keys=True)
    f.write("\n")
  return refused


def main(argv: Sequence[str] = ()) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--write", action="store_true",
                      help="regenerate models/ from gymnasium's assets")
  args = parser.parse_args(list(argv))
  if not args.write:
    parser.print_help()
    return 2
  refused = write_models()
  print(f"wrote {len(GYM_DEVICE_XMLS) - len(refused)} models to {MODELS_DIR}; "
        f"refused {sorted(refused)}")
  return 0


if __name__ == "__main__":
  import sys
  sys.exit(main(sys.argv[1:]))
