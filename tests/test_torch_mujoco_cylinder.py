"""The port's cylinder narrow phase and Pusher's rows (float64, CPU) against
the JAX functions under x64 and against MuJoCo.

Every case runs a batch of lanes at once, and lane i is held to the
reference's result for state i:

- a probe model (a free cylinder, capsule and sphere over a plane: the
  plane-cylinder, capsule-cylinder, sphere-cylinder, plane-capsule,
  plane-sphere and capsule-sphere pairs) on seeded poses that cover the
  cylinder's face, edge and side regimes, its axis exactly normal to the
  plane (the flat fallback of the radial direction), and the capsule's
  and sphere's search point inside and outside the solid cylinder:
  ``contact_points`` against the JAX function row by row to 1e-12 of the
  JAX scale, in the JAX order. One exception, stated: a
  sphere/capsule-cylinder candidate is the argmin of the cylinder's signed
  distance along the capsule axis, found by a 48-step golden-section
  search; near a smooth minimum the two probes tie to rounding, so its
  position (and frame) is determined only to ~sqrt(eps); those are held
  to ``MID_TOL``, their distances with the rest. The face-rim gate
  (``slen < -prjf``, a comparison of two float expressions) is held equal
  on every lane but those within ``GATE_EPS`` of the boundary, which are
  counted and bounded by ``GATE_LANES``;
- Pusher's ``assemble_rows`` against the JAX function row by row (the
  capsule-cylinder rows' J and aref to ``MID_TOL``), and its active rows
  against ``mjData.efc_J/aref/D`` sorted, to 1e-6 (the JAX package's own
  bound, ``tests/test_device_pusher.py``), on arm-random states;
- Pusher's 100-step rollout (500 substeps) against ``mj_step`` to 1e-10,
  the arm moving and the finger clear of the object (the twin of
  ``test_pusher_rollout_parity_no_finger_contact``);
- the committed Pusher data loads, equal to the JAX extraction, and no
  model is refused.
"""

import functools

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")
pytest.importorskip("gymnasium")

import jax  # noqa: E402

from envpool_torch.envs.mujoco import device_collision as pc  # noqa: E402
from envpool_torch.envs.mujoco import device_engine as pe  # noqa: E402
from envpool_torch.envs.mujoco import device_model as dm  # noqa: E402
from envpool_tpu.envs.mujoco import device_collision as jc  # noqa: E402
from envpool_tpu.envs.mujoco import device_engine as je  # noqa: E402
from test_device_contacts import _sorted_rows  # noqa: E402
from test_torch_mujoco_model import _assert_models_equal  # noqa: E402

torch.set_num_threads(1)

LANES = 64
MID_TOL = 1e-6
GATE_EPS = 1e-12
GATE_LANES = 1
JIT_OPTIONS = {"xla_backend_optimization_level": 0}

PROBE_XML = """
<mujoco>
  <option cone="pyramidal"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1" condim="1"/>
    <body name="cyl" pos="0 0 0.2"><freejoint/>
      <geom name="c" type="cylinder" size="0.05 0.04" condim="1"/>
    </body>
    <body name="cap" pos="0.2 0 0.2"><freejoint/>
      <geom name="k" type="capsule" size="0.02 0.04" condim="3"/>
    </body>
    <body name="ball" pos="-0.2 0 0.2"><freejoint/>
      <geom name="s" type="sphere" size="0.03" condim="1"/>
    </body>
  </worldbody>
</mujoco>
"""


def _t(x):
  return torch.from_numpy(np.ascontiguousarray(x, np.float64))


def _unit(x):
  return x / np.linalg.norm(x, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _probe():
  return dm.extract_model_string(PROBE_XML)


def _probe_states(seed):
  """Cylinder poses: a quarter upright (identity, the exactly-flat
  fallback), a quarter tilted below 45 degrees (face resting), a quarter
  near 45 degrees, a quarter at any tilt; heights from penetrating to
  clear. Capsule and sphere at random orientations within reach of the
  cylinder, some centres inside it."""
  rng = np.random.default_rng(seed)
  q = np.zeros((LANES, 21))
  q[:, 0:2] = rng.uniform(-0.05, 0.05, (LANES, 2))
  q[:, 2] = rng.uniform(0.0, 0.1, LANES)
  k = LANES // 4
  tilt = np.concatenate([np.zeros(k), rng.uniform(0.05, 0.7, k),
                         np.pi / 4 + rng.uniform(-0.02, 0.02, k),
                         rng.uniform(0.0, np.pi, LANES - 3 * k)])
  axis = _unit(np.concatenate([rng.normal(size=(LANES, 2)),
                               np.zeros((LANES, 1))], 1))
  q[:, 3] = np.cos(tilt / 2)
  q[:, 4:7] = np.sin(tilt / 2)[:, None] * axis
  for start in (7, 14):
    q[:, start:start + 3] = q[:, 0:3] + rng.uniform(-0.09, 0.09, (LANES, 3))
    q[:, start + 3:start + 7] = _unit(rng.normal(size=(LANES, 4)))
  return q


def _jax_points(mdl):
  def points(q):
    xpos, xmat, _, _ = je.fk(mdl, q)
    return jc.contact_points(mdl.contacts, xpos, xmat, q.dtype)
  return jax.jit(jax.vmap(points), compiler_options=JIT_OPTIONS)


def _cyl_points(cd):
  """Point indices of the sphere/capsule-cylinder candidates, and of the
  plane-cylinder candidates."""
  start = sum(2 if t else 1 for t in cd.pc_two) + len(cd.cc_g1)
  end = start + 4 * len(cd.pcy_plane)
  return np.arange(end, end + len(cd.cyc_cap)), np.arange(start, end)


def _point_rows(cd, points):
  """Row indices of ``assemble_rows`` made from the given points."""
  sel = set(np.asarray(points).tolist())
  one = np.where(cd.point_condim == 1)[0]
  pyr = np.where(cd.point_condim == 3)[0]
  rowpt = np.concatenate([one, np.repeat(pyr, 4)])
  L = len(cd.lim_dof) + cd.ten_site_body.shape[0]
  return np.asarray([L + i for i, p in enumerate(rowpt) if p in sel], np.int64)


def _close(got, want, exempt, tag):
  """``got`` to 1e-12 of the JAX scale per lane, the ``exempt`` indices of
  axis 1 to ``MID_TOL``."""
  keep = np.ones(want.shape[1], bool)
  keep[exempt] = False
  scale = np.maximum(1.0, np.abs(want).reshape(len(want), -1).max(1))
  for sel, tol in ((keep, 1e-12), (~keep, MID_TOL)):
    g, w = np.compress(sel, got, 1), np.compress(sel, want, 1)
    if g.size:
      err = np.abs(g - w).reshape(len(w), -1).max(1)
      assert (err <= tol * scale).all(), (tag, tol, (err / scale).max())


def test_cylinder_points_match_jax_row_by_row():
  mdl = _probe()
  cd = mdl.contacts
  assert (len(cd.pcy_plane), len(cd.cyc_cap), len(cd.pc_plane),
          len(cd.cc_g1)) == (1, 2, 2, 1)
  q = _probe_states(0)
  with jax.enable_x64(True):
    want = [np.asarray(x) for x in _jax_points(mdl)(q)]
  xpos, xmat, _, _ = pe.fk(mdl, _t(q))
  got = [x.numpy() for x in pc.contact_points(mdl, xpos, xmat)]
  cyc, pcy = _cyl_points(cd)
  for tag, g, w in zip(("pos", "dist", "n", "t1", "t2"), got, want):
    _close(g, w, [] if tag == "dist" else cyc, tag)
  # the face-rim gate: equal but on lanes at its boundary, which are
  # counted (the gate is slen < -prjf: sin and cos of the tilt)
  axis_z = np.abs(1 - 2 * (q[:, 4] ** 2 + q[:, 5] ** 2))
  edge = np.abs(np.sqrt(np.maximum(1 - axis_z ** 2, 0)) - axis_z) < GATE_EPS
  differ = (got[5] != want[5]).any(1)
  assert not (differ & ~edge).any(), np.where(differ)
  assert differ.sum() <= GATE_LANES
  face = want[5][:, pcy[1]]
  assert face.any() and not face.all()  # below and above 45 degrees
  # the regimes were visited: the flat fallback (upright lanes), a face
  # rim within reach of the plane, the search point inside and outside
  upright = np.arange(LANES // 4)
  assert (axis_z[upright] == 1).all()
  assert (want[1][:, pcy[1:3]] < 0).any()
  assert (want[1][:, cyc] < -0.02).any() and (want[1][:, cyc] > 0).any()


@functools.lru_cache(maxsize=None)
def _pusher():
  return dm.load_model("pusher.xml")


def _pusher_states(seed, lanes, near_object):
  """Arm-random states (``test_device_pusher.py``' draw); ``near_object``:
  arm poses whose finger capsule reaches the table (geom 13 as low as the
  object), the object cylinder dropped 0.03-0.09 from the capsule's
  centre, so that some of them touch or interpenetrate."""
  mdl = _pusher()
  rng = np.random.default_rng(seed)
  if not near_object:
    q = mdl.init_qpos + rng.uniform(-0.3, 0.3, (lanes, mdl.nq))
    q[:, -2:] = 0.0
    return q, rng.uniform(-1, 1, (lanes, mdl.nv))
  q = np.zeros((4096, mdl.nq))
  q[:, :7] = rng.uniform(mdl.jnt_range[:7, 0], mdl.jnt_range[:7, 1], (4096, 7))
  xpos, xmat, _, _ = pe.fk(mdl, _t(q))
  pos = {g: (xpos[mdl.geom_body[g]] + pe._mv(
    xmat[mdl.geom_body[g]], _t(mdl.geom_pos[g]))).numpy() for g in (13, 19)}
  low = np.where((pos[13][:, 2] > -0.30) & (pos[13][:, 2] < -0.24))[0][:lanes]
  assert len(low) == lanes
  q = q[low]
  ang = rng.uniform(0, 2 * np.pi, lanes)
  dist = rng.uniform(0.03, 0.09, lanes)
  target = pos[13][low, :2] + dist[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)
  # the object's slide joints: qpos[-4] moves it along y, qpos[-3] along x
  q[:, -3] = target[:, 0] - pos[19][low, 0]
  q[:, -4] = target[:, 1] - pos[19][low, 1]
  return q, rng.uniform(-1, 1, (lanes, mdl.nv))


def test_pusher_rows_match_jax_row_by_row():
  mdl = _pusher()
  cd = mdl.contacts
  q, v = _pusher_states(2, LANES, near_object=True)

  def rows(q, v):
    return jc.assemble_rows(mdl, cd, q, v, je._kin_ctx(mdl, q))
  with jax.enable_x64(True):
    want = [np.asarray(x) for x in jax.jit(
      jax.vmap(rows), compiler_options=JIT_OPTIONS)(q, v)]
  got = [x.numpy() for x in pc.assemble_rows(mdl, cd, _t(q), _t(v),
                                             pe._kin_ctx(mdl, _t(q)))]
  assert got[0].shape == want[0].shape == (LANES, cd.nrows, mdl.nv)
  cyc, _ = _cyl_points(cd)
  for tag, g, w in zip(("J", "aref", "D"), got, want):
    _close(g, w, [] if tag == "D" else _point_rows(cd, cyc), tag)
  np.testing.assert_array_equal(got[3], want[3])
  assert want[3][:, _point_rows(cd, cyc)].any()  # the finger meets the object


def test_pusher_rows_match_efc():
  """The active rows of each lane == mjData.efc's rows (sorted) to 1e-6 of
  their scale: plane-capsule, plane-cylinder, joint limits."""
  mdl = _pusher()
  m = mujoco.MjModel.from_xml_path(dm.gym_asset("pusher.xml"))
  m.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_WARMSTART
  q, v = _pusher_states(1, 40, near_object=False)
  J, aref, D, mask = (x.numpy() for x in pc.assemble_rows(
    mdl, mdl.contacts, _t(q), _t(v), pe._kin_ctx(mdl, _t(q))))
  rows = 0
  for i in range(len(q)):
    d = mujoco.MjData(m)
    d.qpos[:], d.qvel[:] = q[i], v[i]
    mujoco.mj_forward(m, d)
    act = np.where(mask[i])[0]
    assert len(act) == d.nefc, i
    rows += d.nefc
    if not d.nefc:
      continue
    ours = _sorted_rows(J[i, act], aref[i, act], D[i, act])
    ref = _sorted_rows(d.efc_J[:d.nefc * m.nv].reshape(d.nefc, m.nv),
                       d.efc_aref[:d.nefc], d.efc_D[:d.nefc])
    for o, r in zip(ours, ref):
      assert np.abs(o - r).max() < 1e-6 * max(1.0, np.abs(r).max()), i
  assert rows > len(q)


def test_pusher_rollout_matches_mj_step():
  """100 control steps (500 substeps) from qpos0 with a moving arm, to
  1e-10: plane contacts and limits only, the finger clear of the object."""
  mdl = _pusher()
  m = mujoco.MjModel.from_xml_path(dm.gym_asset("pusher.xml"))
  d = mujoco.MjData(m)
  rng = np.random.default_rng(0)
  q0 = m.qpos0.copy()
  q0[-4], q0[-3] = -0.2, 0.1
  v0 = rng.uniform(-0.005, 0.005, m.nv)
  v0[-4:] = 0
  d.qpos[:], d.qvel[:] = q0, v0
  q, v = _t(q0[None]), _t(v0[None])
  for t in range(100):
    u = 0.4 * np.sin(0.05 * t + np.arange(7))
    d.ctrl[:] = u
    for _ in range(5):
      mujoco.mj_step(m, d)
    q, v = pe.step_smooth(mdl, q, v, _t(u[None]), nstep=5)
  np.testing.assert_allclose(q[0].numpy(), d.qpos, rtol=0, atol=1e-10)
  np.testing.assert_allclose(v[0].numpy(), d.qvel, rtol=0, atol=1e-10)


def test_pusher_loads_and_equals_jax_extraction():
  assert dm.refused_models() == {} and dm.refused_models(dm.DMC_MODELS_DIR) == {}
  got = dm.load_model("pusher.xml")
  _assert_models_equal(got, je.extract_model(dm.gym_asset("pusher.xml")),
                       "pusher")
  cd = got.contacts
  assert (len(cd.pcy_plane), len(cd.cyc_cap), cd.point_b1.shape[0],
          cd.nrows) == (1, 3, 13, 24)
