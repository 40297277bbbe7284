"""The port's box narrow phase, tendon rows and dm_control readouts
(float64, CPU) against the JAX functions under x64 and against MuJoCo:
cartpole three_poles (sphere/capsule-box, capsule-capsule), ball_in_cup
(the string's limited tendon row, sphere-capsule) and humanoid (plane-box
and sphere/capsule-box, 352 rows).

Every case runs a batch of lanes at once, and lane i is held to the
reference's result for state i:

- ``contact_points`` and ``assemble_rows`` against the JAX functions row
  by row in the JAX order, to 1e-12 of the JAX function's scale. One
  exception, stated: a capsule-box pair's mid-segment candidate is the
  argmin of the box's signed distance along the axis, found by a
  48-step golden-section search; near a smooth minimum the two probes'
  distances tie to rounding, so the point it lands on is determined only
  to ~sqrt(eps) of the segment (the last bits of the kinematics, which
  the two packages sum in different orders, decide the late comparisons).
  Its distance is second order in that and is held with the rest; its
  position, frame and rows (J, aref) are held to ``MID_TOL``;
- the active rows against ``mjData.efc_J/aref/D``, sorted as
  ``tests/test_device_contacts.py`` sorts them, to 1e-9 of their scale, on
  states where MuJoCo's own capsule-box collider (which the JAX package
  replaces by the candidate set above) has no active pair;
- a 60-substep warm-start chain of ball_in_cup against ``mj_step``, the
  string taut;
- ``subtree_linvel`` (also from a kinematics pass the caller made) and
  ``geom_xpos`` against the JAX functions;
- ``tolerance`` against the JAX function for every sigmoid, on a grid that
  includes the bounds, the margin and margin 0.
"""

import functools

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

import jax  # noqa: E402

from envpool_torch.envs.mujoco import device_collision as pc  # noqa: E402
from envpool_torch.envs.mujoco import device_engine as pe  # noqa: E402
from envpool_torch.envs.mujoco import device_model as dm  # noqa: E402
from envpool_torch.envs.mujoco.dmc import device_rewards as pr  # noqa: E402
from envpool_torch.envs.mujoco.dmc.assets import DMC_XMLS  # noqa: E402
from envpool_torch.envs.mujoco.dmc import rewards  # noqa: E402
from envpool_tpu.envs.mujoco import device_collision as jc  # noqa: E402
from envpool_tpu.envs.mujoco import device_engine as je  # noqa: E402
from envpool_tpu.envs.mujoco.dmc import device_rewards as jr  # noqa: E402
from test_device_contacts import _sorted_rows  # noqa: E402

torch.set_num_threads(1)

MODELS = ["cartpole_three_poles", "ball_in_cup", "humanoid"]
LANES = 8
MID_TOL = 1e-6
JIT_OPTIONS = {"xla_backend_optimization_level": 0}


def _t(x):
  return torch.from_numpy(np.ascontiguousarray(x, np.float64))


def _states(name, seed, near_rest=False, lanes=LANES):
  """Seeded states that touch: humanoid low over the floor with its limbs
  crossed (``near_rest``: standing, feet just touching), the cup's ball
  low on its string, cartpole's poles crossed."""
  mdl = dm.load_dmc_model(name)
  rng = np.random.default_rng(seed)
  q = np.tile(mdl.init_qpos, (lanes, 1))
  if name == "humanoid":
    if near_rest:
      q[:, 2] = rng.uniform(1.24, 1.3, lanes)
      q[:, 7:] += rng.uniform(-0.08, 0.08, (lanes, mdl.nq - 7))
    else:
      q[:, 2] = rng.uniform(0.0, 1.4, lanes)
      quat = rng.normal(size=(lanes, 4))
      q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
      q[:, 7:] += rng.uniform(-1.5, 1.5, (lanes, mdl.nq - 7))
  elif name == "ball_in_cup":
    q += rng.uniform(-0.4, 0.4, q.shape)
    q[:, 3] -= rng.uniform(0.0, 0.6, lanes)
  else:
    q += rng.uniform(-2.5, 2.5, q.shape)
  v = rng.uniform(-1, 1, (lanes, mdl.nv))
  u = rng.uniform(-1, 1, (lanes, len(mdl.act_dof)))
  return mdl, q, v, u


def _mid_points(cd):
  """Point indices of the capsule-box pairs' mid-segment candidates."""
  start = (sum(2 if t else 1 for t in cd.pc_two) + len(cd.cc_g1)
           + 4 * len(cd.pcy_plane) + len(cd.cyc_cap) + 8 * len(cd.pb_plane))
  out, p = [], start
  for three in cd.sb_three:
    if three:
      out.append(p + 2)
    p += 3 if three else 1
  return np.asarray(out, np.int64)


def _mid_rows(cd):
  """Row indices of ``assemble_rows`` made from the mid-segment points."""
  mids = set(_mid_points(cd).tolist())
  one = np.where(cd.point_condim == 1)[0]
  pyr = np.where(cd.point_condim == 3)[0]
  rowpt = np.concatenate([one, np.repeat(pyr, 4)])
  L = len(cd.lim_dof) + cd.ten_site_body.shape[0]
  return np.asarray([L + i for i, p in enumerate(rowpt) if p in mids], np.int64)


@functools.lru_cache(maxsize=None)
def _jax_fns(name):
  """jit(vmap) of the JAX narrow phase and rows under x64."""
  mdl = dm.load_dmc_model(name)

  def points(q):
    xpos, xmat, _, _ = je.fk(mdl, q)
    return jc.contact_points(mdl.contacts, xpos, xmat, q.dtype)

  def rows(q, v):
    return jc.assemble_rows(mdl, mdl.contacts, q, v, je._kin_ctx(mdl, q))
  return (jax.jit(jax.vmap(points), compiler_options=JIT_OPTIONS),
          jax.jit(jax.vmap(rows), compiler_options=JIT_OPTIONS))


def _close(got, want, exempt, axis, tag):
  """``got`` to 1e-12 of the JAX scale per lane, the ``exempt`` indices
  along ``axis`` to ``MID_TOL``."""
  keep = np.ones(want.shape[axis], bool)
  keep[exempt] = False
  scale = np.maximum(1.0, np.abs(want).reshape(LANES, -1).max(1))
  for sel, tol in ((keep, 1e-12), (~keep, MID_TOL)):
    g, w = np.compress(sel, got, axis), np.compress(sel, want, axis)
    if g.size:
      err = np.abs(g - w).reshape(LANES, -1).max(1)
      assert (err <= tol * scale).all(), (tag, tol, err / scale)


@pytest.mark.parametrize("name", MODELS)
def test_points_and_rows_match_jax_row_by_row(name):
  mdl, q, v, _ = _states(name, 0)
  cd = mdl.contacts
  points, rows = _jax_fns(name)
  with jax.enable_x64(True):
    want_p = [np.asarray(x) for x in points(q)]
    want_r = [np.asarray(x) for x in rows(q, v)]
  tq, tv = _t(q), _t(v)
  xpos, xmat, _, _ = pe.fk(mdl, tq)
  got_p = [x.numpy() for x in pc.contact_points(mdl, xpos, xmat)]
  mids = _mid_points(cd)
  for tag, g, w in zip(("pos", "dist", "n", "t1", "t2"), got_p, want_p):
    _close(g, w, [] if tag == "dist" else mids, 1, tag)
  np.testing.assert_array_equal(got_p[5], want_p[5])
  got_r = [x.numpy() for x in pc.assemble_rows(mdl, cd, tq, tv,
                                               pe._kin_ctx(mdl, tq))]
  assert got_r[0].shape == want_r[0].shape == (LANES, cd.nrows, mdl.nv)
  mid_rows = _mid_rows(cd)
  for tag, g, w in zip(("J", "aref", "D"), got_r, want_r):
    _close(g, w, [] if tag == "D" else mid_rows, 1, tag)
  np.testing.assert_array_equal(got_r[3], want_r[3])
  assert want_r[3].any(1).sum() >= LANES // 2  # most lanes touch something
  if cd.pb_plane:  # the plane-box gate keeps some corners and drops some
    start = sum(2 if t else 1 for t in cd.pc_two) + len(cd.cc_g1)
    gate = want_p[5][:, start:start + 8 * len(cd.pb_plane)]
    assert gate.any() and not gate.all()
  if cd.ten_site_body.shape[0]:  # the string's row is taut in some lanes
    assert want_r[3][:, len(cd.lim_dof)].any()


def _mj(name):
  return mujoco.MjModel.from_xml_string(DMC_XMLS[name])


@pytest.mark.parametrize("name", MODELS)
def test_active_rows_match_efc(name):
  """The active rows of each lane == mjData.efc's rows (sorted), J, aref
  and D to 1e-9 of their scale, on the lanes without an active
  capsule-box pair (humanoid standing, its feet on the floor; cartpole's
  poles touch in few states, so it draws 64)."""
  lanes = 64 if name == "cartpole_three_poles" else LANES
  mdl, q, v, u = _states(name, 1, near_rest=name == "humanoid", lanes=lanes)
  m = _mj(name)
  tq, tv = _t(q), _t(v)
  J, aref, D, mask = (x.numpy() for x in pc.assemble_rows(
    mdl, mdl.contacts, tq, tv, pe._kin_ctx(mdl, tq)))
  xpos, xmat, _, _ = pe.fk(mdl, tq)
  _, dist, _, _, _, _ = pc.contact_points(mdl, xpos, xmat)
  cd = mdl.contacts
  nsb = sum(3 if t else 1 for t in cd.sb_three)
  free = np.arange(len(q))
  if nsb:
    free = np.where((dist.numpy()[:, -nsb:]
                     >= cd.point_incmargin[-nsb:]).all(1))[0]
    assert len(free) >= len(q) // 2
  rows = 0
  for i in free:
    d = mujoco.MjData(m)
    d.qpos[:], d.qvel[:], d.ctrl[:] = q[i], v[i], u[i]
    mujoco.mj_forward(m, d)
    act = np.where(mask[i])[0]
    assert len(act) == d.nefc, (name, i)
    rows += d.nefc
    if not d.nefc:
      continue
    ours = _sorted_rows(J[i, act], aref[i, act], D[i, act])
    ref = _sorted_rows(d.efc_J[:d.nefc * m.nv].reshape(d.nefc, m.nv),
                       d.efc_aref[:d.nefc], d.efc_D[:d.nefc])
    for o, r in zip(ours, ref):
      assert np.abs(o - r).max() < 1e-9 * max(1.0, np.abs(r).max()), name
  assert rows > LANES  # the states really exercised the rows


def test_ball_in_cup_warm_chain_matches_mj_step():
  """60 substeps of ball_in_cup (the warm-start chain, the string taut in
  the swing) against mj_step with warm start on, per lane."""
  mdl = dm.load_dmc_model("ball_in_cup")
  m = _mj("ball_in_cup")
  rng = np.random.default_rng(11)
  q = np.array([0.05, -0.05, 0.1, -0.27]) + rng.uniform(-0.02, 0.02, (LANES, 4))
  v = np.array([0.3, -0.2, 0.5, 0.0]) + rng.uniform(-0.2, 0.2, (LANES, 4))
  u = rng.uniform(-1, 1, (LANES, 2))
  gq, gv = pe.step_smooth(mdl, _t(q), _t(v), _t(u), nstep=60)
  taut = 0
  for i in range(LANES):
    d = mujoco.MjData(m)
    d.qpos[:], d.qvel[:], d.ctrl[:] = q[i], v[i], u[i]
    for _ in range(60):
      mujoco.mj_step(m, d)
      taut += int(d.ten_length[0] >= 0.3 - 1e-9)
    np.testing.assert_allclose(gq[i].numpy(), d.qpos, rtol=0, atol=1e-9)
    np.testing.assert_allclose(gv[i].numpy(), d.qvel, rtol=0, atol=1e-9)
  assert taut > 0


@pytest.mark.parametrize("name", MODELS)
def test_subtree_linvel_and_geom_xpos_match_jax(name):
  mdl, q, v, _ = _states(name, 2)
  body = {"humanoid": "torso", "ball_in_cup": "ball"}.get(name, "cart")
  # the first named geom on a moving body
  gname = next(k for k, g in mdl.geom_name2id.items()
               if k is not None and mdl.geom_body[g])
  with jax.enable_x64(True):
    want = [np.asarray(x) for x in jax.jit(jax.vmap(lambda q, v: (
      je.subtree_linvel(mdl, q, v, body), je.subtree_linvel(mdl, q, v, body),
      je.geom_xpos(mdl, q, gname))))(q, v)]
  got = [pe.subtree_linvel(mdl, _t(q), _t(v), body),
         pe.subtree_linvel_at(mdl, pe.fk(mdl, _t(q)), _t(v), body),
         pe.geom_xpos(mdl, _t(q), gname)]
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


SIGMOIDS = [rewards.GAUSSIAN, rewards.HYPERBOLIC, rewards.LONG_TAIL,
            rewards.RECIPROCAL, rewards.COSINE, rewards.LINEAR,
            rewards.QUADRATIC, rewards.TANH_SQUARED]
# (bound_min, bound_max, margin, value_at_margin): a bounded band, a
# symmetric one, a half-line (the locomotion speeds') and margin 0
TOLERANCE_ARGS = [(0.0, 0.25, 1.7, 0.1), (-0.25, 0.25, 5.0, 0.3),
                  (1.0, float("inf"), 0.5, 0.5), (0.0, 0.0, 0.0, 0.1)]


@pytest.mark.parametrize("sigmoid", SIGMOIDS)
def test_tolerance_matches_jax(sigmoid):
  """float64 to 1e-12; float32 within 4 ulps of 1 (the transcendental
  functions of the two libraries part by an ulp)."""
  grid = np.concatenate([np.linspace(-3, 3, 601), [
    0.0, 0.25, -0.25, 1.0, 1.7, 1.95, -1.7, -5.25, 5.25, 1.5, 0.5]])
  for args in TOLERANCE_ARGS:
    for dtype, tol in ((np.float64, 1e-12), (np.float32, 4.8e-7)):
      x = grid.astype(dtype)
      with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax.jit(
          lambda x: jr.tolerance(x, *args, sigmoid=sigmoid))(x))
      got = pr.tolerance(torch.from_numpy(x), *args, sigmoid=sigmoid).numpy()
      assert got.dtype == want.dtype == dtype
      np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                 err_msg=f"{sigmoid} {args}")
      inside = (x >= args[0]) & (x <= args[1])
      assert (got[inside] == 1).all()
