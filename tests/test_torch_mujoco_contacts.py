"""The port's contact engine (float64, CPU) against the JAX engine under x64
and against MuJoCo itself: the twin of ``tests/test_device_contacts.py``
for its four models (HalfCheetah, Hopper, Walker2d, Ant).

Every case runs a batch of lanes at once, and lane i is held to the
reference's result for state i. The states mix grounded, penetrating and
airborne ones as the JAX test makes them (its ``_random_state``).
Tolerances are the JAX tests' own: ``assemble_rows`` row by row in the JAX
order to 1e-12 of the JAX function's scale; the active rows against
``mjData.efc_J/aref/D``, sorted, to 1e-9 of theirs; ``qacc`` and
``qfrc_constraint`` against ``mj_forward`` (warm start off) to 1e-4
relative (HalfCheetah's deep penetrations meet the two solvers' 1e-8
stopping floors; the rest land near 1e-12); the 100-step rollouts against
``mj_step`` to 1e-10 (Hopper, Walker2d, Ant) and 1e-4 (HalfCheetah, whose
Euler steps carry the solvers' difference through stiff contact events);
the 60-substep warm-start chain against ``mj_step`` with warm start on to
1e-9 (1e-4 HalfCheetah). The JAX ``assemble_rows`` of each model is
compiled once, at XLA's backend optimisation level 0.
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
from test_device_contacts import _random_state, _sorted_rows  # noqa: E402

torch.set_num_threads(1)

CONTACT_MODELS = ["half_cheetah.xml", "hopper.xml", "walker2d.xml", "ant.xml"]
LANES = 8
JIT_OPTIONS = {"xla_backend_optimization_level": 0}


def _mj(xml, warmstart=False):
  m = mujoco.MjModel.from_xml_path(dm.gym_asset(xml))
  if not warmstart:  # mj's Newton then starts from qacc_smooth, as ours
    m.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_WARMSTART
  return m


def _t(x):
  return torch.from_numpy(np.ascontiguousarray(x, np.float64))


def _states(xml, seed, lanes=LANES):
  m = _mj(xml)
  rng = np.random.default_rng(seed)
  q, v, u = zip(*(_random_state(m, rng, xml) for _ in range(lanes)))
  return np.stack(q), np.stack(v), np.stack(u)


def _mj_forward(m, q, v, u):
  d = mujoco.MjData(m)
  d.qpos[:], d.qvel[:], d.ctrl[:] = q, v, u
  mujoco.mj_forward(m, d)
  return d


@functools.lru_cache(maxsize=None)
def _jax_rows(xml):
  """jit(vmap(assemble_rows)) under x64, compiled on first use."""
  jm = je.extract_model(dm.gym_asset(xml))

  def rows(q, v):
    return jc.assemble_rows(jm, jm.contacts, q, v, je._kin_ctx(jm, q))
  return jax.jit(jax.vmap(rows), compiler_options=JIT_OPTIONS)


def _port_rows(mdl, q, v):
  tq, tv = _t(q), _t(v)
  rows = pc.assemble_rows(mdl, mdl.contacts, tq, tv, pe._kin_ctx(mdl, tq))
  return [x.numpy() for x in rows]


@pytest.mark.parametrize("xml", CONTACT_MODELS)
def test_rows_match_jax_row_by_row(xml):
  """J, aref, D and the mask of every lane in the JAX order: joint limits,
  condim-1 points, then 4 facets per condim-3 point."""
  mdl = dm.load_model(xml)
  q, v, _ = _states(xml, 0)
  with jax.enable_x64(True):
    want = [np.asarray(x) for x in _jax_rows(xml)(q, v)]
  got = _port_rows(mdl, q, v)
  assert got[0].shape == want[0].shape == (LANES, mdl.contacts.nrows, mdl.nv)
  for name, g, w in zip(("J", "aref", "D"), got, want):
    scale = np.maximum(1.0, np.abs(w).reshape(LANES, -1).max(1))
    err = np.abs(g - w).reshape(LANES, -1).max(1)
    assert (err <= 1e-12 * scale).all(), (xml, name, err / scale)
  np.testing.assert_array_equal(got[3], want[3])
  assert want[3].any(1).sum() >= LANES // 2  # most lanes touch something


@pytest.mark.parametrize("xml", CONTACT_MODELS)
def test_active_rows_match_efc(xml):
  """The active rows of each lane == mjData.efc's rows (sorted), J, aref
  and D to 1e-9 of their scale."""
  mdl, m = dm.load_model(xml), _mj(xml)
  q, v, u = _states(xml, 1)
  J, aref, D, mask = _port_rows(mdl, q, v)
  contacts = 0
  for i in range(LANES):
    d = _mj_forward(m, q[i], v[i], u[i])
    contacts += d.ncon
    act = np.where(mask[i])[0]
    assert len(act) == d.nefc, (xml, i)
    if not d.nefc:
      continue
    ours = _sorted_rows(J[i, act], aref[i, act], D[i, act])
    ref = _sorted_rows(d.efc_J[:d.nefc * m.nv].reshape(d.nefc, m.nv),
                       d.efc_aref[:d.nefc], d.efc_D[:d.nefc])
    for o, r in zip(ours, ref):
      assert np.abs(o - r).max() < 1e-9 * max(1.0, np.abs(r).max())
  assert contacts > 5  # the states really exercised the narrow phase


@pytest.mark.parametrize("xml", CONTACT_MODELS)
def test_qacc_and_constraint_force_match(xml):
  """The Newton solve (cold start): qacc and qfrc_constraint of every lane
  against mj_forward with warm start off."""
  mdl, m = dm.load_model(xml), _mj(xml)
  q, v, u = _states(xml, 2)
  tq, tv = _t(q), _t(v)
  tau = pe.actuator_force(mdl, _t(u))
  M, qfs, ctx = pe._qacc_smooth_parts(mdl, tq, tv, tau)
  qacc, qfrc, f = pe._contact_solve(mdl, tq, tv, M, qfs, ctx)
  assert (f.numpy() >= 0).all()
  full = pe._qacc_full(mdl, tq, tv, tau)
  np.testing.assert_array_equal(full.numpy(), qacc.numpy())
  for i in range(LANES):
    d = _mj_forward(m, q[i], v[i], u[i])
    assert np.abs(qacc[i].numpy() - d.qacc).max() < 1e-4 * max(
      1.0, np.abs(d.qacc).max())
    assert np.abs(qfrc[i].numpy() - d.qfrc_constraint).max() < 1e-4 * max(
      1.0, np.abs(d.qfrc_constraint).max())


def test_includemargin_matches_mujoco():
  """Margins add across the geom pair (hopper: 0.001 + 0.001); a lane
  lowered onto the floor activates exactly the rows of mj's contacts."""
  mdl = dm.load_model("hopper.xml")
  m = _mj("hopper.xml")
  q = np.tile(m.qpos0, (2, 1))
  q[0, 1], q[1, 1] = 0.8, 0.5  # a grounded lane and a penetrating one
  v = np.zeros((2, m.nv))
  _, _, _, mask = _port_rows(mdl, q, v)
  for i in range(2):
    d = _mj_forward(m, q[i], v[i], np.zeros(m.nu))
    assert d.ncon > 0 and mask[i].sum() == d.nefc
    for k in range(d.ncon):
      assert mdl.contacts.point_incmargin[0] == pytest.approx(
        d.contact[k].includemargin, abs=1e-15)


def test_limit_rows_unclamped_time_constant():
  """Reacher (timestep 0.01 below its solref time constant): the unclamped
  K/B branch of the limit rows, lane by lane against mj_forward."""
  mdl, m = dm.load_model("reacher.xml"), _mj("reacher.xml")
  q = np.tile(m.qpos0, (2, 1))
  q[0, 1] = m.jnt_range[1, 1] + 0.02
  q[1, 1] = m.jnt_range[1, 0] - 0.03
  v = np.zeros((2, m.nv))
  v[0, 1], v[1, 1] = 0.5, -0.2
  tq, tv = _t(q), _t(v)
  tau = pe.actuator_force(mdl, torch.zeros(2, m.nu, dtype=torch.float64))
  M = pe.mass_matrix(mdl, tq)
  qfrc = pe.limit_constraint_force(mdl, tq, tv, pe._limit_minv_cols(mdl, M),
                                   pe._qacc_smooth(mdl, tq, tv, tau)).numpy()
  for i in range(2):
    d = _mj_forward(m, q[i], v[i], np.zeros(m.nu))
    assert d.nefc == 1
    ref = d.qfrc_constraint
    assert np.abs(qfrc[i] - ref).max() < 1e-6 * np.abs(ref).max()


def _mj_rollout(m, u, steps):
  out = []
  ncon = 0
  for ui in u:
    d = mujoco.MjData(m)
    d.qpos[:], d.ctrl[:] = m.qpos0, ui
    for _ in range(steps):
      mujoco.mj_step(m, d)
      ncon = max(ncon, d.ncon)
    out.append(d.qpos.copy())
  return np.stack(out), ncon


@pytest.mark.parametrize("xml,tol", [
  ("hopper.xml", 1e-10), ("walker2d.xml", 1e-10), ("ant.xml", 1e-10),
  ("half_cheetah.xml", 1e-4),
])
def test_100_step_contact_rollout_parity(xml, tol):
  """100 single-substep calls (each a cold start) from qpos0 under three
  constant controls against mj_step with warm start off."""
  mdl, m = dm.load_model(xml), _mj(xml)
  u = np.random.default_rng(2).uniform(-0.5, 0.5, (3, m.nu))
  q = _t(np.tile(m.qpos0, (3, 1)))
  v = torch.zeros(3, m.nv, dtype=torch.float64)
  for _ in range(100):
    q, v = pe.step_smooth(mdl, q, v, _t(u))
  want, ncon = _mj_rollout(m, u, 100)
  assert ncon >= 1
  assert np.abs(q.numpy() - want).max() < tol


@pytest.mark.parametrize("xml", ["ant.xml", "hopper.xml", "half_cheetah.xml"])
def test_warmstart_chain_parity(xml):
  """One call of 60 substeps warm-chains its solves as
  mjData.qacc_warmstart does: against mj_step with warm start on."""
  mdl, m = dm.load_model(xml), _mj(xml, warmstart=True)
  u = np.random.default_rng(4).uniform(-0.5, 0.5, (2, m.nu))
  q, _ = pe.step_smooth(mdl, _t(np.tile(m.qpos0, (2, 1))),
                        torch.zeros(2, m.nv, dtype=torch.float64), _t(u),
                        nstep=60)
  want, _ = _mj_rollout(m, u, 60)
  tol = 1e-4 if xml == "half_cheetah.xml" else 1e-9
  assert np.abs(q.numpy() - want).max() < tol


@pytest.mark.parametrize("xml", CONTACT_MODELS)
def test_divergence_guard_per_lane(xml):
  """A lane pushed to v = 1e11 restarts at (qpos0, 0) with its warm start
  zeroed and its derived forces cleared; the other lanes step as mj_step
  does."""
  mdl, m = dm.load_model(xml), _mj(xml)
  q, v, u = _states(xml, 3, lanes=4)
  v[2, 0] = 1e11
  gq, gv = pe.step_smooth(mdl, _t(q), _t(v), _t(u))
  np.testing.assert_array_equal(gq[2].numpy(), mdl.init_qpos)
  np.testing.assert_array_equal(gv[2].numpy(), np.zeros(mdl.nv))
  for i in (0, 1, 3):
    d = _mj_forward(m, q[i], v[i], u[i])
    mujoco.mj_step(m, d)
    assert np.abs(gq[i].numpy() - d.qpos).max() < 1e-10
  # the guard itself: the bad lane's warm start and aux are reset, the
  # others pass through
  bad_q, bad_v = _t(q), _t(v)
  last = torch.ones(4, mdl.nv, dtype=torch.float64)
  aux = (bad_q, bad_v, torch.ones(4, mdl.nbody, 6, dtype=torch.float64),
         torch.ones(4, mdl.contacts.nrows, dtype=torch.float64))
  _, _, last, aux = pe._guard(mdl, bad_q, bad_v, last, aux)
  keep = [0, 1, 3]
  assert (last[2] == 0).all() and (last[keep] == 1).all()
  np.testing.assert_array_equal(aux[0][2].numpy(), mdl.init_qpos)
  assert all((x[2] == 0).all() for x in aux[1:])
  np.testing.assert_array_equal(aux[0][keep].numpy(), q[keep])
  assert (aux[2][keep] == 1).all() and (aux[3][keep] == 1).all()
