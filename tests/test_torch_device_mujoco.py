"""The port's on-device MuJoCo engine (float64, CPU) against the JAX engine
under x64 and against MuJoCo itself: the twin of
``tests/test_device_mujoco.py`` for the four contact-free gym models.

Every case runs a batch of lanes at once, and lane i is held to the
reference's result for state i. Tolerances are the JAX tests' own: the
mass matrix to 1e-12, bias, fluid and limit forces to 1e-10 (fluid to
1e-12 of its scale), one ``mj_step`` to 1e-13 in q and 1e-12 in v, the
100-step rollouts to 1e-10 / 1e-9 (InvertedDoublePendulum) and 1e-9 /
1e-8 (Swimmer), the 300-step Reacher rollout through limit events to 1e-1
of ``mj_step`` (MuJoCo's limit rows regularise with its own diagonal
approximation); against the JAX engine, which computes the same algorithm,
every quantity agrees to 1e-12 relative, the rollouts too. The JAX step of
each model is compiled once, at XLA's backend optimisation level 0 (its
compile on the CPU takes half as long; float64 results agree either way).
"""

import functools

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")
pytest.importorskip("gymnasium")

import jax  # noqa: E402

from envpool_torch.envs.mujoco import device_engine as pe  # noqa: E402
from envpool_torch.envs.mujoco import device_model as dm  # noqa: E402
from envpool_tpu.envs.mujoco import device_engine as je  # noqa: E402

torch.set_num_threads(1)

MODELS = ["reacher.xml", "inverted_pendulum.xml",
          "inverted_double_pendulum.xml", "swimmer.xml"]
LANES = 6
# the models whose JAX step_smooth is compiled here (see the step test)
JAX_STEP_MODELS = ("inverted_pendulum.xml", "inverted_double_pendulum.xml")
JIT_OPTIONS = {"xla_backend_optimization_level": 0}


def _x64():
  return jax.enable_x64(True)


def _mj(xml):
  return mujoco.MjModel.from_xml_path(dm.gym_asset(xml))


@functools.lru_cache(maxsize=None)
def _jax_model(xml):
  return je.extract_model(dm.gym_asset(xml))


@functools.lru_cache(maxsize=None)
def _jax_terms(xml):
  """jit(vmap(...)) of the dynamics terms and of one full forward-dynamics
  evaluation (``_qacc_full``), compiled on first use."""
  jm = _jax_model(xml)

  def terms(q, v, u):
    tau = je.actuator_force(jm, u)
    M = je.mass_matrix(jm, q)
    qacc = je._qacc_smooth(jm, q, v, tau)
    xpos, xmat, _, _ = je.fk(jm, q)
    return {
      "M": M, "bias": je.bias_forces(jm, q, v), "tau": tau, "qacc": qacc,
      "limit": je.limit_constraint_force(jm, q, v, je._minv(jm, M), qacc),
      "limit_cols": je.limit_constraint_force(
        jm, q, v, je._limit_minv_cols(jm, M), qacc),
      "fluid": je.fluid_force(jm, q, v), "qacc_full": je._qacc_full(jm, q, v, tau),
      "xpos": xpos, "xmat": xmat,
    }
  return jax.jit(jax.vmap(terms), compiler_options=JIT_OPTIONS)


@functools.lru_cache(maxsize=None)
def _jax_step(xml):
  """jit(vmap(step_smooth)) of one mj_step, compiled on first use."""
  jm = _jax_model(xml)
  return jax.jit(jax.vmap(lambda q, v, u: je.step_smooth(jm, q, v, u)),
                 compiler_options=JIT_OPTIONS)


def _jax_call(fn, *arrays):
  with _x64():
    out = fn(*arrays)
    return jax.tree.map(np.asarray, out)


def _t(x):
  return torch.from_numpy(np.ascontiguousarray(x, np.float64))


def _states(xml, seed, q_scale, v_scale, u_scale, lanes=LANES):
  m = dm.load_model(xml)
  rng = np.random.default_rng(seed)
  q = m.init_qpos + rng.uniform(-q_scale, q_scale, (lanes, m.nq))
  v = rng.uniform(-v_scale, v_scale, (lanes, m.nv))
  u = rng.uniform(-u_scale, u_scale, (lanes, len(m.act_gear)))
  return q, v, u


def _mj_forward(m, q, v, u=None):
  d = mujoco.MjData(m)
  d.qpos[:], d.qvel[:] = q, v
  if u is not None:
    d.ctrl[:] = u
  mujoco.mj_forward(m, d)
  return d


def _rel(got, want):
  return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.mark.parametrize("xml", MODELS)
def test_dynamics_terms_match_jax_and_mujoco(xml):
  """Mass matrix, bias, fluid and limit forces, qacc_smooth and the
  kinematic readouts of every lane against the JAX engine and mj_forward."""
  mdl, m = dm.load_model(xml), _mj(xml)
  q, v, u = _states(xml, 1, 0.4, 1.0, 0.5)
  tq, tv, tu = _t(q), _t(v), _t(u)
  tau = pe.actuator_force(mdl, tu)

  want = _jax_call(_jax_terms(xml), q, v, u)
  M = pe.mass_matrix(mdl, tq)
  qacc = pe._qacc_smooth(mdl, tq, tv, tau)
  xpos, xmat, _, _ = pe.fk(mdl, tq)
  got = {
    "M": M, "bias": pe.bias_forces(mdl, tq, tv), "tau": tau, "qacc": qacc,
    "limit": pe.limit_constraint_force(mdl, tq, tv, pe._minv(mdl, M), qacc),
    "limit_cols": pe.limit_constraint_force(
      mdl, tq, tv, pe._limit_minv_cols(mdl, M), qacc),
    "fluid": pe.fluid_force(mdl, tq, tv), "qacc_full": pe._qacc_full(mdl, tq, tv, tau),
    "xpos": torch.stack(xpos, 1), "xmat": torch.stack(xmat, 1),
  }
  for k, w in want.items():
    w = np.stack(w, 1) if isinstance(w, list) else w
    assert _rel(got[k].numpy(), w) < 1e-12, (xml, k)
  for i in range(LANES):
    d = _mj_forward(m, q[i], v[i])
    m_ref = np.zeros((m.nv, m.nv))
    mujoco.mj_fullM(m, d, m_ref)
    assert np.abs(M[i].numpy() - m_ref).max() < 1e-12
    assert np.abs(got["bias"][i].numpy() - d.qfrc_bias).max() < 1e-10
    if mdl.density > 0:
      fluid_ref = d.qfrc_passive + m.dof_damping * v[i]  # no springs here
      scale = max(1.0, np.abs(fluid_ref).max())
      assert np.abs(got["fluid"][i].numpy() - fluid_ref).max() < 1e-12 * scale
    np.testing.assert_allclose(got["xpos"][i].numpy(), d.xpos, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
      got["xmat"][i].numpy().reshape(-1, 9), d.xmat, rtol=0, atol=1e-12)
    for name, b in mdl.body_name2id.items():
      np.testing.assert_array_equal(
        pe.body_xpos(mdl, tq, name)[i].numpy(), xpos[b][i].numpy())
      np.testing.assert_array_equal(
        pe.body_xmat(mdl, tq, name)[i].numpy(), xmat[b][i].numpy())
    for name, s in mdl.site_name2id.items():
      np.testing.assert_allclose(
        pe.site_xpos(mdl, tq, name)[i].numpy(), d.site_xpos[s], rtol=0, atol=1e-12)


def _mj_steps(m, q, v, u, steps=1):
  """(q, v) of every lane after ``steps`` mj_step calls, and the largest
  efc count MuJoCo saw."""
  out_q, out_v, nefc = [], [], 0
  for i in range(len(q)):
    d = _mj_forward(m, q[i], v[i], u[i])
    for _ in range(steps):
      mujoco.mj_step(m, d)
      nefc = max(nefc, d.nefc)
    assert d.ncon == 0
    out_q.append(d.qpos.copy())
    out_v.append(d.qvel.copy())
  return np.stack(out_q), np.stack(out_v), nefc


@pytest.mark.parametrize("xml", MODELS)
def test_single_step_matches_jax_and_mj_step(xml):
  """One step_smooth (RK4, smooth regime) of every lane against mj_step,
  to 1e-13 in q and 1e-12 in v, and against the JAX engine's step_smooth
  for the two models whose JAX step compiles fast (Reacher's 30 unrolled
  Gauss-Seidel updates and Swimmer's fluid pass make theirs the slowest;
  their forward dynamics are held to the JAX engine's above)."""
  mdl, m = dm.load_model(xml), _mj(xml)
  q, v, u = _states(xml, 2, 0.05, 0.1, 0.5)
  gq, gv = pe.step_smooth(mdl, _t(q), _t(v), _t(u))
  mq, mv, _ = _mj_steps(m, q, v, u)
  assert np.abs(gq.numpy() - mq).max() < 1e-13
  assert np.abs(gv.numpy() - mv).max() < 1e-12
  if xml in JAX_STEP_MODELS:
    wq, wv = _jax_call(_jax_step(xml), q, v, u)
    assert _rel(gq.numpy(), wq) < 1e-12 and _rel(gv.numpy(), wv) < 1e-12


@pytest.mark.parametrize("xml,qpos,qvel,rel_tol", [
  # the cart past its rail: MuJoCo's R uses a diagonal approximation of
  # A that differs from the exact one by ~4e-5 (the clamped tc branch)
  ("inverted_pendulum.xml", [[1.002, 0.01], [-1.003, -0.02], [1.01, 0.0]],
   [[0.5, 0.0], [-0.2, 0.1], [0.0, 0.0]], 1e-3),
  # Reacher's joint1 past its stop (timestep < tc: the unclamped branch)
  ("reacher.xml", [[0.0, 3.04, 0.0, 0.0], [0.3, -3.1, 0.1, -0.1]],
   [[0.0, 0.5, 0.0, 0.0], [0.1, -0.3, 0.0, 0.0]], 1e-6),
])
def test_limit_force_matches_mujoco_efc(xml, qpos, qvel, rel_tol):
  """qfrc_constraint and the row forces (efc_force) of active limit rows,
  lane by lane."""
  mdl, m = dm.load_model(xml), _mj(xml)
  q, v = np.asarray(qpos, np.float64), np.asarray(qvel, np.float64)
  tq, tv = _t(q), _t(v)
  tau = pe.actuator_force(mdl, torch.zeros(len(q), len(mdl.act_gear), dtype=torch.float64))
  M = pe.mass_matrix(mdl, tq)
  qacc = pe._qacc_smooth(mdl, tq, tv, tau)
  for minv in (pe._minv(mdl, M), pe._limit_minv_cols(mdl, M)):
    qfrc = pe.limit_constraint_force(mdl, tq, tv, minv, qacc).numpy()
    for i in range(len(q)):
      d = _mj_forward(m, q[i], v[i])
      assert d.nefc >= 1
      ref = np.asarray(d.qfrc_constraint)
      assert np.abs(qfrc[i] - ref).max() < rel_tol * np.abs(ref).max()
      rows = d.efc_id[:d.nefc]
      dofs = [mdl.jnt_dof[j] for j in rows]
      np.testing.assert_allclose(np.abs(qfrc[i, dofs]), d.efc_force[:d.nefc],
                                 rtol=rel_tol)
  if xml == "inverted_pendulum.xml":
    assert qfrc[0, 0] < -100  # the rail pushes the cart back hard


@pytest.mark.parametrize("xml,q_tol,v_tol", [
  ("inverted_double_pendulum.xml", 1e-10, 1e-9),
  ("swimmer.xml", 1e-9, 1e-8),
])
def test_100_step_rollouts(xml, q_tol, v_tol):
  """100 constraint-free steps of every lane under a constant control
  (InvertedDoublePendulum; Swimmer through the fluid model and the
  3-joint torso) at machine precision against mj_step."""
  mdl, m = dm.load_model(xml), _mj(xml)
  q, v, u = _states(xml, 3, 0.05, 0.1, 0.3)
  pq, pv, tu = _t(q), _t(v), _t(u)
  for _ in range(100):
    pq, pv = pe.step_smooth(mdl, pq, pv, tu)
  mq, mv, _ = _mj_steps(m, q, v, u, 100)
  assert np.abs(pq.numpy() - mq).max() < q_tol
  assert np.abs(pv.numpy() - mv).max() < v_tol


def test_300_step_rollout_through_limit_events():
  """Reacher under persistent torque drives joint1 into its +-3 limit: each
  lane within 1e-1 of mj_step through repeated limit contacts (exact in the
  smooth regime, small bounded offsets injected at events)."""
  mdl, m = dm.load_model("reacher.xml"), _mj("reacher.xml")
  q, v, u = _states("reacher.xml", 0, 0.05, 0.1, 0.5)
  pq, pv, tu = _t(q), _t(v), _t(u)
  for _ in range(300):
    pq, pv = pe.step_smooth(mdl, pq, pv, tu)
  mq, mv, nefc = _mj_steps(m, q, v, u, 300)
  assert nefc >= 1  # the limit really was exercised
  assert np.abs(pq.numpy() - mq).max() < 1e-1


@pytest.mark.parametrize("xml", MODELS)
def test_divergence_guard_per_lane(xml):
  """A lane pushed to v = 1e11 restarts at (qpos0, 0), as mj_step's reset
  does; the other lanes step as mj_step (and the JAX engine) do."""
  mdl, m = dm.load_model(xml), _mj(xml)
  q, v, u = _states(xml, 4, 0.05, 0.1, 0.5)
  v[2, 0] = 1e11
  gq, gv = pe.step_smooth(mdl, _t(q), _t(v), _t(u))
  np.testing.assert_array_equal(gq[2].numpy(), mdl.init_qpos)
  np.testing.assert_array_equal(gv[2].numpy(), np.zeros(mdl.nv))
  keep = np.arange(LANES) != 2
  mq, mv, _ = _mj_steps(m, q[keep], v[keep], u[keep])
  assert np.abs(gq.numpy()[keep] - mq).max() < 1e-13
  assert np.abs(gv.numpy()[keep] - mv).max() < 1e-12
  if xml in JAX_STEP_MODELS:
    wq, wv = _jax_call(_jax_step(xml), q, v, u)
    np.testing.assert_array_equal(wq[2], mdl.init_qpos)
    assert _rel(gq.numpy()[keep], wq[keep]) < 1e-12
    assert _rel(gv.numpy()[keep], wv[keep]) < 1e-12


def test_spring_force_matches_jax():
  """Joint springs (none of the four models has one: InvertedPendulum's
  joints given stiffness) against the JAX engine, alone and in qacc."""
  mdl = dm.load_model("inverted_pendulum.xml")._replace(
    jnt_stiffness=np.array([3.0, 0.5]), qpos_spring=np.array([0.1, -0.2]))
  jm = _jax_model("inverted_pendulum.xml")._replace(
    jnt_stiffness=mdl.jnt_stiffness, qpos_spring=mdl.qpos_spring)
  q, v, u = _states("inverted_pendulum.xml", 6, 0.4, 1.0, 1.0)
  with _x64():
    want = np.stack([np.asarray(je.passive_spring_force(jm, qi)) for qi in q])
  got = pe.passive_spring_force(mdl, _t(q)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
  assert np.abs(want).max() > 0.1
  tau = pe.actuator_force(mdl, _t(u))
  with_spring = pe._qacc_smooth(mdl, _t(q), _t(v), tau)
  without = pe._qacc_smooth(dm.load_model("inverted_pendulum.xml"), _t(q), _t(v), tau)
  M = pe.mass_matrix(mdl, _t(q))
  np.testing.assert_allclose(
    pe._solve_psd(M, _t(got)).numpy(), (with_spring - without).numpy(),
    rtol=1e-9, atol=1e-12)


def test_euler_branch_matches_mj_step():
  """The Euler integrator (implicit damping, the limit solve): Reacher's
  model switched to Euler in the port and in MuJoCo, two steps. Lanes
  clear of their limits to 1e-12; the lane that starts past joint1's stop
  to 1e-6 of its velocity change (MuJoCo's limit row regularises with its
  own diagonal approximation, see the limit test)."""
  mdl = dm.load_model("reacher.xml")._replace(integrator=0)
  m = _mj("reacher.xml")
  m.opt.integrator = mujoco.mjtIntegrator.mjINT_EULER
  q, v, u = _states("reacher.xml", 5, 0.2, 0.5, 1.0)
  q[0, 1] = 3.05  # lane 0 starts past its limit
  gq, gv = pe.step_smooth(mdl, _t(q), _t(v), _t(u), nstep=2)
  mq, mv, nefc = _mj_steps(m, q, v, u, 2)
  assert nefc >= 1
  assert np.abs(gq.numpy()[1:] - mq[1:]).max() < 1e-12
  assert np.abs(gv.numpy()[1:] - mv[1:]).max() < 1e-12
  dv = np.abs(mv[0] - v[0]).max()
  assert np.abs(gv.numpy()[0] - mv[0]).max() < 1e-6 * dv
