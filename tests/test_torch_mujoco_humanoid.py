"""The port's Humanoid machinery (float64, CPU) against MuJoCo and the JAX
engine under x64: the twin of ``tests/test_device_humanoid.py``.

Every case runs a batch of lanes at once, lane i held to the reference for
state i: ``com_quantities`` against mjData's ``subtree_com[0]``, ``xipos``
(1e-12), ``cinert`` and ``cvel`` (1e-11); the contact wrenches, moved to
com0, against ``mj_rnePostConstraint``'s ``cfrc_ext`` (2e-2 of its scale,
the JAX test's bound: the two solvers stop at different residuals);
``_qacc_full(want_fext=True)`` against the JAX engine's, compiled once at
XLA's backend optimisation level 0, to 1e-10 relative; a 100-substep
HumanoidStandup chain, which lies on the floor from the start, against
``mj_step`` with warm start on (2e-3, the JAX test's bound).
"""

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")
pytest.importorskip("gymnasium")

import jax  # noqa: E402

from envpool_torch.envs.mujoco import device_engine as pe  # noqa: E402
from envpool_torch.envs.mujoco import device_model as dm  # noqa: E402
from envpool_tpu.envs.mujoco import device_engine as je  # noqa: E402
from test_device_humanoid import _rand_state  # noqa: E402

torch.set_num_threads(1)

LANES = 6


def _t(x):
  return torch.from_numpy(np.ascontiguousarray(x, np.float64))


def _mj(xml, warmstart=True):
  m = mujoco.MjModel.from_xml_path(dm.gym_asset(xml))
  if not warmstart:
    m.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_WARMSTART
  return m


def _states(m, seed, zlo=0.4, zhi=1.4):
  rng = np.random.default_rng(seed)
  q, v = zip(*(_rand_state(m, rng, zlo, zhi) for _ in range(LANES)))
  return np.stack(q), np.stack(v), rng.uniform(-0.4, 0.4, (LANES, m.nu))


def test_com_quantities_match_mjdata():
  mdl, m = dm.load_model("humanoid.xml"), _mj("humanoid.xml")
  q, v, _ = _states(m, 3)
  com0, xipos, cinert, cvel = (
    x.numpy() for x in pe.com_quantities(mdl, _t(q), _t(v)))
  d = mujoco.MjData(m)
  for i in range(LANES):
    d.qpos[:], d.qvel[:] = q[i], v[i]
    mujoco.mj_forward(m, d)
    assert np.abs(com0[i] - d.subtree_com[0]).max() < 1e-12
    assert np.abs(xipos[i] - d.xipos).max() < 1e-12
    assert np.abs(cinert[i] - d.cinert).max() < 1e-11
    assert np.abs(cvel[i] - d.cvel).max() < 1e-11
  for name, b in mdl.body_name2id.items():
    np.testing.assert_array_equal(
      pe.body_xipos(mdl, _t(q), name).numpy(), xipos[:, b])


def _cfrc(mdl, q, v, fext):
  com0 = pe.com_quantities(mdl, q, v)[0]
  F = fext[..., 3:]
  T = fext[..., :3] - torch.linalg.cross(com0[:, None].expand_as(F), F)
  return torch.cat([T, F], -1).numpy()


def test_cfrc_ext_matches_rne_post_constraint():
  """The per-body contact wrench (world body excluded), moved to com0, on
  the JAX test's 8 states (its draws in its order). Other states exist
  where the JAX engine, and the port with it to 1e-11, differ from
  cfrc_ext by more (one at 4% of the scale): the solvers' difference, not
  the port's (``test_qacc_full_with_fext_matches_jax``)."""
  mdl, m = dm.load_model("humanoid.xml"), _mj("humanoid.xml", warmstart=False)
  rng = np.random.default_rng(3)
  q, v, u = [], [], []
  for _ in range(8):
    qi, vi = _rand_state(m, rng, 0.4, 1.0)
    q.append(qi)
    v.append(vi)
    u.append(rng.uniform(-0.4, 0.4, m.nu))
  q, v, u = np.stack(q), np.stack(v), np.stack(u)
  tq, tv = _t(q), _t(v)
  tau = pe.actuator_force(mdl, _t(u))
  _, fext, f = pe._qacc_full(mdl, tq, tv, tau, want_fext=True)
  assert fext.shape == (8, mdl.nbody, 6) and f.shape == (8, mdl.contacts.nrows)
  ours = _cfrc(mdl, tq, tv, fext)
  d = mujoco.MjData(m)
  ncon = 0
  for i in range(8):
    d.qpos[:], d.qvel[:], d.ctrl[:] = q[i], v[i], u[i]
    mujoco.mj_forward(m, d)
    mujoco.mj_rnePostConstraint(m, d)
    ncon += d.ncon
    scale = max(1.0, np.abs(d.cfrc_ext).max())
    assert np.abs(ours[i] - d.cfrc_ext).max() < 2e-2 * scale
  assert ncon > 10


def test_qacc_full_with_fext_matches_jax():
  """(qacc, fext, f) of every lane against the JAX engine's."""
  mdl, m = dm.load_model("humanoid.xml"), _mj("humanoid.xml")
  jm = je.extract_model(dm.gym_asset("humanoid.xml"))
  q, v, u = _states(m, 3, zlo=0.4, zhi=1.0)
  fn = jax.jit(jax.vmap(lambda q, v, u: je._qacc_full(
    jm, q, v, je.actuator_force(jm, u), want_fext=True)),
    compiler_options={"xla_backend_optimization_level": 0})
  with jax.enable_x64(True):
    want = [np.asarray(x) for x in fn(q, v, u)]
  tau = pe.actuator_force(mdl, _t(u))
  got = pe._qacc_full(mdl, _t(q), _t(v), tau, want_fext=True)
  for name, g, w in zip(("qacc", "fext", "f"), got, want):
    assert g.shape == w.shape, name
    rel = np.abs(g.numpy() - w).max() / max(1.0, np.abs(w).max())
    assert rel < 1e-10, (name, rel)
  assert (want[2] > 0).any()  # contact forces really flowed


def test_100_step_rollout_parity_humanoidstandup():
  """100 RK4 substeps in one warm-started chain from the lying pose under
  two constant controls, against mj_step with warm start on."""
  mdl, m = dm.load_model("humanoidstandup.xml"), _mj("humanoidstandup.xml")
  u = np.random.default_rng(2).uniform(-0.3, 0.3, (2, m.nu))
  q, _ = pe.step_smooth(mdl, _t(np.tile(m.qpos0, (2, 1))),
                        torch.zeros(2, m.nv, dtype=torch.float64), _t(u),
                        nstep=100)
  for i in range(2):
    d = mujoco.MjData(m)
    d.qpos[:], d.ctrl[:] = m.qpos0, u[i]
    for _ in range(100):
      mujoco.mj_step(m, d)
    assert d.ncon > 0
    assert np.abs(q[i].numpy() - d.qpos).max() < 2e-3
