"""The port's two humanoid_CMU ids (CPU) against the JAX package: the CMU
skeleton replica, nv 62 and 30 bodies, a free root over the floor, 29
plane-capsule and 371 capsule-capsule pairs (426 candidates, 647 rows),
16 Newton iterations, frame_skip 10: the widest model of the device tier.

A JAX pool of it compiles for many minutes on one core, so the layers are
held one by one, as ``test_torch_dmc_humanoid.py`` holds the humanoid:

- specs equal, per id;
- the reset: the 16 candidates' draws on the keys of a pool's init (the
  JAX randomizer at XLA's default level against the port's: the hinges bit
  for bit, the root quaternion, a normalised ``normal`` draw, within
  ``QUAT_ULPS``), and the candidate the port's reset picks is the one the
  JAX narrow phase picks (the first collision-free one, else the least
  penetrating);
- the 647 rows of a forward evaluation in float64 under x64 against the
  JAX ``assemble_rows`` (XLA level 0), row by row to 1e-12, on seeded
  states low over the floor; the whole forward evaluation (``_qacc_full``:
  the rows, the mass matrix and bias of nv 62, the Newton solve) against
  the JAX engine's to 1e-10 relative (the JAX tests' bound for the
  humanoid) is ``slow``: its JAX compile takes over a minute on one core;
- stand's and run's observations and rewards, from the port's reset state
  stepped once by the port, against the JAX class's ``_obs`` and
  ``_reward`` on the same state, within ``TOL``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envpool_torch.envs.mujoco import device_engine as pe
from envpool_torch.envs.mujoco.dmc import device_domains as pd
from envpool_tpu.envs.mujoco import device_collision as jc
from envpool_tpu.envs.mujoco import device_engine as je
from envpool_tpu.envs.mujoco.dmc import device_domains as jd

from _torch_parity import DMC_CONTACT_TOL as TOL, init_keys, ulps
from test_torch_dmc_classic import assert_spec_matches

torch.set_num_threads(1)

QUAT_ULPS = 8
N = 4
LEVEL0 = {"xla_backend_optimization_level": 0}
PCLS, JCLS = pd.DmcHumanoidCMUJaxEnv, jd.DmcHumanoidCMUJaxEnv


def _cfg(task):
  return types.SimpleNamespace(task_name=task, frame_skip=10)


@pytest.mark.parametrize("task_id", ["HumanoidCMUJaxStand-v1",
                                     "HumanoidCMUJaxRun-v1"])
def test_spec_matches_jax_package(task_id):
  assert_spec_matches(task_id)


def test_reset_candidates_and_pick():
  cfg = _cfg("run")
  jm, pm = JCLS.mdl(cfg), PCLS.mdl(cfg)
  k = PCLS._INIT_DRAWS
  keys = init_keys(N)
  cand_keys = np.asarray(jax.vmap(lambda x: jax.random.split(x, k))(
    jnp.asarray(keys.astype(np.uint32)))).reshape(N * k, 2)
  q0 = jnp.asarray(jm.init_qpos, jnp.float32)
  want = np.asarray(jax.jit(jax.vmap(
    lambda x: jd.randomize_limited_and_rotational_joints(jm, q0, x)))(cand_keys))
  got = pd.randomize_limited_and_rotational_joints(
    pm, torch.from_numpy(np.tile(jm.init_qpos.astype(np.float32), (N * k, 1))),
    torch.from_numpy(cand_keys.astype(np.int64))).numpy()
  np.testing.assert_array_equal(got[:, 7:], want[:, 7:])
  assert ulps(got[:, 3:7], want[:, 3:7]).max() <= QUAT_ULPS
  np.testing.assert_array_equal(got[:, :3], want[:, :3])

  def points(q):
    xpos, xmat, _, _ = je.fk(jm, q)
    _, dist, _, _, _, gate = jc.contact_points(jm.contacts, xpos, xmat, q.dtype)
    return dist, gate
  dist, gate = (np.asarray(x).reshape(N, k, -1) for x in
                jax.jit(jax.vmap(points), compiler_options=LEVEL0)(want))
  ok = ((dist >= 0) | ~gate).all(-1)
  mindist = np.where(gate, dist, np.inf).min(-1)
  pick = np.where(ok.any(1), ok.argmax(1), mindist.argmax(1))
  state, obs, _ = PCLS.reset(cfg, None, torch.from_numpy(keys))
  chosen = want.reshape(N, k, -1)[np.arange(N), pick]
  q = state["q"].numpy()
  np.testing.assert_array_equal(q[:, 7:], chosen[:, 7:])
  assert ulps(q[:, 3:7], chosen[:, 3:7]).max() <= QUAT_ULPS
  assert all(np.isfinite(v.numpy()).all() for v in obs.values())


def _states(mdl, seed, lanes):
  """float64 states low over the floor: the root at 0.3-1.1 m, upright or
  at any orientation, the joints perturbed within their ranges' scale, so
  that limbs touch the floor and each other."""
  rng = np.random.default_rng(seed)
  q = np.tile(mdl.init_qpos, (lanes, 1))
  q[:, 2] = rng.uniform(0.3, 1.1, lanes)
  quat = np.where(rng.random((lanes, 1)) < 0.5,
                  np.concatenate([np.ones((lanes, 1)),
                                  rng.uniform(-0.3, 0.3, (lanes, 3))], 1),
                  rng.normal(size=(lanes, 4)))
  q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  q[:, 7:] += rng.uniform(-0.6, 0.6, (lanes, mdl.nq - 7))
  return q, rng.uniform(-1, 1, (lanes, mdl.nv)), rng.uniform(-1, 1, (lanes, 56))


def test_rows_match_jax_x64():
  """The 647 rows (J, aref, D, mask) in float64 against the JAX
  ``assemble_rows`` under x64 row by row, to 1e-12 of the JAX scale: the
  kinematics of the 30 bodies, the 400 pairs' narrow phase, the 56 limits
  and the impedance pass of the forward evaluation."""
  cfg = _cfg("stand")
  jm, pm = JCLS.mdl(cfg), PCLS.mdl(cfg)
  q, v, _ = _states(pm, 3, N)
  fn = jax.jit(jax.vmap(lambda q, v: jc.assemble_rows(
    jm, jm.contacts, q, v, je._kin_ctx(jm, q))), compiler_options=LEVEL0)
  with jax.enable_x64(True):
    want = [np.asarray(x) for x in fn(q, v)]
  tq, tv = torch.from_numpy(q), torch.from_numpy(v)
  got = [x.numpy() for x in pd.dc.assemble_rows(pm, pm.contacts, tq, tv,
                                                pe._kin_ctx(pm, tq))]
  assert got[0].shape == want[0].shape == (N, 647, 62)
  for name, g, w in zip(("J", "aref", "D"), got, want):
    scale = np.maximum(1.0, np.abs(w).reshape(N, -1).max(1))
    err = np.abs(g - w).reshape(N, -1).max(1)
    assert (err <= 1e-12 * scale).all(), (name, err / scale)
  np.testing.assert_array_equal(got[3], want[3])
  assert want[3].sum(1).min() >= 4  # every lane touches


@pytest.mark.slow
def test_forward_evaluation_matches_jax_x64():
  """(qacc, fext, f) of one forward evaluation against the JAX engine's
  ``_qacc_full`` under x64 (a compile of a minute and more on one core),
  to 1e-10 relative."""
  cfg = _cfg("stand")
  jm, pm = JCLS.mdl(cfg), PCLS.mdl(cfg)
  q, v, u = _states(pm, 3, N)
  fn = jax.jit(jax.vmap(lambda q, v, u: je._qacc_full(
    jm, q, v, je.actuator_force(jm, u), want_fext=True)),
    compiler_options=LEVEL0)
  with jax.enable_x64(True):
    want = [np.asarray(x) for x in fn(q, v, u)]
  t = [torch.from_numpy(x) for x in (q, v, u)]
  got = pe._qacc_full(pm, t[0], t[1], pe.actuator_force(pm, t[2]), want_fext=True)
  for name, g, w in zip(("qacc", "fext", "f"), got, want):
    assert g.shape == w.shape, name
    rel = np.abs(g.numpy() - w).max() / max(1.0, np.abs(w).max())
    assert rel < 1e-10, (name, rel)
  assert (want[2] > 0).sum() >= 4 * N  # contact forces flowed in every lane


def _flat(obs):
  return np.concatenate([np.asarray(obs[k], np.float64).reshape(N, -1)
                         for k in sorted(obs)], 1)


def test_obs_and_rewards_match_jax():
  """Both tasks from the same state (the port's reset state after one port
  step of 10 substeps): the port's observation and reward against the
  JAX class's ``_obs`` and ``_reward``."""
  state, _, _ = PCLS.reset(_cfg("stand"), None, torch.from_numpy(init_keys(N)))
  act = torch.from_numpy(np.random.default_rng(1).uniform(
    -1, 1, (N, 56)).astype(np.float32))
  stepped = PCLS._physics(_cfg("stand"), state, act)
  readouts = PCLS._readouts(_cfg("stand"), stepped)
  cfgs = [_cfg("stand"), _cfg("run")]
  jm = JCLS.mdl(cfgs[0])

  def layer(s, a):
    # the reward's readouts from the observation: the head's height, the
    # thorax frame's zy entry (its third row's second) and the thorax
    # subtree's COM velocity, as the JAX class's step reads them
    obs = JCLS._obs(cfgs[0], s)
    return obs, [JCLS._reward(
      cfg, s, jnp.clip(a, -1.0, 1.0), obs["head_height"],
      obs["torso_vertical"][1], obs["com_velocity"]) for cfg in cfgs]
  wobs, wrews = jax.tree.map(np.asarray, jax.jit(
    jax.vmap(layer), compiler_options=LEVEL0)(
      {k: x.numpy() for k, x in stepped.items()}, act.numpy()))
  pobs = PCLS._obs(cfgs[0], stepped, *readouts)
  np.testing.assert_allclose(_flat({k: x.numpy() for k, x in pobs.items()}),
                             _flat(wobs), rtol=TOL, atol=TOL)
  xpos, xmat, comv = readouts
  head = PCLS.mdl(cfgs[0]).body_name2id["head"]
  thorax = PCLS.mdl(cfgs[0]).body_name2id["thorax"]
  for cfg, wrew in zip(cfgs, wrews):
    prew = PCLS._reward(cfg, torch.clamp(act, -1.0, 1.0), xpos[head][:, 2],
                        xmat[thorax][:, 2, 1], comv)
    np.testing.assert_allclose(prew.numpy(), wrew, rtol=TOL, atol=TOL,
                               err_msg=cfg.task_name)
    assert np.isfinite(prew.numpy()).all()
