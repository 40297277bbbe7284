"""The port's four humanoid ids (CPU, float32) against the JAX package:
free quaternion root, 21 hinges, box feet on the floor (plane-box), 28
sphere/capsule-box candidates, 352 rows and a 16-iteration Newton solve.

A JAX humanoid pool compiles its reset (16 candidate draws, each through
the narrow phase) and its step in several minutes on one core, so the
layers are held one by one here, as the twin tests of the shared model
may be:

- specs equal, per id;
- the reset: the 16 candidates' draws on the keys of a pool's init (the JAX randomizer at XLA's default level against the port's:
  the hinges bit for bit, the root quaternion, a normalised ``normal``
  draw, within ``QUAT_ULPS``), and the candidate the port's reset picks is
  the one the JAX narrow phase picks (the first collision-free one, else
  the least penetrating, from the JAX ``contact_points`` of each
  candidate);
- the steps of ``HumanoidJaxRun-v1``: the JAX class's ``step`` (jit of its
  vmap, XLA level 0) from the port's reset state, against the port's pool
  from the same state (``load_state``: the JAX state carried in by
  ``state_from_numpy``), every output within ``TOL`` of ``1 + |x|`` on
  every lane but those that part, counted against ``SHARE``;
- stand, walk and run_pure_state share the model and the physics: their
  observations and rewards, the port's class ``step`` from the same
  states, against the JAX class's ``_obs`` and ``_reward`` on the JAX
  step's states.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_torch
from envpool_torch.envs.mujoco.dmc import device_domains as pd
from envpool_tpu.envs.mujoco import device_collision as jc
from envpool_tpu.envs.mujoco import device_engine as je
from envpool_tpu.envs.mujoco.dmc import device_domains as jd

from _torch_parity import (
  DMC_CONTACT_SHARE as SHARE, DMC_CONTACT_TOL as TOL, init_keys, lanes_parted,
  ulps,
)
from test_torch_dmc_classic import assert_spec_matches

torch.set_num_threads(1)

QUAT_ULPS = 8
N, STEPS = 4, 4
TASKS = ["HumanoidJaxStand-v1", "HumanoidJaxWalk-v1", "HumanoidJaxRun-v1",
         "HumanoidJaxRunPureState-v1"]
LEVEL0 = {"xla_backend_optimization_level": 0}


def _cfg(task):
  return types.SimpleNamespace(task_name=task, frame_skip=5)


@pytest.mark.parametrize("task_id", TASKS)
def test_spec_matches_jax_package(task_id):
  assert_spec_matches(task_id)


def test_reset_candidates_and_pick():
  cfg = _cfg("run")
  jm = jd.DmcHumanoidJaxEnv.mdl(cfg)
  pm = pd.DmcHumanoidJaxEnv.mdl(cfg)
  k = pd.DmcHumanoidJaxEnv._INIT_DRAWS
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
  assert ok.any(1).sum() >= 1  # some lane has a collision-free candidate
  state, _, _ = pd.DmcHumanoidJaxEnv.reset(cfg, None, torch.from_numpy(keys))
  chosen = want.reshape(N, k, -1)[np.arange(N), pick]
  q = state["q"].numpy()
  np.testing.assert_array_equal(q[:, 7:], chosen[:, 7:])
  assert ulps(q[:, 3:7], chosen[:, 3:7]).max() <= QUAT_ULPS


def _flat(obs):
  return np.concatenate([np.asarray(obs[k], np.float64).reshape(N, -1)
                         for k in sorted(obs)], 1)


def test_steps_and_tasks_match_jax_package():
  cfgs = {t: _cfg(t) for t in ("stand", "walk", "run", "run_pure_state")}
  keys = init_keys(N)
  state, _, _ = pd.DmcHumanoidJaxEnv.reset(cfgs["run"], None,
                                           torch.from_numpy(keys))
  acts = np.random.default_rng(1).uniform(-1, 1, (STEPS, N, 21)).astype(np.float32)
  jstep = jax.jit(jax.vmap(lambda s, a: jd.DmcHumanoidJaxEnv.step(
    cfgs["run"], s, a, None)), compiler_options=LEVEL0)

  def task_layer(task):
    cls, cfg = jd.DmcHumanoidJaxEnv, cfgs[task]
    jm = cls.mdl(cfg)

    def f(s, a):
      xpos, xmat, _, _ = je.fk(jm, s["q"])
      reward = cls._reward(cfg, s, jnp.clip(a, -1.0, 1.0),
                           xpos[jm.body_name2id["head"]][2],
                           xmat[jm.body_name2id["torso"]][2, 2],
                           je.subtree_linvel(jm, s["q"], s["v"], "torso"))
      return cls._obs(cfg, s), reward
    return jax.jit(jax.vmap(f))
  layers = {t: task_layer(t) for t in cfgs if t != "run"}

  # the port's pool, started from the port's reset state carried in as a
  # JAX-laid-out snapshot, against the JAX class's step
  pool = envpool_torch.make_gymnasium("HumanoidJaxRun-v1", num_envs=N, seed=0,
                                      device="cpu")
  pool.async_reset()
  pool._recv()
  jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
  pool.load_state(pool.save_state()._replace(
    env={k: np.asarray(v) for k, v in jstate.items()}))
  keys_spec = pool.spec._state_keys
  got, want = [], []
  for a in acts:
    pstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    jstate, jobs, jrew, jterm, jinfo = jstep(jstate, jnp.asarray(a))
    pool.send(a)
    out = dict(zip(keys_spec, (np.array(x, copy=True) for x in pool._recv())))
    got.append(tuple(out[k] for k in keys_spec if k.startswith("obs:"))
               + (out["reward"], out["discount"], out["done"]))
    want.append(tuple(np.asarray(jobs[k[4:]]) for k in keys_spec
                      if k.startswith("obs:"))
                + (np.asarray(jrew), np.asarray(jinfo["discount"]),
                   np.asarray(jterm)))
    for task, layer in layers.items():
      # the other tasks' layer: the port's class step from the same state
      cls, cfg = pd.DmcHumanoidJaxEnv, cfgs[task]
      _, pobs, prew, _, _ = cls.step(cfg, pstate, torch.from_numpy(a), None)
      wobs, wrew = layer(jstate, jnp.asarray(a))
      np.testing.assert_allclose(
        _flat({k: v.numpy() for k, v in pobs.items()}),
        _flat(jax.tree.map(np.asarray, wobs)), rtol=TOL, atol=TOL, err_msg=task)
      np.testing.assert_allclose(prew.numpy(), np.asarray(wrew),
                                 rtol=TOL, atol=TOL, err_msg=task)
  names = [k for k in keys_spec if k.startswith("obs:")] + [
    "reward", "discount", "done"]
  parted, worst = lanes_parted(names, got, want, TOL)
  assert parted.mean() <= SHARE, (parted, worst)
