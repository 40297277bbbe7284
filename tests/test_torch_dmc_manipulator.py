"""The port's four manipulator ids (CPU) against the JAX package: a planar
arm with a gripper, per-episode receptacle and target poses applied through
the engine's body-pose override (``fk``'s ``mut``), capsule and box
contacts, touch sensors.

A JAX manipulator pool compiles its reset (8 candidates, each through the
narrow phase) for ~40 s and its step for 15-22 s on one core, so the
layers are held one by one:

- ``fk(mut=)`` in float64 (x64) against the JAX ``fk(mut=)``, with overrides
  on the two world-parented bodies and on a nested arm body, to 1e-12;
- the specs, per id;
- the reset's draws against the JAX class's own ``reset`` (jit
  of its vmap at XLA's default level, whose multiply-add contraction the
  port's ``uniform`` mirrors), both with one candidate per lane and the
  JAX narrow phase stubbed: the arm joints, the target, the velocities and
  the object's drawn place bit for bit; an object placed in the hand (the
  grasp site and ``pi - atan2`` of the hand frame, kinematics rather than
  draws) to ``HAND_TOL``. Then the pick of 8 candidates: the one the
  port's reset keeps is the one the JAX narrow phase (under the JAX
  ``_mut``, XLA level 0) picks;
- the steps of ``ManipulatorJaxInsertPeg-v1`` (both bodies overridden, box
  rows): the JAX class's ``step`` (jit of its vmap, XLA level 0) from the
  port's reset state against the port's pool loaded with that state, on
  the observation (the log1p touch in it), the reward and the discount,
  within ``TOL`` of ``1 + |x|`` on every lane but those that part,
  counted against ``SHARE``;
- the other three tasks' layers from the port's states: the JAX ``_obs``,
  ``_reward`` and ``site_touch_forces(mut=)`` (on the port's last forward
  state and row forces) against the port's, to ``TOL``. Their whole steps
  against the JAX class's ``step`` are ``slow`` (a compile each), as is the
  JAX class's whole reset (8 candidates, the narrow phase) bit for bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_torch
from envpool_torch.core import prng
from envpool_torch.envs.mujoco import device_engine as pe
from envpool_torch.envs.mujoco.dmc import device_domains as pd
from envpool_tpu.envs.mujoco import device_collision as jc
from envpool_tpu.envs.mujoco import device_engine as je
from envpool_tpu.envs.mujoco.dmc import device_domains as jd

from _torch_parity import (
  DMC_CONTACT_SHARE as SHARE, DMC_CONTACT_TOL as TOL, init_keys, lanes_parted,
)
from test_torch_dmc_classic import assert_spec_matches

torch.set_num_threads(1)

N, STEPS = 8, 3
DRAW_LANES = 32
K = pd.DmcManipulatorJaxEnv._INIT_DRAWS
HAND_TOL = 1e-6
LEVEL0 = {"xla_backend_optimization_level": 0}
TASKS = ["bring_ball", "bring_peg", "insert_ball", "insert_peg"]
IDS = {t: "ManipulatorJax" + "".join(w.title() for w in t.split("_")) + "-v1"
       for t in TASKS}
PCLS, JCLS = pd.DmcManipulatorJaxEnv, jd.DmcManipulatorJaxEnv


def _cfg(task):
  return types.SimpleNamespace(task_name=task, frame_skip=10)


def _rotations(rng, n):
  quat = rng.normal(size=(n, 4))
  w, x, y, z = (quat / np.linalg.norm(quat, axis=1, keepdims=True)).T
  return np.stack([
    np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], 1),
    np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], 1),
    np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1),
  ], 1)


def test_fk_override_matches_jax():
  mdl = PCLS.mdl(_cfg("insert_peg"))
  rng = np.random.default_rng(0)
  lanes = 16
  q = mdl.init_qpos + rng.uniform(-2, 2, (lanes, mdl.nq))
  bodies = [mdl.body_name2id["target_peg"], mdl.body_name2id["slot"], 3]
  assert [mdl.parent[b] for b in bodies] == [0, 0, 2]
  mut = {b: (rng.uniform(-1, 1, (lanes, 3)), _rotations(rng, lanes))
         for b in bodies}
  with jax.enable_x64(True):
    want = jax.jit(jax.vmap(lambda q, m: je.fk(mdl, q, m)))(q, mut)
    want = jax.tree.map(np.asarray, want)
  got = pe.fk(mdl, torch.from_numpy(q), {
    b: (torch.from_numpy(p), torch.from_numpy(r)) for b, (p, r) in mut.items()})
  for tag, g, w in zip(("xpos", "xmat"), got[:2], want[:2]):
    for b in range(mdl.nbody):
      np.testing.assert_allclose(g[b].numpy(), w[b], rtol=0, atol=1e-12,
                                 err_msg=f"{tag} {b}")
  for tag, g, w in zip(("anchors", "axes"), got[2:], want[2:]):
    assert sorted(g) == sorted(w), tag
    for d in w:
      np.testing.assert_allclose(g[d].numpy(), w[d], rtol=0, atol=1e-12,
                                 err_msg=f"{tag} {d}")
  # a world-parented override is the body's world frame exactly
  for b in bodies[:2]:
    np.testing.assert_array_equal(got[0][b].numpy(), mut[b][0])
    np.testing.assert_array_equal(got[1][b].numpy(), mut[b][1])


@pytest.mark.parametrize("task", TASKS)
def test_spec_matches_jax_package(task):
  assert_spec_matches(IDS[task])


def _in_hand(keys):
  """Per lane, whether its one candidate's object starts in the hand (its
  init choice in (0.1, 0.2]; ``_INIT_DRAWS`` 1)."""
  ks = prng.split(prng.split(torch.from_numpy(keys), 1).flatten(0, 1), 10)
  choice = prng.uniform(prng.split(ks[:, 9], 7)[:, 2], (), 0.0, 1.0).numpy()
  return (choice > np.float32(0.1)) & (choice <= np.float32(0.2))


@pytest.mark.parametrize("task", ["bring_peg", "insert_ball"])
def test_reset_draws_match_jax_class(task, monkeypatch):
  """The reset's draws on the keys of a pool's init: the JAX class's own
  ``reset`` and the port's, each with one candidate per lane (the 8
  candidates are 8 copies of one key tree; one compiles in seconds) and
  the JAX narrow phase stubbed (every candidate free). The two tasks have
  the two target-angle ranges, both props and both sets of overridden
  bodies (bring_ball and insert_peg draw as bring_peg and insert_ball do;
  the ``slow`` whole-reset check holds all four)."""
  cfg = _cfg(task)
  keys = init_keys(DRAW_LANES)
  for cls in (PCLS, JCLS):
    monkeypatch.setattr(cls, "_INIT_DRAWS", 1)

  def free(cd, xpos, xmat, dtype):
    p = cd.point_b1.shape[0]
    return None, jnp.ones(p, dtype), None, None, None, jnp.ones(p, bool)
  monkeypatch.setattr(jc, "contact_points", free)
  want = jax.tree.map(np.asarray, jax.jit(jax.vmap(
    lambda k: JCLS.reset(cfg, None, k)[0]))(keys.astype(np.uint32)))
  got = PCLS.reset(cfg, None, torch.from_numpy(keys))[0]
  got = {k: v.numpy() for k, v in got.items()}
  hand = _in_hand(keys)
  assert 0 < hand.sum() < len(hand)
  assert sorted(got) == sorted(want)
  for k in ("target", "v", "touch"):
    np.testing.assert_array_equal(got[k], want[k], k)
  np.testing.assert_array_equal(got["q"][:, :8], want["q"][:, :8])
  np.testing.assert_array_equal(got["q"][~hand], want["q"][~hand])
  np.testing.assert_allclose(got["q"][hand], want["q"][hand], rtol=0, atol=HAND_TOL)


@pytest.mark.parametrize("task", TASKS)
def test_reset_pick_matches_jax_narrow_phase(task):
  """The candidate the port's reset keeps is the one the JAX narrow phase
  of the port's 8 candidates per lane (under the JAX ``_mut``) picks: the
  first collision-free one, else the least penetrating."""
  cfg = _cfg(task)
  keys = torch.from_numpy(init_keys(N))
  qc, vc, target = (x.numpy() for x in PCLS._candidates(cfg, keys))
  jm = JCLS.mdl(cfg)

  def points(q, tgt):
    xpos, xmat, _, _ = je.fk(jm, q, JCLS._mut(cfg, tgt))
    _, dist, _, _, _, gate = jc.contact_points(jm.contacts, xpos, xmat, q.dtype)
    return dist, gate
  dist, gate = (np.asarray(x).reshape(N, K, -1) for x in jax.jit(
    jax.vmap(points), compiler_options=LEVEL0)(qc, target))
  ok = ((dist >= 0) | ~gate).all(-1)
  pick = np.where(ok.any(1), ok.argmax(1),
                  np.where(gate, dist, np.inf).min(-1).argmax(1))
  state, obs, _ = PCLS.reset(cfg, None, keys)
  for k, cands in (("q", qc), ("v", vc), ("target", target)):
    np.testing.assert_array_equal(state[k].numpy(),
                                  cands.reshape(N, K, -1)[np.arange(N), pick], k)
  assert (state["touch"].numpy() == 0).all()
  assert all(np.isfinite(v.numpy()).all() for v in obs.values())


def _flat(obs, n):
  return np.concatenate([np.asarray(obs[k], np.float64).reshape(n, -1)
                         for k in sorted(obs)], 1)


def _jax_step(cfg):
  return jax.jit(jax.vmap(lambda s, a: JCLS.step(cfg, s, a, None)),
                 compiler_options=LEVEL0)


def _steps_against_jax(task):
  """The port's pool from its reset state against the JAX class's step
  over ``STEPS`` numpy-seeded actions; asserts the parted share."""
  cfg = _cfg(task)
  state, _, _ = PCLS.reset(cfg, None, torch.from_numpy(init_keys(N)))
  jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
  pool = envpool_torch.make_gymnasium(IDS[task], num_envs=N, seed=0, device="cpu")
  pool.async_reset()
  pool._recv()
  pool.load_state(pool.save_state()._replace(
    env={k: np.asarray(v) for k, v in jstate.items()}))
  keys = pool.spec._state_keys
  acts = np.random.default_rng(1).uniform(-1, 1, (STEPS, N, 5)).astype(np.float32)
  jstep = _jax_step(cfg)
  got, want = [], []
  for a in acts:
    jstate, jobs, jrew, jterm, jinfo = jstep(jstate, jnp.asarray(a))
    pool.send(a)
    out = dict(zip(keys, (np.array(x, copy=True) for x in pool._recv())))
    got.append(tuple(out[k] for k in keys if k.startswith("obs:"))
               + (out["reward"], out["discount"], out["done"]))
    want.append(tuple(np.asarray(jobs[k[4:]]) for k in keys if k.startswith("obs:"))
                + (np.asarray(jrew), np.asarray(jinfo["discount"]),
                   np.asarray(jterm)))
  names = [k for k in keys if k.startswith("obs:")] + ["reward", "discount", "done"]
  parted, worst = lanes_parted(names, got, want, TOL)
  assert parted.mean() <= SHARE, (parted, worst)
  return got


def test_insert_peg_steps_match_jax_package():
  got = _steps_against_jax("insert_peg")
  # the box and capsule contacts of the props and receptacle are reached:
  # the episode's object starts in or at the slot in some lanes
  assert all(np.isfinite(x).all() for out in got for x in out[:-1])


@pytest.mark.slow
@pytest.mark.parametrize("task", ["bring_ball", "bring_peg", "insert_ball"])
def test_steps_match_jax_package(task):
  _steps_against_jax(task)


@pytest.mark.parametrize("task", ["bring_ball", "bring_peg", "insert_ball"])
def test_obs_reward_touch_layers_match_jax(task):
  """From the port's reset state and one port step of it: the port's
  ``_obs``, ``_reward`` and ``site_touch_forces(mut=)`` (at the step's last
  forward state and row forces) against the JAX functions on the same
  inputs."""
  cfg = _cfg(task)
  mdl = PCLS.mdl(cfg)
  state, _, _ = PCLS.reset(cfg, None, torch.from_numpy(init_keys(N)))
  act = torch.from_numpy(np.random.default_rng(2).uniform(
    -1, 1, (N, 5)).astype(np.float32))
  mut = PCLS._mut(cfg, state["target"])
  q, v, (q_fwd, _, _, f_rows) = pe.step_smooth(
    mdl, state["q"], state["v"], act, nstep=10, want_aux=True, mut=mut)
  touch = pd.site_touch_forces(mdl, q_fwd, f_rows, PCLS._TOUCH_SITES, mut=mut)
  stepped = {**state, "q": q, "v": v, "touch": touch}
  jm = JCLS.mdl(cfg)

  def layers(s, q_fwd, f_rows):
    return (JCLS._obs(cfg, s), JCLS._reward(cfg, s), jd.site_touch_forces(
      jm, q_fwd, f_rows, list(JCLS._TOUCH_SITES), mut=JCLS._mut(cfg, s["target"])))
  run = jax.jit(jax.vmap(layers), compiler_options=LEVEL0)
  wobs, wrew, wtouch = (jax.tree.map(np.asarray, x) for x in run(
    {k: x.numpy() for k, x in stepped.items()}, q_fwd.numpy(), f_rows.numpy()))
  np.testing.assert_allclose(touch.numpy(), wtouch, rtol=TOL, atol=TOL)
  xpos, xmat, _, _ = pe.fk(mdl, q, mut)
  gobs = {k: x.numpy() for k, x in PCLS._obs(cfg, stepped, xpos).items()}
  np.testing.assert_allclose(_flat(gobs, N), _flat(wobs, N), rtol=TOL, atol=TOL)
  np.testing.assert_allclose(PCLS._reward(cfg, xpos, xmat).numpy(), wrew,
                             rtol=TOL, atol=TOL)
  assert (touch.numpy() >= 0).all()


@pytest.mark.slow
@pytest.mark.parametrize("task", TASKS)
def test_reset_matches_jax_class_bit_for_bit(task):
  """The JAX class's whole reset (its narrow phase and pick too), compiled
  at XLA's default level: the drawn fields bit for bit, a hand-placed
  object to ``HAND_TOL``."""
  cfg = _cfg(task)
  keys = init_keys(N)
  want, wobs, _ = jax.jit(jax.vmap(lambda k: JCLS.reset(cfg, None, k)))(
    keys.astype(np.uint32))
  got, gobs, _ = PCLS.reset(cfg, None, torch.from_numpy(keys))
  for k in ("target", "v", "touch"):
    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
  np.testing.assert_array_equal(got["q"].numpy()[:, :8], np.asarray(want["q"])[:, :8])
  np.testing.assert_allclose(got["q"].numpy(), np.asarray(want["q"]), rtol=0,
                             atol=HAND_TOL)
  np.testing.assert_allclose(_flat({k: x.numpy() for k, x in gobs.items()}, N),
                             _flat(jax.tree.map(np.asarray, wobs), N),
                             rtol=TOL, atol=TOL)
