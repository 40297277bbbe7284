"""The port's six contact ids (CPU, float32) against the JAX package's pools:
``HalfCheetahJax-v4``, ``HopperJax-v4``, ``Walker2dJax-v4``, ``AntJax-v4``,
``HumanoidJax-v4`` and ``HumanoidStandupJax-v4``.

Per id the specs are equal. Then (``contact_pool_parity``) the port's
reset function on the keys the pool's first advance draws against the JAX
reset's draws: ``q`` bit for bit (threefry uniform draws added to
``qpos0``), ``v`` too where it is a uniform draw (Hopper, Walker2d, the
Humanoids) and within 4 ulps where it is ``normal`` (HalfCheetah, Ant:
erfinv); the draws compiled at XLA's default level, whose multiply-add
contraction the port's ``uniform`` mirrors. The reset observations (and
Humanoid's ``mc``) to 1e-6 of the JAX pool's (Humanoid's ``cinert`` and
``cvel`` parts are float32 products of that state). Then both pools
run from seed 0 under numpy-seeded uniform actions, and every step's
outputs: integer and bool fields equal and floats within ``TOL`` of
``1 + |x|`` on every lane but those that part, counted against the id's
bound (float32 contact dynamics are stiff: a lane whose contact set flips
on a rounding difference parts). Last, a fresh port pool loaded with the
JAX pool's state after the id's "carried at" steps (``state_from_numpy``,
the Humanoids' ``mc`` too) steps the remaining actions against the JAX
pool's outputs. HalfCheetah and Hopper run here; Walker2d and Ant, and each
Humanoid, in files of their own (``test_torch_mujoco_contact_tasks_*.py``),
so that each file, most of it JAX compiles, stays near a minute and a half
on one core.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu

from _torch_parity import jax_rollout_states, lanes_parted

torch.set_num_threads(1)

TOL = 1e-3
# id -> (envs, steps, carried at, share of lanes that may part). No lane of
# Hopper, Walker2d, Ant or the Humanoids parted when the bounds were set
# (2 of 16 may, for a changed library). HalfCheetah's Euler contacts part
# lanes at float32 rounding: 6 of 16 here over 20 steps, and the JAX
# package against itself, compiled at two XLA optimisation levels, 7 of 16
TASKS = {
  "HalfCheetahJax-v4": (16, 20, 14, 0.5),
  "HopperJax-v4": (16, 20, 14, 0.125),
  "Walker2dJax-v4": (16, 20, 14, 0.125),
  "AntJax-v4": (16, 20, 14, 0.125),
  "HumanoidJax-v4": (8, 6, 3, 0.125),
  "HumanoidStandupJax-v4": (8, 6, 3, 0.125),
}
NORMAL_V = ("HalfCheetahJax-v4", "AntJax-v4")


def _ordered(x: np.ndarray) -> np.ndarray:
  """float32 bits as integers ordered like the floats (for ulp distance)."""
  i = x.view(np.int32).astype(np.int64)
  return np.where(i < 0, -(i & 0x7FFFFFFF), i)


@pytest.mark.parametrize("task_id", list(TASKS))
def test_spec_matches_jax_package(task_id):
  got, want = envpool_torch.make_spec(task_id), envpool_tpu.make_spec(task_id)
  assert got.config._replace(base_path="") == want.config._replace(base_path="")
  assert got._env_cls.__name__ == want._env_cls.__name__
  for g_spec, w_spec in ((got.state_array_spec, want.state_array_spec),
                         (got.action_array_spec, want.action_array_spec)):
    assert list(g_spec) == list(w_spec)
    for k in w_spec:
      g, w = g_spec[k], w_spec[k]
      assert (g.dtype, g.shape) == (w.dtype, w.shape), (task_id, k)
      np.testing.assert_array_equal(g.minimum, w.minimum)
      np.testing.assert_array_equal(g.maximum, w.maximum)


def _recv(env):
  return tuple(x.copy() for x in env._recv())


def _check_reset(task_id, n, obs0, state0):
  """The port's reset function on the keys of the pool's first advance
  (``fold_in(PRNGKey(0), i)``, split twice): ``q`` and ``v`` against the
  JAX reset's draws (``kq, kv = split(key)``, compiled at XLA's default
  level), the observation and Humanoid's ``mc`` against the JAX pool's
  reset outputs ``obs0`` and ``state0``."""
  env = envpool_tpu.make_gymnasium(task_id, num_envs=n, seed=0)
  cfg = env.spec.config
  rng = env.xla()[0].pool.rng
  sub = np.asarray(jax.vmap(lambda k: jax.random.split(k)[1])(rng))
  port_cls = envpool_torch.make_spec(task_id)._env_cls
  mdl = port_cls.mdl()
  s = float(cfg.reset_noise_scale)

  def draws(key):
    kq, kv = jax.random.split(key)
    q = jnp.asarray(mdl.init_qpos, jnp.float32) + jax.random.uniform(
      kq, (mdl.nq,), jnp.float32, -s, s)
    if task_id in NORMAL_V:
      return q, s * jax.random.normal(kv, (mdl.nv,), jnp.float32)
    return q, jax.random.uniform(kv, (mdl.nv,), jnp.float32, -s, s)
  w_q, w_v = (np.asarray(x) for x in jax.jit(jax.vmap(draws))(sub))
  g_st, g_obs, _ = port_cls.reset(
    cfg, None, torch.from_numpy(sub.astype(np.int64)))
  assert sorted(g_st) == sorted(state0)
  np.testing.assert_array_equal(g_st["q"].numpy(), w_q)
  if task_id in NORMAL_V:
    assert np.abs(_ordered(g_st["v"].numpy()) - _ordered(w_v)).max() <= 4
  else:
    np.testing.assert_array_equal(g_st["v"].numpy(), w_v)
  np.testing.assert_allclose(g_obs.numpy(), obs0, rtol=1e-6, atol=1e-6)
  if "mc" in state0:
    np.testing.assert_allclose(g_st["mc"].numpy(), state0["mc"],
                               rtol=1e-6, atol=1e-7)


def contact_pool_parity(task_id):
  """The reset, the rollout and the carried steps of ``task_id`` against
  the JAX package (see the module docstring); returns the counts."""
  n, steps, carried_at, share = TASKS[task_id]
  spec = envpool_torch.make_spec(task_id).action_array_spec["action"]
  acts = np.random.default_rng(1).uniform(
    spec.minimum, spec.maximum, (steps, n, spec.shape[-1])).astype(np.float32)
  # compiled at XLA's backend optimisation level 0: half the compile time
  keys, want, pools = jax_rollout_states(
    task_id, dict(num_envs=n, seed=0), acts,
    compiler_options={"xla_backend_optimization_level": 0})

  env = envpool_torch.make_gymnasium(task_id, num_envs=n, seed=0, device="cpu")
  env.async_reset()
  got = [_recv(env)]
  for a in acts:
    env.send(a)
    got.append(_recv(env))
  _check_reset(task_id, n, want[0][keys.index("obs")],
               jax.tree.map(lambda x: x[0], pools).env)

  parted, worst = lanes_parted(keys, got, want, TOL)

  # the JAX pool's state after ``carried_at`` steps, stepped by the port
  carried = jax.tree.map(lambda x: x[carried_at], pools)
  env2 = envpool_torch.make_gymnasium(task_id, num_envs=n, seed=0, device="cpu")
  env2.load_state(carried)
  np.testing.assert_array_equal(env2.save_state().env["q"], carried.env["q"])
  got2 = []
  for a in acts[carried_at:]:
    env2.send(a)
    got2.append(_recv(env2))
  parted2, worst2 = lanes_parted(keys, got2, want[carried_at + 1:], TOL)
  res = dict(parted=int(parted.sum()), parted_carried=int(parted2.sum()),
             worst=float(worst[~parted].max(initial=0)),
             worst_carried=float(worst2[~parted2].max(initial=0)))
  assert parted.mean() <= share and parted2.mean() <= share, (task_id, res)
  return res


@pytest.mark.parametrize("task_id", ["HalfCheetahJax-v4", "HopperJax-v4"])
def test_pool_matches_jax_package(task_id):
  contact_pool_parity(task_id)
