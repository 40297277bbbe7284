"""The port's four contact-free on-device MuJoCo ids (CPU, float32) against
the JAX package: ``ReacherJax-v4``, ``InvertedPendulumJax-v4``,
``InvertedDoublePendulumJax-v4`` and ``SwimmerJax-v4``.

Per id the specs are equal, and the reset from the pool's own keys is bit
for bit in ``q`` and ``v`` (threefry uniform draws added to ``qpos0``),
except where it passes through transcendental functions, held to 2 ulp of
8: Reacher's goal (sqrt, cos, sin) and InvertedDoublePendulum's ``v``
(``normal``'s erfinv); the reset observations to 1e-6. Then both pools
(``pool_parity``): reset + 100 steps from seed 0 under numpy-seeded
uniform actions, and 30 more steps of a fresh port pool from the JAX
pool's state after those 100, carried by ``state_from_numpy``. Reacher and
InvertedPendulum run here, InvertedDoublePendulum and Swimmer in
``tests/test_torch_mujoco_tasks_chaotic.py`` (each file then stays near a
minute on one core, most of it XLA compiles).
"""

import jax
import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu

from _torch_parity import jax_rollout_states, lanes_parted

torch.set_num_threads(1)

N = 16
STEPS, CARRIED = 100, 30
TOL = 1e-3   # float fields: |port - jax| <= TOL * (1 + |jax|)
# task id -> (action width, action bound, share of lanes that may part);
# no lane of any id parted when the bounds were set, and the two chaotic
# ids may lose 2 of 16 lanes to a changed seed or library
TASKS = {
  "ReacherJax-v4": (2, 1.0, 0.0),
  "InvertedPendulumJax-v4": (1, 3.0, 0.0),
  "InvertedDoublePendulumJax-v4": (1, 1.0, 0.125),
  "SwimmerJax-v4": (2, 1.0, 0.125),
}
ULP2 = float(2 * np.spacing(np.float32(8.0)))


@pytest.mark.parametrize("task_id", list(TASKS))
def test_spec_matches_jax_package(task_id):
  got, want = envpool_torch.make_spec(task_id), envpool_tpu.make_spec(task_id)
  assert got.config._replace(base_path="") == want.config._replace(base_path="")
  for g_spec, w_spec in ((got.state_array_spec, want.state_array_spec),
                         (got.action_array_spec, want.action_array_spec)):
    assert list(g_spec) == list(w_spec)
    for k in w_spec:
      g, w = g_spec[k], w_spec[k]
      assert (g.dtype, g.shape) == (w.dtype, w.shape), (task_id, k)
      np.testing.assert_array_equal(g.minimum, w.minimum)
      np.testing.assert_array_equal(g.maximum, w.maximum)


@pytest.mark.parametrize("task_id", list(TASKS))
def test_reset_from_pool_keys(task_id):
  """Both packages' reset functions on the keys the pool's first advance
  draws (``fold_in(PRNGKey(0), i)``, split twice)."""
  env = envpool_tpu.make_gymnasium(task_id, num_envs=N, seed=0)
  cfg = env.spec.config
  rng = env.xla()[0].pool.rng
  sub = np.asarray(jax.vmap(lambda k: jax.random.split(k)[1])(rng))
  jax_cls = env.spec._env_cls
  w_st, w_obs, _ = jax.jit(jax.vmap(lambda k: jax_cls.reset(cfg, None, k)))(sub)
  port_cls = envpool_torch.make_spec(task_id)._env_cls
  g_st, g_obs, _ = port_cls.reset(cfg, None, torch.from_numpy(sub.astype(np.int64)))
  for k in ("q", "v"):
    g, w = g_st[k].numpy(), np.asarray(w_st[k])
    if (task_id, k) == ("ReacherJax-v4", "q"):
      np.testing.assert_array_equal(g[:, :2], w[:, :2])
      np.testing.assert_allclose(g[:, 2:], w[:, 2:], rtol=0, atol=ULP2)
    elif (task_id, k) == ("InvertedDoublePendulumJax-v4", "v"):
      np.testing.assert_allclose(g, w, rtol=0, atol=ULP2)
    else:
      np.testing.assert_array_equal(g, w, err_msg=k)
  np.testing.assert_allclose(g_obs.numpy(), np.asarray(w_obs), rtol=0, atol=1e-6)


def _port_steps(env, acts):
  outs = []
  for a in acts:
    env.send(a)
    outs.append(tuple(env._recv()))
  return outs


def pool_parity(task_id):
  """Reset + STEPS steps of both pools from seed 0, then CARRIED steps of a
  fresh port pool from the JAX pool's state: integer and bool fields equal
  and floats within TOL on every lane but those that part, counted against
  the id's bound."""
  width, bound, share = TASKS[task_id]
  acts = np.random.default_rng(1).uniform(
    -bound, bound, (STEPS + CARRIED, N, width)).astype(np.float32)
  # compiled at XLA's backend optimisation level 0: half the compile time
  keys, want, pools = jax_rollout_states(
    task_id, dict(num_envs=N, seed=0), acts,
    compiler_options={"xla_backend_optimization_level": 0})

  env = envpool_torch.make_gymnasium(task_id, num_envs=N, seed=0, device="cpu")
  env.async_reset()
  got = [tuple(env._recv())] + _port_steps(env, acts[:STEPS])
  parted, worst = lanes_parted(keys, got, want[:STEPS + 1], TOL)

  carried = jax.tree.map(lambda x: x[STEPS], pools)
  ps = envpool_torch.state_from_numpy(carried, "cpu")
  np.testing.assert_array_equal(ps.env["q"].numpy(), carried.env["q"])
  np.testing.assert_array_equal(ps.rng.numpy(), carried.rng.astype(np.int64))
  env2 = envpool_torch.make_gymnasium(task_id, num_envs=N, seed=0, device="cpu")
  env2.load_state(carried)
  got2 = _port_steps(env2, acts[STEPS:])
  parted2, worst2 = lanes_parted(keys, got2, want[STEPS + 1:], TOL)
  res = dict(parted=int(parted.sum()), parted_carried=int(parted2.sum()),
             worst=float(worst[~parted].max(initial=0)),
             worst_carried=float(worst2[~parted2].max(initial=0)))
  assert parted.mean() <= share and parted2.mean() <= share, (task_id, res)
  return keys, got, res


@pytest.mark.parametrize("task_id", ["ReacherJax-v4", "InvertedPendulumJax-v4"])
def test_pool_matches_jax_package(task_id):
  keys, got, _ = pool_parity(task_id)
  if task_id == "ReacherJax-v4":
    # every lane truncates at its cap of 50 and restarts
    elapsed = np.stack([g[keys.index("elapsed_step")] for g in got])
    trunc = np.stack([g[keys.index("trunc")] for g in got])
    assert (elapsed[50] == 50).all() and trunc[50].all() and (elapsed[51] == 0).all()
