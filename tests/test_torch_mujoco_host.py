"""The port's MuJoCo gym host tier (``envpool_torch/envs/mujoco/
gym_tasks.py`` on the ``HostEnvPool``) on the CPU: the twins of
``tests/test_mujoco.py``, and every one of the 22 host ids against the JAX
package, 2 envs x 20 steps, every output field bit for bit (the same numpy
code over the same ``mj_step``; no field needs a tolerance)."""

import numpy as np
import pytest

import envpool_torch
import envpool_tpu

from _torch_host import assert_outputs_equal, host_rollout, uniform_actions

TASK_OBS = {
  "Ant-v4": 27,
  "HalfCheetah-v4": 17,
  "Hopper-v4": 11,
  "Walker2d-v4": 17,
  "Swimmer-v4": 8,
  "Reacher-v4": 11,
  "Pusher-v4": 23,
  "InvertedPendulum-v4": 4,
  "InvertedDoublePendulum-v4": 11,
  "Humanoid-v4": 376,
  "HumanoidStandup-v4": 376,
}

# the JAX package's gym MuJoCo host ids, in its order
HOST_IDS = [
  t for t, (path, _, _) in envpool_tpu.registration.registry.specs.items()
  if path == "envpool_tpu.envs.mujoco" and "Jax" not in t
]


def _make(task_id, **kw):
  return envpool_torch.make_gymnasium(task_id, device="cpu", **kw)


def test_the_22_host_ids():
  assert len(HOST_IDS) == 22
  port = [t for t in envpool_torch.list_all_envs() if t in HOST_IDS]
  assert port == HOST_IDS


# ------------------------------------------------- twins of test_mujoco.py


@pytest.mark.parametrize("task,obs_n", sorted(TASK_OBS.items()))
def test_spec_obs_size(task, obs_n):
  spec = envpool_torch.make_spec(task, num_envs=1)
  assert spec.state_array_spec["obs"].shape == (obs_n,)


def test_reset_and_step_all():
  for task, obs_n in sorted(TASK_OBS.items()):
    env = _make(task, num_envs=2, seed=0)
    obs, info = env.reset()
    assert obs.shape == (2, obs_n), task
    act_shape = env.action_space.shape
    obs, rew, term, trunc, info = env.step(np.zeros((2, *act_shape)))
    assert obs.shape == (2, obs_n), task
    assert np.isfinite(rew).all(), task


def test_determinism():
  def traj(seed):
    env = _make("Hopper-v4", num_envs=4, seed=seed)
    obs, _ = env.reset()
    out = [obs]
    for _ in range(20):
      obs, rew, *_ = env.step(np.full((4, 3), 0.1))
      out.append(obs)
    return np.stack(out)

  t1, t2, t3 = traj(11), traj(11), traj(12)
  np.testing.assert_array_equal(t1, t2)
  assert not np.array_equal(t1, t3)


@pytest.mark.parametrize("task,act_n", [
  ("Ant-v4", 8), ("HalfCheetah-v4", 6), ("Hopper-v4", 3),
  ("Walker2d-v4", 6), ("Swimmer-v4", 2),
])
def test_align_with_gymnasium(task, act_n):
  """Step the port's env and gymnasium's from identical (qpos, qvel)."""
  import gymnasium

  ours = _make(task, num_envs=1, seed=7)
  ours.reset()
  inner = ours._envs[0]
  ref = gymnasium.make(task).unwrapped
  ref.reset()
  ref.set_state(np.copy(inner.data.qpos), np.copy(inner.data.qvel))

  rng = np.random.default_rng(0)
  for t in range(20):
    act = rng.uniform(-0.5, 0.5, act_n)
    obs, rew, term, trunc, info = ours.step(act[None])
    robs, rrew, rterm, rtrunc, rinfo = ref.step(act)
    np.testing.assert_allclose(obs[0], robs, rtol=1e-9, atol=1e-9,
                               err_msg=f"{task} obs step {t}")
    np.testing.assert_allclose(rew[0], rrew, rtol=1e-7, atol=1e-9,
                               err_msg=f"{task} reward step {t}")
    assert bool(term[0]) == bool(rterm)
    if rterm or rtrunc:
      break


def test_time_limit_truncation():
  env = _make("HalfCheetah-v4", num_envs=2, seed=0, max_episode_steps=5)
  env.reset()
  for _ in range(4):
    _, _, term, trunc, _ = env.step(np.zeros((2, 6)))
    assert not np.any(term | trunc)
  _, _, term, trunc, _ = env.step(np.zeros((2, 6)))
  assert np.all(trunc) and not np.any(term)


# --------------------------------------------- every id against the JAX one


@pytest.mark.parametrize("task_id", HOST_IDS)
def test_host_id_matches_jax_package(task_id):
  kw = dict(num_envs=2, seed=3)
  got_env = _make(task_id, **kw)
  want_env = envpool_tpu.make_gymnasium(task_id, **kw)
  assert got_env.spec.config._replace(base_path="") == \
    want_env.spec.config._replace(base_path="")
  keys = got_env.spec._state_keys
  assert keys == want_env.spec._state_keys
  acts = uniform_actions(got_env.spec, 2, 20, seed=4)
  assert_outputs_equal(keys, host_rollout(got_env, acts),
                       host_rollout(want_env, acts), task_id)
