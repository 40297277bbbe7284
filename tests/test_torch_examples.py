"""The port's example scripts (``envpool_torch/examples/``) through their
``main`` on the CPU at a tiny size: the printed lines carry the JAX
scripts' fields, every number finite; ``async_loop`` where ``mujoco``
imports; the four library examples with their adapters driven alone
(none of the libraries is installed). And the twin of
``tests/test_learning.py::test_ppo_learns_inverted_pendulum_continuous`` on
the port, with its configuration, seed and bars."""

import math
import re
import sys

import numpy as np
import pytest
import torch

import envpool_torch
from envpool_torch.examples import (
  acme_example,
  async_loop,
  cleanrl_ppo,
  ppo_mujoco,
  ppo_sokoban,
  sb3_example,
  tianshou_example,
  xla_step,
)
from envpool_torch.models import GaussianMLPActorCritic
from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--num-envs", "8", "--num-steps", "4"]
_NUM = r"([-+]?[\d,]*\.?\d+(?:e[-+]?\d+)?|nan|inf)"


def _fields(line: str, names) -> dict:
  out = {}
  for name in names:
    m = re.search(re.escape(name) + r"\s+" + _NUM, line)
    assert m, (name, line)
    out[name] = float(m.group(1).replace(",", ""))
  return out


@pytest.mark.parametrize("iterations", [1, 2])
def test_ppo_sokoban(capsys, iterations):
  history = ppo_sokoban.main(TINY + ["--iterations", str(iterations)])
  lines = capsys.readouterr().out.strip().splitlines()
  assert len(lines) == len(history) == iterations
  for it, line in enumerate(lines):
    assert line.startswith(f"iter {it:4d}  reward/step "), line
    got = _fields(line, ("reward/step", "pg", "v", "ent", "sps"))
    assert all(math.isfinite(x) for x in got.values()), line
    assert got["sps"] > 0 and got["v"] >= 0 and got["ent"] > 0
    assert sorted(history[it]) == ["entropy", "mean_reward", "pg_loss", "sps", "v_loss"]


def test_ppo_mujoco(capsys):
  history = ppo_mujoco.main(TINY + ["--iterations", "1"])
  (line,) = capsys.readouterr().out.strip().splitlines()
  assert line.startswith("iter    0  reward ") and line.endswith(" env-steps/s"), line
  got = _fields(line, ("reward", "pg", "v"))
  sps = float(line.split()[-2].replace(",", ""))
  assert all(math.isfinite(x) for x in [*got.values(), sps]), line
  assert got["reward"] == pytest.approx(history[0]["mean_reward"], abs=5e-5)


def test_ppo_mujoco_other_task(capsys):
  ppo_mujoco.main(["--device", "cpu", "--task", "ReacherJax-v4", "--num-envs", "4",
                   "--num-steps", "2", "--iterations", "1"])
  (line,) = capsys.readouterr().out.strip().splitlines()
  assert all(math.isfinite(x) for x in _fields(line, ("reward", "pg", "v")).values())


def test_xla_step(capsys):
  mean = xla_step.main(["--device", "cpu", "--num-envs", "8", "--num-steps", "30"])
  (line,) = capsys.readouterr().out.strip().splitlines()
  assert line == f"mean reward per step: {mean}"
  # the first recv is the reset's (reward 0); the lean-following policy
  # then keeps CartPole up, reward 1 per step
  assert 0.9 < mean < 1.0


def test_xla_step_matches_the_host_loop():
  """The example's functional loop gives the rewards of the same policy
  run through the host API."""
  n, steps = 8, 12
  mean = xla_step.main(["--device", "cpu", "--num-envs", str(n), "--num-steps", str(steps)])
  env = envpool_torch.make_gymnasium("CartPole-v1", num_envs=n, seed=0, device="cpu")
  obs, _ = env.reset()
  rewards = [np.zeros(n)]
  for _ in range(steps - 1):
    obs, rew, term, trunc, info = env.step((obs[:, 2] > 0).astype(np.int32))
    rewards.append(rew)
  assert mean == pytest.approx(float(np.mean(rewards)), rel=1e-6)


def test_async_loop(capsys):
  pytest.importorskip("mujoco")
  mean = async_loop.main(["--device", "cpu", "--rounds", "12"])
  (line,) = capsys.readouterr().out.strip().splitlines()
  assert line == f"mean return so far: {mean}"
  assert math.isfinite(mean)


def test_examples_default_to_the_card():
  """Without ``--device`` an example takes the CUDA device, and without
  one it raises (the CPU is never a fallback)."""
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is valid")
  with pytest.raises(RuntimeError, match="cpu"):
    xla_step.main(["--num-envs", "2", "--num-steps", "1"])
  with pytest.raises(RuntimeError, match="CUDA"):
    ppo_sokoban.main(["--num-envs", "8", "--iterations", "1"])


# ------------------------------------------------- test_learning.py twin


def test_ppo_learns_inverted_pendulum_continuous() -> None:
  """``tests/test_learning.py::test_ppo_learns_inverted_pendulum_continuous``
  on the port, unsharded, with its configuration, ``ppo_init`` seed 0 (the
  port's own parameter draws) and its bars. On this CPU the best
  post-warmup reward is 0.9739 against the 0.97 bar; about 45 s."""
  pool = envpool_torch.make_gymnasium(
    "InvertedPendulumJax-v4", num_envs=64, seed=0, device="cpu")
  net = GaussianMLPActorCritic(action_dim=1, hidden=(64, 64))
  cfg = PPOConfig(
    continuous=True, num_steps=64, update_epochs=4, num_minibatches=4,
    lr=3e-4, ent_coef=0.0,
  )
  state, tx = ppo_init(pool, net, cfg, seed=0)
  step = make_ppo_train_step(pool, net, cfg, tx)
  rewards = []
  for _ in range(25):
    state, metrics = step(state)
    rewards.append(float(metrics["mean_reward"]))
  best = float(np.max(rewards[5:]))
  assert best > rewards[0], rewards
  assert best > 0.97, rewards


# ------------------------------------------------- the library examples


def test_cleanrl_ppo(capsys, monkeypatch):
  """Two iterations of the CleanRL-style trainer: one line each, every
  number finite, episodes counted as they end; without ``gymnasium``, as
  on the card's machine."""
  monkeypatch.setitem(sys.modules, "gymnasium", None)
  history = cleanrl_ppo.main(TINY[:4] + ["--num-steps", "16", "--iterations", "2"])
  lines = capsys.readouterr().out.strip().splitlines()
  assert len(lines) == len(history) == 2
  for it, (line, row) in enumerate(zip(lines, history)):
    assert line.startswith(f"iter {it:3d}  episodic_return="), line
    assert all(math.isfinite(v) for v in row.values()), row
  assert history[1]["episodes"] >= history[0]["episodes"] > 0


def test_sb3_adapter_steps_with_per_env_infos(capsys, monkeypatch):
  """The SB3 adapter steps past its first step (the JAX package's script
  raises ``KeyError: 0`` there), with one info dict per env and the nested
  ``players`` dict indexed per env too; without ``gymnasium``."""
  monkeypatch.setitem(sys.modules, "gymnasium", None)
  res = sb3_example.main(["--device", "cpu", "--num-envs", "4", "--steps", "30"])
  (line,) = capsys.readouterr().out.strip().splitlines()
  assert line.startswith("adapter round-trip OK: 30 steps of 4 envs"), line
  assert math.isfinite(res["mean_reward"]) and res["episodes_ended"] > 0
  env = sb3_example.EnvPoolVecAdapter(
    envpool_torch.make_gymnasium("CartPole-v1", num_envs=3, seed=0, device="cpu"))
  env.reset()
  env.step_async(np.zeros(3, np.int32))
  _, _, done, infos = env.step_wait()
  assert len(infos) == 3 and done.shape == (3,)
  for i, info in enumerate(infos):
    assert info["env_id"] == i and info["players"]["env_id"] == i
    assert np.ndim(info["elapsed_step"]) == 0


def test_tianshou_adapter_drives_all_and_subsets(capsys, monkeypatch):
  """Without tianshou the script drives the adapter: every env, then the
  subset ``[1, 3]`` reset and stepped; without ``gymnasium``."""
  monkeypatch.setitem(sys.modules, "gymnasium", None)
  res = tianshou_example.main(["--device", "cpu", "--num-envs", "5", "--steps", "20"])
  (line,) = capsys.readouterr().out.strip().splitlines()
  assert "the adapter alone: 20 steps of 5 envs" in line, line
  assert res["subset_rows"] == 2 and math.isfinite(res["mean_reward"])


def test_acme_adapter_runs_episodes_without_jax(capsys, monkeypatch):
  """The single-env dm view runs its episodes with ``jax`` unimportable
  (the JAX package's script imports it for ``tree_map``)."""
  pytest.importorskip("dm_env")
  monkeypatch.setitem(sys.modules, "jax", None)
  returns = acme_example.main(["--device", "cpu", "--episodes", "2"])
  lines = capsys.readouterr().out.strip().splitlines()
  assert len(lines) == 3 and lines[0].startswith("dm-acme is not installed")
  assert len(returns) == 2 and all(r > 0 for r in returns)
  view = acme_example.BatchedToSingleDmEnv(
    envpool_torch.make_dm("CartPole-v1", num_envs=2, seed=0, device="cpu"), 1)
  ts = view.reset()
  assert np.asarray(ts.observation.obs).shape == (4,) and ts.reward == 0.0


def test_acme_example_runs_acme_loop_with_its_own_actor(capsys, monkeypatch):
  """With ``acme`` importable, the script runs the view through
  ``acme.EnvironmentLoop`` with its fixed-action ``acme.core.Actor`` and
  imports nothing of jax. A stand-in ``acme`` (the loop's
  ``run_episode`` contract: reset, ``observe_first``, then
  ``select_action``/``step``/``observe`` until the last step) takes the
  library's place, which no machine here has; its episodes equal the
  script's own episodes without acme."""
  import types

  pytest.importorskip("dm_env")
  monkeypatch.setitem(sys.modules, "jax", None)
  core = types.ModuleType("acme.core")

  class Actor:
    pass

  class EnvironmentLoop:
    def __init__(self, environment, actor):
      assert isinstance(actor, Actor)
      self.env, self.actor = environment, actor

    def run_episode(self):
      ts = self.env.reset()
      self.actor.observe_first(ts)
      total, steps = 0.0, 0
      while not ts.last():
        action = self.actor.select_action(ts.observation)
        ts = self.env.step(action)
        self.actor.observe(action, ts)
        total, steps = total + ts.reward, steps + 1
      self.actor.update()
      return {"episode_return": total, "episode_length": steps}

  core.Actor = Actor
  acme = types.ModuleType("acme")
  acme.core, acme.EnvironmentLoop = core, EnvironmentLoop
  monkeypatch.setitem(sys.modules, "acme", acme)
  monkeypatch.setitem(sys.modules, "acme.core", core)
  got = acme_example.main(["--device", "cpu", "--episodes", "2"])
  lines = capsys.readouterr().out.strip().splitlines()
  assert len(lines) == 3 and lines[0].startswith("dm-acme's EnvironmentLoop")
  view = acme_example.BatchedToSingleDmEnv(
    envpool_torch.make_dm("CartPole-v1", num_envs=4, seed=0, device="cpu"), 0)
  assert got == [r for r, _ in acme_example.noop_episodes(view, 2)]
  assert all(r > 0 for r in got)
