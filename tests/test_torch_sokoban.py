"""The port's Sokoban-v0 on its own (CPU): one twin of every case of
``tests/test_sokoban.py``, through the port's registry with
``device="cpu"``."""

import os

import numpy as np
import torch

import envpool_torch
from envpool_torch.envs.sokoban import SokobanEnvSpec
from envpool_torch.envs.sokoban.astar import solve_level
from envpool_torch.envs.sokoban.level_loader import (
  BOX,
  load_bank,
  parse_level_file,
)

# the suite runs in several worker processes that share the cores: one
# intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

LEVELS_DIR = os.path.join(
  os.path.dirname(envpool_torch.__file__), "envs", "sokoban", "sample_levels"
)


def _make(env_type="gymnasium", **kw):
  return envpool_torch.make("Sokoban-v0", env_type=env_type, device="cpu", **kw)


def test_config() -> None:
  ref_config_keys = [
    "base_path",
    "batch_size",
    "gym_reset_return_info",
    "max_num_players",
    "num_envs",
    "num_threads",
    "seed",
    "thread_affinity_offset",
    "min_episode_steps",
    "max_episode_steps",
    "dim_room",
    "levels_dir",
    "reward_box",
    "reward_finished",
    "reward_step",
    "verbose",
    "load_sequentially",
    "n_levels_to_load",
  ]
  config_keys = list(SokobanEnvSpec.gen_config._fields)
  assert sorted(config_keys) == sorted(ref_config_keys)


def test_spec() -> None:
  spec = envpool_torch.make_spec(
    "Sokoban-v0", num_envs=2, levels_dir=LEVELS_DIR
  )
  assert spec.state_array_spec["obs"].shape == (3, 10, 10)
  assert spec.action_array_spec["action"].shape == (-1,)


def test_envpool_basic() -> None:
  num_envs = 16
  env = _make(
    num_envs=num_envs,
    seed=2346890,
    max_episode_steps=60,
    reward_step=-0.1,
    dim_room=10,
    levels_dir=LEVELS_DIR,
  )
  assert env.action_space.n == 4
  obs, _ = env.reset()
  assert obs.shape == (num_envs, 3, 10, 10)
  assert obs.dtype == np.uint8
  rng = np.random.default_rng(0)
  for _ in range(20):
    obs, rew, term, trunc, info = env.step(
      rng.integers(0, 4, num_envs).astype(np.int32)
    )
    assert obs.shape == (num_envs, 3, 10, 10)
    # reward_step -0.1, +-reward_box per box matched/unmatched (up to 4),
    # +10 when solved
    assert np.all((rew < 15.0) & (rew >= -4.2))


def test_max_episode_steps_truncation() -> None:
  for max_episode_steps in [2, 5, 10]:
    env = _make(
      num_envs=1,
      min_episode_steps=max_episode_steps,
      max_episode_steps=max_episode_steps,
      levels_dir=LEVELS_DIR,
    )
    env.reset()
    for _ in range(max_episode_steps - 1):
      _, _, terminated, truncated, _ = env.step(np.zeros([1], dtype=np.int32))
      assert not np.any(terminated | truncated)
    _, _, terminated, truncated, _ = env.step(np.zeros([1], dtype=np.int32))
    assert not np.any(terminated)
    assert np.all(truncated)


def test_load_sequentially() -> None:
  """First resets walk the file-name-sorted level stream round-robin."""
  bank = load_bank(LEVELS_DIR, 10)
  num_envs = 4
  env = _make(
    num_envs=num_envs,
    max_episode_steps=60,
    min_episode_steps=60,
    levels_dir=LEVELS_DIR,
    load_sequentially=True,
  )
  _, info = env.reset()
  np.testing.assert_array_equal(info["level_idx"], bank.level_idx[:num_envs])
  np.testing.assert_array_equal(
    info["level_file_idx"], bank.file_idx[:num_envs]
  )
  # the next episode (after truncation at 60 steps) gets the next cohort,
  # visible on the terminal timestep (reset-into-terminal-obs)
  for _ in range(60):
    _, _, term, trunc, info = env.step(np.zeros(num_envs, np.int32))
  assert np.all(trunc)
  np.testing.assert_array_equal(
    info["level_idx"], bank.level_idx[num_envs:2 * num_envs]
  )


def test_n_levels_to_load_wraps() -> None:
  env = _make(
    num_envs=2,
    max_episode_steps=1,
    min_episode_steps=1,
    levels_dir=LEVELS_DIR,
    load_sequentially=True,
    n_levels_to_load=4,
  )
  _, info = env.reset()
  seen = [tuple(info["level_idx"])]
  for _ in range(4):
    _, _, _, trunc, info = env.step(np.zeros(2, np.int32))
    assert np.all(trunc)
    seen.append(tuple(info["level_idx"]))
  bank = load_bank(LEVELS_DIR, 10)
  # stream positions per episode k: env0 -> 2k % 4, env1 -> 2k+1 % 4
  expect = [
    (bank.level_idx[0], bank.level_idx[1]),
    (bank.level_idx[2], bank.level_idx[3]),
    (bank.level_idx[0], bank.level_idx[1]),
    (bank.level_idx[2], bank.level_idx[3]),
    (bank.level_idx[0], bank.level_idx[1]),
  ]
  assert seen == [tuple(e) for e in expect]


def test_noop_action() -> None:
  env = _make(
    num_envs=2,
    max_episode_steps=10,
    min_episode_steps=10,
    levels_dir=LEVELS_DIR,
  )
  obs0, _ = env.reset()
  obs, rew, term, trunc, _ = env.step(np.full(2, -1, np.int32))
  assert np.all(np.isnan(rew))
  assert not np.any(term | trunc)
  np.testing.assert_array_equal(obs, obs0)  # noop leaves the world unchanged
  # noop does not advance the internal cap counter: 10 more real steps fit
  for _ in range(10):
    _, rew, term, trunc, _ = env.step(np.zeros(2, np.int32))
  assert np.all(trunc | term)


def test_astar_solves_env() -> None:
  """A* solution replayed through the batched env reaches the finish reward."""
  levels = parse_level_file(os.path.join(LEVELS_DIR, "small.txt"))
  solved_any = False
  for idx, level in enumerate(levels):
    actions, _ = solve_level(level, node_limit=200_000)
    if actions is None:
      continue
    solved_any = True
    env = _make(
      num_envs=1,
      max_episode_steps=len(actions) + 2,
      min_episode_steps=len(actions) + 2,
      levels_dir=os.path.join(LEVELS_DIR, "small.txt"),
      load_sequentially=True,
    )
    # position the single env on level idx by resetting through the stream
    env.reset()
    for _ in range(idx):
      env.reset()
    total_box = int((np.asarray(level) == BOX).sum())
    rewards = []
    for a in actions:
      _, rew, term, trunc, _ = env.step(np.asarray([a], np.int32))
      rewards.append(float(rew[0]))
    assert term[0] and not trunc[0], f"level {idx} not solved by A* replay"
    expect_total = -0.1 * len(actions) + 1.0 * total_box + 10.0
    assert np.isclose(sum(rewards), expect_total, atol=1e-5)
  assert solved_any, "A* failed to solve any sample level"


def test_procedural_bank() -> None:
  """levels_dir='' generates a deterministic solvable bank."""
  kw = dict(num_envs=4, seed=3, max_episode_steps=30, levels_dir="",
            n_levels_to_load=32)
  obs, _ = _make(**kw).reset()
  assert obs.shape == (4, 3, 10, 10)
  obs2, _ = _make(**kw).reset()
  np.testing.assert_array_equal(obs, obs2)


def test_dm_dialect() -> None:
  env = _make("dm", num_envs=3, max_episode_steps=60, levels_dir=LEVELS_DIR)
  ts = env.reset()
  assert ts.observation.obs.shape == (3, 3, 10, 10)
  assert np.all(ts.step_type == 0)
  ts = env.step({"action": np.zeros(3, np.int32)})
  assert np.all(ts.step_type == 1)


def test_elapsed_step_restarts_after_auto_reset() -> None:
  """elapsed_step is the finishing episode's count on the terminal step;
  the in-step auto-reset restarts it and noops freeze it."""
  cap = 4
  env = _make(
    num_envs=2,
    min_episode_steps=cap,
    max_episode_steps=cap,
    levels_dir=LEVELS_DIR,
  )
  _, info = env.reset()
  assert np.all(np.asarray(info["elapsed_step"]) == 0)
  act = np.zeros(2, np.int32)
  for k in range(1, cap + 1):
    _, _, term, trunc, info = env.step(act)
    assert np.all(np.asarray(info["elapsed_step"]) == k)
  assert np.all(trunc)
  # next episode: counter restarted by the in-step auto-reset
  _, _, term, trunc, info = env.step(act)
  assert np.all(np.asarray(info["elapsed_step"]) == 1)
  assert not np.any(term | trunc)
  # noop (negative action) freezes the counter
  _, _, _, _, info = env.step(np.full(2, -1, np.int32))
  assert np.all(np.asarray(info["elapsed_step"]) == 1)


def test_gym_dialect_and_masked_step() -> None:
  """The gym dialect, a masked step and the functional interface, which
  the twins above do not drive, on env-side auto-reset."""
  env = _make("gym", num_envs=4, min_episode_steps=3, max_episode_steps=3,
              levels_dir=LEVELS_DIR, load_sequentially=True)
  obs, info = env.reset()
  ids = np.asarray([2, 0], np.int32)
  obs, rew, term, trunc, info = env.step(np.zeros(2, np.int32), ids)
  np.testing.assert_array_equal(info["env_id"], ids)
  np.testing.assert_array_equal(info["elapsed_step"], [1, 1])
  np.testing.assert_array_equal(env.save_state().elapsed, [1, 0, 1, 0])
  handle, recv, send, step = env.xla()
  keys = env.spec._state_keys
  for k in range(3):
    handle, out = step(handle, torch.zeros(4, dtype=torch.int32))
  done = out[keys.index("done")].numpy()
  np.testing.assert_array_equal(done, [False, True, False, True])
  env.commit(handle)
  *_, info = env.step(np.zeros(4, np.int32))
  np.testing.assert_array_equal(info["elapsed_step"], [2, 1, 2, 1])
