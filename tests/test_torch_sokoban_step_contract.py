"""The contract the fused Sokoban kernel (``csrc/sokoban_step.cu``) is held
to: ``SokobanEnv.step_plain`` and ``reset_plain`` on crafted states against
``jax.vmap`` of the JAX package's ``SokobanEnv.step`` and ``reset``, bit
for bit in every field (NaN rewards in the same bits).

The states cover a push against the world's edge (``p2`` out of bounds,
with a marked cell 0 that a clamped write would corrupt), a player at the
edge stepping out, boxes onto and off targets, into walls and boxes, the
player onto and off a target, a solved step, the actions -5, -1, 4 and 7,
a truncation, every lane done at once, and reset of every lane; in random
mode with non-unit rewards and in sequential mode with
``min_episode_steps == max_episode_steps`` and cursors next to the int32
maximum (and below zero). One jitted JAX function computes every reference.
"""

import os

import jax
import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu
from envpool_torch.envs.sokoban.level_loader import (
  BOX, BOX_ON_TARGET, EMPTY, PLAYER, PLAYER_ON_TARGET, TARGET, WALL,
)
from envpool_torch.envs.sokoban.sokoban import SokobanEnv

# the suite runs in several worker processes that share the cores: one
# intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

D = 10
LEVELS_DIR = os.path.join(
  os.path.dirname(envpool_tpu.__file__), "envs", "sokoban", "sample_levels"
)
CONFIGS = {
  "random": dict(num_envs=16, seed=3, n_levels_to_load=16, min_episode_steps=2,
                 max_episode_steps=9, reward_step=-0.25, reward_box=2.5,
                 reward_finished=7.75),
  "sequential": dict(num_envs=16, seed=3, levels_dir=LEVELS_DIR,
                     load_sequentially=True, min_episode_steps=6,
                     max_episode_steps=6),
}

# one lane per row: (tiles placed as {(row, col): tile}, player, action,
# unmatched, steps, cap)
LANES = [
  ({(0, 4): BOX, (0, 0): TARGET}, (1, 4), 0, 2, 3, 20),    # push up off the edge
  ({(9, 4): BOX, (0, 0): TARGET}, (8, 4), 1, 2, 3, 20),    # push down off the edge
  ({(4, 5): BOX, (4, 6): TARGET}, (4, 4), 3, 2, 0, 20),    # box onto a target
  ({(4, 3): BOX_ON_TARGET}, (4, 4), 2, 1, 5, 20),          # box off a target
  ({(3, 4): BOX, (2, 4): TARGET}, (4, 4), 0, 1, 7, 20),    # the last box: solved
  ({(4, 5): BOX}, (4, 4), -5, 1, 2, 20),                   # noop
  ({(4, 5): BOX}, (4, 4), -1, 1, 2, 20),                   # noop
  ({}, (4, 4), 4, 1, 2, 20),                               # 4 clamps to right
  ({(4, 5): BOX}, (4, 4), 7, 1, 2, 20),                    # 7 clamps: a push
  ({(5, 5): PLAYER_ON_TARGET}, (5, 5), 1, 1, 2, 20),       # off a target
  ({(5, 6): TARGET}, (5, 5), 3, 1, 2, 20),                 # onto a target
  ({(0, 0): PLAYER}, (0, 0), 2, 1, 2, 20),                 # out of the world
  ({(4, 5): TARGET}, (4, 4), 3, 1, 8, 9),                  # truncated
  ({(4, 5): BOX, (4, 6): WALL}, (4, 4), 3, 1, 2, 20),      # box into a wall
  ({(4, 5): BOX, (4, 6): BOX_ON_TARGET}, (4, 4), 3, 1, 2, 20),  # box into a box
  ({(9, 9): PLAYER_ON_TARGET, (9, 8): BOX_ON_TARGET, (9, 7): TARGET},
   (9, 9), 2, 3, 2, 20),                                   # on-target push
]
N = len(LANES)
I32_MAX = 2**31 - 1


def _crafted(cursor: np.ndarray):
  """(state, actions) of ``LANES`` as numpy arrays."""
  world = np.full((N, D, D), EMPTY, np.uint8)
  world[:, 2, 8] = WALL
  player = np.zeros((N, 2), np.int32)
  action = np.zeros(N, np.int32)
  scalars = np.zeros((3, N), np.int32)
  for e, (tiles, pos, act, unmatched, steps, cap) in enumerate(LANES):
    world[e][pos] = PLAYER
    for rc, tile in tiles.items():
      world[e][rc] = tile
    player[e], action[e] = pos, act
    scalars[:, e] = unmatched, steps, cap
  state = {
    "world": world, "player": player, "unmatched": scalars[0],
    "steps": scalars[1], "cap": scalars[2], "cursor": cursor.astype(np.int32),
    "file_idx": np.arange(N, dtype=np.int32) + 100,
    "level_idx": np.arange(N, dtype=np.int32) + 200,
  }
  return state, action


def _cases():
  """mode -> case -> (state, action or None, keys), numpy."""
  rng = np.random.default_rng(11)
  out = {}
  for mode in CONFIGS:
    cursor = (np.arange(N) if mode == "random" else
              np.concatenate([I32_MAX - np.arange(N - 3), [-5, -2**31, 0]]))
    state, action = _crafted(cursor)
    # every lane done at once: each cap at its lane's step count, so a noop
    # ends its episode too
    all_done = dict(state, cap=state["steps"].copy())
    keys = lambda: rng.integers(0, 2**32, (N, 2), dtype=np.uint64).astype(np.uint32)
    out[mode] = {
      "step": (state, action, keys()),
      "all_done": (all_done, action, keys()),
      "reset": (state, None, keys()),
    }
  return out


CASES = _cases()


def _configs():
  return {
    mode: (envpool_tpu.make_spec("Sokoban-v0", **kw).config,
           envpool_torch.make_spec("Sokoban-v0", **kw).config)
    for mode, kw in CONFIGS.items()
  }


@pytest.fixture(scope="module")
def results():
  """mode -> case -> (torch outputs, JAX outputs) as numpy trees."""
  from envpool_tpu.envs.sokoban.sokoban import SokobanEnv as JaxSokoban

  cfgs = _configs()

  @jax.jit
  def reference(cases):
    out = {}
    for mode, (jcfg, _) in cfgs.items():
      out[mode] = {}
      for case, (state, action, keys) in cases[mode].items():
        if action is None:
          fn = jax.vmap(lambda s, k: JaxSokoban.reset(jcfg, s, k))
          out[mode][case] = fn(state, keys)
        else:
          fn = jax.vmap(lambda s, a, k: JaxSokoban.step(jcfg, s, a, k))
          out[mode][case] = fn(state, action, keys)
    return out

  want = jax.tree_util.tree_map(np.asarray, reference(CASES))

  got = {}
  for mode, (_, tcfg) in cfgs.items():
    got[mode] = {}
    for case, (state, action, keys) in CASES[mode].items():
      st = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
      k = torch.from_numpy(keys.astype(np.int64))
      if action is None:
        out = SokobanEnv.reset_plain(tcfg, st, k)
      else:
        out = SokobanEnv.step_plain(tcfg, st, torch.from_numpy(action), k)
      got[mode][case] = jax.tree_util.tree_map(lambda t: t.numpy(), out)
  return got, want


STEP_FIELDS = ("state", "obs", "reward", "done", "trunc", "info")
RESET_FIELDS = ("state", "obs", "info")
PARAMS = [
  (mode, case, field)
  for mode in CONFIGS for case in ("step", "all_done", "reset")
  for field in (RESET_FIELDS if case == "reset" else STEP_FIELDS)
]


@pytest.mark.parametrize("mode,case,field", PARAMS)
def test_plain_matches_jax_bit_for_bit(results, mode, case, field):
  got, want = results
  fields = RESET_FIELDS if case == "reset" else STEP_FIELDS
  i = fields.index(field)
  g, w = got[mode][case][i], want[mode][case][i]
  if isinstance(w, dict):
    assert sorted(g) == sorted(w)
    items = [(k, g[k], w[k]) for k in w]
  else:
    items = [(field, g, w)]
  for name, gv, wv in items:
    wv = np.asarray(wv)
    assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
    if gv.dtype == np.float32:  # NaN rewards bit for bit too
      gv, wv = gv.view(np.uint32), wv.view(np.uint32)
    np.testing.assert_array_equal(gv, wv, err_msg=f"{mode} {case} {name}")


def test_cases_reach_every_branch(results):
  """The crafted lanes do what they were made for, so that each branch of
  the kernel's contract is held: the edge pushes leave cell 0 alone, the
  noops give NaN and keep the step count, the solved lane gets the
  finishing reward, the truncated lane truncates, and every lane of
  ``all_done`` is done."""
  got, _ = results
  state, obs, reward, done, trunc, info = got["random"]["step"]
  assert np.isnan(reward[[5, 6]]).all() and not np.isnan(np.delete(reward, [5, 6])).any()
  np.testing.assert_array_equal(info["elapsed_step"][[5, 6]], [2, 2])
  assert done[4] and not trunc[4] and reward[4] == np.float32(-0.25 + 2.5 + 7.75)
  assert done[12] and trunc[12]
  assert reward[2] == np.float32(-0.25 + 2.5) and reward[3] == np.float32(-0.25 - 2.5)
  for lane in (0, 1):  # the push off the edge neither moves nor writes cell 0
    assert state["world"][lane, 0, 0] == TARGET
    np.testing.assert_array_equal(state["player"][lane], LANES[lane][1])
  assert done.sum() == 2
  for mode in CONFIGS:
    assert got[mode]["all_done"][3].all()
  # sequential: the cursors wrap past the int32 maximum
  seq = got["sequential"]["all_done"][0]["cursor"]
  assert (seq < 0).sum() >= N - 4


def test_step_dispatches_to_plain_on_cpu(results):
  """``SokobanEnv.step`` and ``reset`` take the plain version for CPU
  tensors, and the kernel's launcher refuses them."""
  _, tcfg = _configs()["random"]
  state, action, keys = CASES["random"]["step"]
  st = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
  k = torch.from_numpy(keys.astype(np.int64))
  a = torch.from_numpy(action)
  got = SokobanEnv.step(tcfg, st, a, k)
  want = SokobanEnv.step_plain(tcfg, st, a, k)
  for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
    assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                       w.view(torch.int32) if w.is_floating_point() else w)
  with pytest.raises(ValueError, match="no Sokoban step kernel"):
    SokobanEnv._launch(tcfg, st, a, k)
