"""The contract the fused Sokoban advance (``csrc/sokoban_step.cu``, mode 2)
is held to: its plain version, ``TorchEnvPool``'s general path over
``step_plain`` / ``reset_plain``, against the JAX package's pool on crafted
pool states, every output and the saved state bit for bit (NaN rewards in
the same bits).

Each mode's crafted ``PoolState`` goes into both pools through
``load_state`` (each package loads the other's snapshot), then through the
four entry points from that state: a full send, a masked send (lanes out of
order, one outside the mask with its done flag set), a forced reset of
every lane and a forced masked reset. The lanes mix carried done flags (a
reset and a step in one advance), lanes at their cap, a solved lane, noops,
pushes and moves, and keys whose words are near 2^32; random mode draws
from a generated bank, sequential mode from the sample levels with cursors
next to the int32 maximum. One jitted JAX function computes every reference.

Beside it: ``_StepArgs`` against ``struct SokobanArgs`` parsed from the
source, and the dispatch on the CPU (the plain path, no launch).
"""

import ctypes
import os
import re

import jax
import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu
from envpool_torch.core import graph, prng
from envpool_torch.envs.sokoban import sokoban as torch_sokoban
from envpool_torch.envs.sokoban.level_loader import (
  BOX, BOX_ON_TARGET, EMPTY, PLAYER, PLAYER_ON_TARGET, TARGET, WALL,
)
from envpool_torch.envs.sokoban.sokoban import SokobanEnv
from envpool_tpu.core.pool import PoolState as JaxPoolState

# the suite runs in several worker processes that share the cores: one
# intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

D = 10
LEVELS_DIR = os.path.join(
  os.path.dirname(envpool_tpu.__file__), "envs", "sokoban", "sample_levels"
)
CONFIGS = {
  "random": dict(num_envs=16, seed=5, n_levels_to_load=16, min_episode_steps=3,
                 max_episode_steps=11, reward_step=-0.25, reward_box=2.5,
                 reward_finished=7.75),
  "sequential": dict(num_envs=16, seed=5, levels_dir=LEVELS_DIR,
                     load_sequentially=True, max_episode_steps=40),
}
I32_MAX = 2**31 - 1
U32_MAX = 2**32 - 1

# one lane per row: (tiles placed as {(row, col): tile}, player, action,
# unmatched, steps, cap, carried done flag)
LANES = [
  ({(4, 5): BOX, (4, 6): TARGET}, (4, 4), 3, 2, 0, 20, False),  # box onto a target
  ({(3, 4): BOX, (2, 4): TARGET}, (4, 4), 0, 1, 7, 20, False),  # the last box: solved
  ({(4, 5): BOX}, (4, 4), -1, 1, 2, 20, False),                 # noop
  ({(4, 5): BOX}, (4, 4), -5, 1, 6, 6, False),                  # noop at the cap: done
  ({(4, 5): TARGET}, (4, 4), 3, 1, 8, 9, False),                # move to the cap: truncated
  ({(4, 5): BOX}, (4, 4), 3, 1, 4, 20, True),                   # done carried: reset
  ({}, (4, 4), -1, 1, 4, 20, True),                             # done carried, noop: reset
  ({(4, 5): WALL}, (4, 4), 3, 1, 2, 20, False),                 # into a wall
  ({(4, 5): BOX}, (4, 4), 7, 1, 2, 20, False),                  # 7 clamps: a push
  ({(0, 0): PLAYER}, (0, 0), 2, 1, 2, 20, False),               # out of the world
  ({(5, 5): PLAYER_ON_TARGET}, (5, 5), 1, 1, 3, 20, True),      # done carried, off the mask
  ({(4, 5): BOX, (4, 6): BOX_ON_TARGET}, (4, 4), 3, 1, 2, 20, False),  # box into a box
  ({(0, 4): BOX, (0, 0): TARGET}, (1, 4), 0, 2, 3, 20, False),  # push off the edge
  ({(9, 9): PLAYER_ON_TARGET, (9, 8): BOX_ON_TARGET, (9, 7): TARGET},
   (9, 9), 2, 3, 2, 20, True),                                  # done carried
  ({(5, 6): TARGET}, (5, 5), 3, 1, 2, 20, False),               # onto a target
  ({(6, 4): BOX, (7, 4): TARGET}, (5, 4), 1, 2, 5, 5, False),   # push at the cap
]
N = len(LANES)
# the masked entry points' lanes, out of order; lane 10 (done) is outside
MASK_IDS = np.asarray([9, 0, 5, 12, 2, 15, 6, 3], np.int32)
ENTRIES = ("full", "masked", "forced", "forced_masked")


def _crafted(mode: str):
  """(pool state, actions) of ``LANES`` as numpy, laid out as the JAX
  package's ``save_state()`` (uint32 keys)."""
  world = np.full((N, D, D), EMPTY, np.uint8)
  world[:, 2, 8] = WALL
  player = np.zeros((N, 2), np.int32)
  action = np.zeros(N, np.int32)
  scalars = np.zeros((3, N), np.int32)
  done = np.zeros(N, np.bool_)
  for e, (tiles, pos, act, unmatched, steps, cap, carried) in enumerate(LANES):
    world[e][pos] = PLAYER
    for rc, tile in tiles.items():
      world[e][rc] = tile
    player[e], action[e] = pos, act
    scalars[:, e] = unmatched, steps, cap
    done[e] = carried
  cursor = (np.arange(N) if mode == "random" else
            np.concatenate([I32_MAX - np.arange(N - 2), [-7, -2**31]]))
  env = {
    "world": world, "player": player, "unmatched": scalars[0],
    "steps": scalars[1], "cap": scalars[2], "cursor": cursor.astype(np.int32),
    "file_idx": np.arange(N, dtype=np.int32) + 100,
    "level_idx": np.arange(N, dtype=np.int32) + 200,
  }
  rng = np.random.default_rng(17 if mode == "random" else 19)
  keys = rng.integers(0, 2**32, (N, 2), dtype=np.uint64).astype(np.uint32)
  keys[10] = [U32_MAX, U32_MAX]
  keys[15] = [U32_MAX - 1, U32_MAX - 15]
  keys[5] = [U32_MAX, 0]
  state = JaxPoolState(
    env=env, rng=keys, elapsed=scalars[1].copy(), done=done
  )
  return state, action


@pytest.fixture(scope="module")
def results():
  """mode -> entry -> ((torch outputs, torch saved state), (JAX outputs,
  JAX saved state)), all numpy."""
  jax_pools = {m: envpool_tpu.make_gymnasium("Sokoban-v0", **kw)
               for m, kw in CONFIGS.items()}
  crafted = {m: _crafted(m) for m in CONFIGS}
  states, actions = {}, {}
  for mode, pool in jax_pools.items():
    state, action = crafted[mode]
    pool.load_state(state)
    states[mode], actions[mode] = pool._state, jax.numpy.asarray(action)
  ids = jax.numpy.asarray(MASK_IDS)

  @jax.jit
  def reference(states, actions, ids):
    out = {}
    for mode, pool in jax_pools.items():
      st, act = states[mode], actions[mode]
      out[mode] = {
        "full": pool._jit_advance_full(st, {"action": act}),
        "masked": pool._jit_advance_masked(st, {"action": act[ids]}, ids),
        "forced": pool._jit_reset_all(st),
        "forced_masked": pool._jit_reset_masked(st, ids),
      }
    return out

  ref = jax.device_get(reference(states, actions, ids))
  want = {m: {e: (list(outs), new) for e, (new, outs) in r.items()}
          for m, r in ref.items()}

  got = {}
  for mode, kw in CONFIGS.items():
    pool = envpool_torch.make_gymnasium("Sokoban-v0", device="cpu", **kw)
    state, action = crafted[mode]
    got[mode] = {}
    for entry in ENTRIES:
      pool.load_state(state)
      if entry == "full":
        pool.send(action)
      elif entry == "masked":
        pool.send(action[MASK_IDS], env_id=MASK_IDS)
      elif entry == "forced":
        pool._reset(np.arange(N, dtype=np.int32))
      else:
        pool._reset(MASK_IDS)
      got[mode][entry] = (pool._recv(), pool.save_state())
  return got, want, crafted


def _equal(g, w, tag: str) -> None:
  g, w = np.asarray(g), np.asarray(w)
  assert g.dtype == w.dtype and g.shape == w.shape, (tag, g.dtype, w.dtype, g.shape, w.shape)
  if g.dtype == np.float32:  # NaN rewards bit for bit too
    g, w = g.view(np.uint32), w.view(np.uint32)
  np.testing.assert_array_equal(g, w, err_msg=tag)


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("mode", list(CONFIGS))
def test_plain_advance_matches_jax_pool(results, mode, entry):
  got, want, _ = results
  (g_outs, g_state), (w_outs, w_state) = got[mode][entry], want[mode][entry]
  keys = envpool_torch.make_spec("Sokoban-v0", **CONFIGS[mode])._state_keys
  assert len(g_outs) == len(w_outs) == len(keys)
  for k, g, w in zip(keys, g_outs, w_outs):
    _equal(g, w, f"{mode} {entry} {k}")
  assert sorted(g_state.env) == sorted(w_state.env)
  for k in w_state.env:
    _equal(g_state.env[k], w_state.env[k], f"{mode} {entry} state {k}")
  _equal(g_state.rng, w_state.rng, f"{mode} {entry} rng")
  _equal(g_state.elapsed, w_state.elapsed, f"{mode} {entry} elapsed")
  _equal(g_state.done, w_state.done, f"{mode} {entry} done")


def test_cases_reach_every_branch(results):
  """The crafted lanes do what they were made for: one full send resets
  the lanes carrying done (FIRST, reward 0), finishes the solved and the
  capped lanes (LAST, the next episode's state), gives NaN at the noops and
  steps the rest; the masked send keeps lane 10 (done, outside the mask)
  as it was; the forced resets restart every lane they reach."""
  got, _, crafted = results
  keys = envpool_torch.make_spec("Sokoban-v0", **CONFIGS["random"])._state_keys
  col = lambda outs, k: outs[keys.index(k)]
  outs, new = got["random"]["full"]
  carried = crafted["random"][0].done
  st = col(outs, "step_type")
  np.testing.assert_array_equal(st[carried], 0)
  assert (col(outs, "reward")[carried] == 0).all()
  finished = col(outs, "done")
  assert finished[[1, 3, 4, 15]].all() and finished.sum() == 4
  assert col(outs, "trunc")[[3, 4, 15]].all() and not col(outs, "trunc")[1]
  np.testing.assert_array_equal(st[finished], 2)
  assert np.isnan(col(outs, "reward")[[2, 3]]).all()
  assert np.isnan(col(outs, "reward")).sum() == 2
  np.testing.assert_array_equal(new.env["steps"][finished | carried], 0)
  assert not new.done.any()
  outs, new = got["random"]["masked"]
  old = crafted["random"][0]
  assert new.done[10] and old.done[10] and 10 not in MASK_IDS
  np.testing.assert_array_equal(new.rng[10], old.rng[10])
  np.testing.assert_array_equal(new.env["world"][10], old.env["world"][10])
  np.testing.assert_array_equal(col(outs, "info:env_id"), MASK_IDS)
  for entry in ("forced", "forced_masked"):
    outs, _ = got["sequential"][entry]
    np.testing.assert_array_equal(col(outs, "step_type"), 0)
  # sequential: the cursors next to the int32 maximum wrap past it
  _, new = got["sequential"]["forced"]
  assert (new.env["cursor"] < 0).sum() >= N - 4


_C_TYPES = {
  "long long": ctypes.c_longlong, "int": ctypes.c_int,
  "unsigned": ctypes.c_uint, "float": ctypes.c_float,
}


def _source_fields():
  """(name, ctypes type) of each field of ``struct SokobanArgs`` in the
  kernel's source, in order: a pointer is c_void_p."""
  path = os.path.join(os.path.dirname(torch_sokoban.__file__), os.pardir, os.pardir,
                      "csrc", "sokoban_step.cu")
  with open(path) as f:
    text = f.read()
  body = re.search(r"struct SokobanArgs \{(.*?)\n\};", text, re.S).group(1)
  fields = []
  for line in body.splitlines():
    line = line.split("//")[0].strip()
    if not line:
      continue
    m = re.fullmatch(r"(.+?)\s*(\*?)\s*(\w+);", line)
    assert m, line
    ctype, pointer, name = m.groups()
    ctype = ctype.replace("const ", "").strip()
    fields.append((name, ctypes.c_void_p if pointer or ctype.endswith("*")
                   else _C_TYPES[ctype]))
  return fields


def test_step_args_mirror_the_source():
  """``_StepArgs`` lists the source's fields with their names, order and C
  types, so that the struct the wrapper fills is the one the kernel reads."""
  src = _source_fields()
  assert len(src) >= 50
  assert [(n, t) for n, t in torch_sokoban._StepArgs._fields_] == src


def test_advance_dispatches_to_plain_on_cpu():
  """On the CPU a Sokoban pool runs the general path: reset, full and
  masked sends, a forced masked reset and ``xla()`` steps launch no kernel
  (no advance, no step or reset mode, no threefry, no set kernel), while
  the fused advance is the family's hook and refuses CPU tensors."""
  pool = envpool_torch.make_gymnasium("Sokoban-v0", num_envs=8, seed=1, device="cpu",
                                      n_levels_to_load=8, max_episode_steps=5)
  assert pool._fused == SokobanEnv.fused_advance
  counters = lambda: (SokobanEnv.advance_launches, SokobanEnv.kernel_launches,
                      prng.threefry_kernel.launches, graph.set_conditional.launches)
  before = counters()
  pool.reset()
  rng = np.random.default_rng(0)
  for _ in range(6):
    pool.step(rng.integers(-1, 4, 8).astype(np.int32))
  pool.step(np.zeros(3, np.int32), env_id=np.asarray([1, 4, 6]))
  pool.reset(np.asarray([2, 3]))
  handle, _, send, _ = pool.xla()
  for _ in range(3):
    handle = send(handle, torch.zeros(8, dtype=torch.int32))
  assert counters() == before
  ps = handle.pool
  with pytest.raises(ValueError, match="no Sokoban step kernel"):
    SokobanEnv.fused_advance(pool._cfg, ps, torch.zeros(8, dtype=torch.int32), None, False)
