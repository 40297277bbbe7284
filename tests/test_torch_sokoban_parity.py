"""Slice parity: the port's Sokoban-v0 pool against the JAX package's.

Both pools get the same seed and numpy-seeded actions in [-1, 3] (so noops
occur) on the CPU, with episode caps drawn from [5, 12] so that every lane
auto-resets many times, one masked (env_id subset) step and one forced
reset of a subset. Every output field must match bit for bit, NaN rewards
in the same places, in both level modes: random (a generated bank of 32
levels) and sequential (the sample level files). One JAX pool per mode.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu
from envpool_torch.core import prng
from envpool_torch.envs.sokoban import level_loader as torch_loader
from envpool_tpu.envs.sokoban import level_loader as jax_loader

# the suite runs in several worker processes that share the cores: one
# intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

LEVELS_DIR = os.path.join(
  os.path.dirname(envpool_tpu.__file__), "envs", "sokoban", "sample_levels"
)
N = 8
STEPS = 150
MASKED_STEP, MASK_IDS = 50, np.asarray([1, 4, 6], np.int32)
RESET_STEP, RESET_IDS = 100, np.asarray([0, 3, 5], np.int32)
KW = dict(num_envs=N, seed=5, min_episode_steps=5, max_episode_steps=12)
MODES = {
  "random": dict(levels_dir="", n_levels_to_load=32),
  "sequential": dict(levels_dir=LEVELS_DIR, load_sequentially=True),
}
FIELDS = (
  "obs", "reward", "done", "trunc", "elapsed_step", "step_type", "discount",
  "info:env_id", "info:level_idx", "info:level_file_idx",
)


def _rollout(env, acts):
  """Every output list of reset + ``STEPS`` sends (one masked, one forced
  partial reset), through the low-level send/recv, and the final state."""
  keys = env.spec._state_keys
  env.async_reset()
  outs = [dict(zip(keys, env._recv()))]
  for t, a in enumerate(acts):
    if t == MASKED_STEP:
      env.send(a[MASK_IDS], MASK_IDS)
    elif t == RESET_STEP:
      env._reset(RESET_IDS)
    else:
      env.send(a)
    outs.append(dict(zip(keys, env._recv())))
  return outs, env.save_state()


@pytest.fixture(scope="module", params=sorted(MODES))
def rollouts(request):
  kw = dict(KW, **MODES[request.param])
  acts = np.random.default_rng(11).integers(-1, 4, (STEPS, N)).astype(np.int32)
  want = _rollout(envpool_tpu.make_gymnasium("Sokoban-v0", **kw), acts)
  got = _rollout(
    envpool_torch.make_gymnasium("Sokoban-v0", device="cpu", **kw), acts
  )
  return acts, want, got


@pytest.mark.parametrize("field", FIELDS)
def test_field_bit_exact(rollouts, field):
  _, (want, _), (got, _) = rollouts
  assert len(want) == len(got) == STEPS + 1
  for t, (w, g) in enumerate(zip(want, got)):
    w, g = np.asarray(w[field]), np.asarray(g[field])
    assert w.dtype == g.dtype and w.shape == g.shape, (t, field)
    if w.dtype == np.float32:
      # bit for bit, NaN (noop rewards) in the same places
      np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{t}")
      w, g = w.view(np.uint32)[~np.isnan(w)], g.view(np.uint32)[~np.isnan(g)]
    np.testing.assert_array_equal(g, w, err_msg=f"step {t}, {field}")


def test_rollout_covers_resets_noops_and_masks(rollouts):
  acts, (want, _), _ = rollouts
  done = np.stack([o["done"] for o in want[1:MASKED_STEP]])
  assert (done.sum(0) >= 3).all(), done.sum(0)  # many auto-resets per lane
  rew = np.stack([o["reward"] for o in want[1:MASKED_STEP]])
  np.testing.assert_array_equal(np.isnan(rew), acts[:MASKED_STEP - 1] < 0)
  np.testing.assert_array_equal(want[MASKED_STEP + 1]["info:env_id"], MASK_IDS)
  forced = want[RESET_STEP + 1]
  np.testing.assert_array_equal(forced["info:env_id"], RESET_IDS)
  np.testing.assert_array_equal(forced["elapsed_step"], 0)
  np.testing.assert_array_equal(forced["step_type"], 0)


def test_final_state_equal(rollouts):
  _, (_, want), (_, got) = rollouts
  assert sorted(got.env) == sorted(want.env)
  for k in want.env:
    w, g = np.asarray(want.env[k]), got.env[k]
    assert w.dtype == g.dtype, k
    np.testing.assert_array_equal(g, w, err_msg=k)
  for f in ("rng", "elapsed", "done"):
    np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))


def test_generate_and_load_bank_byte_equal():
  for seed, n in ((0, 16), (5, 32)):
    w = jax_loader.generate_bank(seed, n)
    g = torch_loader.generate_bank(seed, n)
    assert g.levels.tobytes() == w.levels.tobytes()
  w = jax_loader.load_bank(LEVELS_DIR, 10)
  g = torch_loader.load_bank(
    os.path.join(os.path.dirname(envpool_torch.__file__), "envs", "sokoban",
                 "sample_levels"), 10
  )
  assert g.levels.tobytes() == w.levels.tobytes()
  for f in ("file_idx", "level_idx", "file_start", "file_len"):
    np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
  assert g.file_names == w.file_names


def test_prng_scalar_draws_match_jax():
  """The draws of ``_load_level`` and ``_sample_cap`` at shape ()."""
  keys = prng.fold_in(prng.prng_key(9).expand(64, 2), torch.arange(64))
  jk = jnp.asarray(keys.numpy().astype(np.uint32))
  for lo, hi in ((0, 1), (0, 3), (0, 2**30)):
    want = jax.vmap(lambda k: jax.random.randint(k, (), 0, jnp.int32(hi)))(jk)
    np.testing.assert_array_equal(
      prng.randint(keys, (), lo, hi).numpy(), np.asarray(want)
    )
  want = jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(jk)
  np.testing.assert_array_equal(
    prng.random_bits(keys, ()).numpy(), np.asarray(want).astype(np.int64)
  )
