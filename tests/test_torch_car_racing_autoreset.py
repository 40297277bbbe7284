"""Slice parity across auto-resets: both packages' CarRacing-v2 pools with
``max_episode_steps=8`` over 20 steps, so every lane truncates and resets
twice. Tolerances as in ``test_torch_car_racing.py``."""

import numpy as np

import envpool_torch
import envpool_tpu
from test_torch_car_racing import N, actions, assert_step_close, rollout

KW = dict(num_envs=N, seed=0, n_tracks=2, max_episode_steps=8)


def test_rollout_across_auto_resets():
  acts = actions(1, 20)
  _, want, _ = rollout(envpool_tpu.make_gymnasium("CarRacing-v2", **KW), acts)
  env = envpool_torch.make_gymnasium("CarRacing-v2", device="cpu", **KW)
  _, got, _ = rollout(env, acts)
  elapsed = np.stack([o[-1]["elapsed_step"] for o in got[1:]])
  trunc = np.stack([o[3] for o in got[1:]])
  # step 8 truncates, step 9 is the auto-reset's FIRST, and so on
  assert (trunc.sum(0) == 2).all() and (elapsed == 0).sum(0).tolist() == [2] * N
  for w, g in zip(want, got):
    assert_step_close(w, g)
