"""Functional environment interface of the port, batched-first on tensors.

Counterpart of ``envpool_tpu/core/env.py``. An environment family is a
bundle of pure functions over an explicit state dict of ``[N, ...]``
tensors; where the JAX package writes a single-env function and lets the
pool ``vmap`` it, every function here takes and returns the whole batch.

Contract (N envs on one device; keys are ``[N, 2]`` int64 threefry keys,
see ``prng.py``):

  default_config() -> dict                      # env-specific config defaults
  state_spec(cfg)  -> {name: ArraySpec}         # "obs"/"obs:x"/"info:x" keys
  action_spec(cfg) -> {name: ArraySpec}         # usually a single "action"
  init(cfg, env_ids[N], keys) -> state          # pre-first-reset state
  reset(cfg, state, keys) -> (state, obs, info)
  step(cfg, state, action, keys) -> (state, obs, reward[N], term[N], info)
  episode_cap(cfg, state) -> int or [N]

``obs`` is one tensor when the state spec has one "obs" key, otherwise a
dict keyed without the "obs:" prefix; a container field is a padded
``(data, shape)`` pair. ``info`` is a dict matching the "info:..." spec
keys (or empty). ``term`` is environment termination only; time-limit
truncation is applied by the pool using ``episode_cap`` (families with
``env_resets`` return ``done`` and ``trunc`` themselves). The device is the
keys' device.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .spec import ArraySpec

# Common config, same keys/defaults/order as the JAX package and the
# reference (``envpool/core/env_spec.h:26-31``). The device is not a config
# key: it is an argument of the pool, so configs of both packages compare
# equal.
COMMON_CONFIG: Dict[str, Any] = {
  "num_envs": 1,
  "batch_size": 0,
  "num_threads": 0,
  "max_num_players": 1,
  "thread_affinity_offset": -1,
  "base_path": "envpool_torch",
  "seed": 42,
  "gym_reset_return_info": False,
  "max_episode_steps": np.iinfo(np.int32).max,
}


def common_action_spec() -> Dict[str, ArraySpec]:
  return {
    "env_id": ArraySpec(np.int32, ()),
    "players.env_id": ArraySpec(np.int32, (-1,)),
  }


def common_state_spec() -> Dict[str, ArraySpec]:
  return {
    "info:env_id": ArraySpec(np.int32, ()),
    "info:players.env_id": ArraySpec(np.int32, (-1,)),
    "elapsed_step": ArraySpec(np.int32, ()),
    "done": ArraySpec(np.bool_, ()),
    "reward": ArraySpec(np.float32, (-1,)),
    "discount": ArraySpec(np.float32, (-1,), 0.0, 1.0),
    "step_type": ArraySpec(np.int32, ()),
    "trunc": ArraySpec(np.bool_, ()),
  }


class FuncEnv:
  """Base class for functional env families (namespaces, never instances)."""

  #: capitalized family name used to synthesize class names, e.g. "CarRacing"
  name: str = "Func"

  #: env-side auto-reset ("reset-into-terminal-obs", as in
  #: ``envpool_tpu/core/env.py``). When True, ``step`` returns
  #: ``(state, obs, reward, done, trunc, info)``: on a terminal lane
  #: ``state``/``obs`` already belong to the next episode, and ``info``
  #: carries the reserved key ``"elapsed_step"`` (in ``reset`` too), the
  #: FINISHING episode's step counter. The pool then never schedules a
  #: reset of its own (Sokoban, ``sokoban_envpool.cc:177-216``).
  env_resets: bool = False

  #: static-shape multiplayer. When True and the pool has
  #: ``max_num_players`` P > 1: per-player fields (leading -1 in the spec)
  #: are ``[N, P, ...]``, the state keeps the live count in
  #: ``state["num_players"]``, ``step`` gets ``[N, P]`` actions and returns
  #: an ``[N, P]`` reward; the pool masks and compacts the padding.
  multi_player: bool = False

  #: optional fused pool advance for CUDA tensors, None for the general
  #: path. A family that has one defines the classmethod
  #: ``fused_advance(cfg, ps, action, mask, force_reset) -> (env state,
  #: carried keys, elapsed, done flags, outputs)``: everything that
  #: ``TorchEnvPool._advance`` computes for the family, the key split, the
  #: reset select, the epilogue and the mask included, with ``outputs`` keyed
  #: by the pool's output names (all but ``info:env_id`` and
  #: ``info:players.env_id``, which the pool adds). The pool calls it for
  #: CUDA tensors and runs the general path, its plain version, otherwise
  #: (Sokoban, ``csrc/sokoban_step.cu``).
  fused_advance = None

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    raise NotImplementedError

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    raise NotImplementedError

  @classmethod
  def init(cls, cfg: Any, env_ids: torch.Tensor, keys: torch.Tensor) -> Any:
    """Default: the state produced by a reset from nothing."""
    del env_ids
    state, _, _ = cls.reset(cfg, None, keys)
    return state

  @staticmethod
  def reset(cfg: Any, state: Any, keys: torch.Tensor) -> Tuple[Any, Any, Dict]:
    raise NotImplementedError

  @staticmethod
  def step(
    cfg: Any, state: Any, action: Any, keys: torch.Tensor
  ) -> Tuple[Any, Any, torch.Tensor, torch.Tensor, Dict]:
    raise NotImplementedError

  @staticmethod
  def episode_cap(cfg: Any, state: Any) -> Any:
    """Per-episode step cap; envs may override with a ``[N]`` tensor."""
    return int(cfg.max_episode_steps)
