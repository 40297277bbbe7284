"""Dummy env — the developer template and the engine's test fixture.

The port of ``envpool_tpu/envs/dummy/dummy.py`` (counterpart of the
reference's tutorial env, ``envpool/dummy/dummy_envpool.h:25-222``): the
smallest complete example of the batched ``FuncEnv`` contract. Every
function takes and returns the whole batch of ``[N, ...]`` tensors:

  default_config() -> dict            env-specific config (merged with the
                                      common num_envs/seed/... config)
  state_spec(cfg)  -> {key: ArraySpec}  "obs"/"obs:x"/"info:x" keys
  action_spec(cfg) -> {key: ArraySpec}
  init(cfg, env_ids, keys) -> state   pre-first-reset state dict
  reset(cfg, state, keys) -> (state, obs, info)
  step(cfg, state, action, keys) -> (state, obs, reward, term, info)

Behavior: the env counts steps; ``obs:raw`` is ``[count, last_action]``;
reward equals the action taken (per player when multiplayer, with env e
having ``e % max_num_players + 1`` live players); an episode terminates
after ``state_num`` steps. With ``container_obs`` the dynamically shaped
``obs:dyn`` (``env_id % 4 + 1`` rows of ``state_num``, filled with env_id)
is a padded ``(data, shape)`` pair.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec, ContainerSpec


class DummyEnv(FuncEnv):
  """Tutorial/dev-template env family (single- and multi-player)."""

  name = "Dummy"
  multi_player = True

  @staticmethod
  def default_config() -> Dict[str, Any]:
    # counterpart of DummyEnvFns::DefaultConfig (dummy_envpool.h:48-50);
    # container_obs enables the nested-dynamic obs:dyn demo field
    return {"state_num": 10, "action_num": 6, "container_obs": False}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    spec: Dict[str, Any] = {
      "obs:raw": ArraySpec(np.int32, (2,)),
      "obs:clock": ArraySpec(np.float32, ()),
      "info:step_count": ArraySpec(np.int32, ()),
      "info:players.id": ArraySpec(np.int32, (-1,), 0, 100),
    }
    if getattr(cfg, "container_obs", False):
      spec["obs:dyn"] = ContainerSpec(
        ArraySpec(np.int32, (-1, int(cfg.state_num))),
        max_shape=(4, int(cfg.state_num)),
      )
    return spec

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, int(cfg.action_num) - 1)}

  @classmethod
  def init(cls, cfg: Any, env_ids: torch.Tensor, keys: torch.Tensor) -> Any:
    st, _, _ = cls.reset(cfg, {"env_id": env_ids.to(torch.int32)}, keys)
    return st

  @classmethod
  def reset(
    cls, cfg: Any, state: Any, keys: torch.Tensor
  ) -> Tuple[Any, Any, Dict]:
    env_id = state["env_id"]
    st = {
      "env_id": env_id,
      "count": torch.zeros_like(env_id),
      "last_action": torch.full_like(env_id, -1),
    }
    p = int(cfg.max_num_players)
    if p > 1:
      # live player count varies per env, like the reference dummy
      st["num_players"] = env_id % p + 1
    return st, _obs(cfg, st), cls._info(cfg, st)

  @classmethod
  def step(
    cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor
  ) -> Tuple[Any, Any, torch.Tensor, torch.Tensor, Dict]:
    del keys
    n = state["count"].shape[0]
    p = int(cfg.max_num_players)
    if p > 1:
      # padded per-player actions [N, P]; reward echoes each player's action
      action = action.reshape(n, p).to(torch.int32)
      first = action[:, 0]
    else:
      action = action.reshape(n).to(torch.int32)
      first = action
    st = dict(state, count=state["count"] + 1, last_action=first)
    term = st["count"] >= int(cfg.state_num)
    return st, _obs(cfg, st), action.to(torch.float32), term, cls._info(cfg, st)

  @staticmethod
  def _info(cfg: Any, st: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    p = int(cfg.max_num_players)
    count = st["count"]
    if p == 1:
      players_id = torch.zeros_like(count)
    else:
      players_id = torch.arange(
        p, dtype=torch.int32, device=count.device
      ).expand(count.shape[0], p)
    return {"step_count": count, "players.id": players_id}


def _obs(cfg: Any, st: Dict[str, torch.Tensor]) -> Dict[str, Any]:
  count = st["count"]
  obs: Dict[str, Any] = {
    "raw": torch.stack([count, st["last_action"]], 1),
    "clock": count.to(torch.float32),
  }
  if getattr(cfg, "container_obs", False):
    # (padded data, actual shape): rows = env_id % 4 + 1, value = env_id
    sn = int(cfg.state_num)
    env_id = st["env_id"]
    data = env_id[:, None, None].expand(env_id.shape[0], 4, sn).contiguous()
    shape = torch.stack([env_id % 4 + 1, torch.full_like(env_id, sn)], 1)
    obs["dyn"] = (data, shape)
  return obs
