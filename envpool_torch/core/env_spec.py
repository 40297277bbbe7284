# Portions derived from EnvPool (https://github.com/sail-sg/envpool),
# Copyright 2021 Garena Online Private Limited, licensed under the
# Apache License, Version 2.0 (http://www.apache.org/licenses/LICENSE-2.0).
# Modifications Copyright 2026 the envpool_tpu authors, same license.
"""EnvSpec: config + schema composition for one env family.

The port's copy of ``envpool_tpu/core/env_spec.py``: counterpart of the
C++ ``EnvSpec<EnvFns>``
(``envpool/core/env_spec.h:48-85``) plus the Python ``EnvSpecMixin``
(``envpool/python/env_spec.py:36-245``): merges the common config/spec with
the env family's own, generates the ``gen_config`` namedtuple with defaults,
validates ``batch_size <= num_envs``, and exposes dm / gym / gymnasium
spec & space conversions.

Provenance: the ``observation_spec``/``action_spec``/``observation_space``
conversion methods (the "obs:"/"info:" prefix filtering and 3-key action
collapse rules) are adapted from ``envpool/python/env_spec.py:76-156``
(Apache-2.0) — dialect-contract code kept verbatim on purpose; the class
scaffolding around them is new.
"""

from __future__ import annotations

import pprint
from collections import namedtuple
from typing import Any, Dict, List, Optional, Tuple, Type, Union

from .data import (
  check_key_duplication,
  dm_spec_transform,
  gym_spec_transform,
  gymnasium_spec_transform,
  to_namedtuple,
  to_nested_dict,
)
from .env import COMMON_CONFIG, FuncEnv, common_action_spec, common_state_spec
from .spec import ArraySpec


class EnvSpec:
  """Schema + validated config of one env family instance."""

  _env_cls: Type[FuncEnv] = FuncEnv
  gen_config: Type = namedtuple("Config", COMMON_CONFIG.keys(),
                                defaults=tuple(COMMON_CONFIG.values()))

  def __init__(self, config: Any) -> None:
    """``config`` is an instance of ``cls.gen_config``."""
    if not isinstance(config, tuple):
      raise TypeError("config must be a gen_config namedtuple")
    values = list(config)
    keys = list(self.gen_config._fields)
    idx = {k: i for i, k in enumerate(keys)}
    num_envs = values[idx["num_envs"]]
    batch_size = values[idx["batch_size"]]
    if batch_size > num_envs:
      raise ValueError(
        f"It is required that batch_size <= num_envs, got num_envs = "
        f"{num_envs}, batch_size = {batch_size}"
      )
    if batch_size == 0:
      values[idx["batch_size"]] = num_envs
    self._config_keys = keys
    self._config_values = tuple(values)
    cfg = self.gen_config(*self._config_values)
    state_spec: Dict[str, ArraySpec] = dict(common_state_spec())
    state_spec.update(self._env_cls.state_spec(cfg))
    action_spec: Dict[str, ArraySpec] = dict(common_action_spec())
    action_spec.update(self._env_cls.action_spec(cfg))
    self._state_keys = list(state_spec.keys())
    self._state_spec = list(state_spec.values())
    self._action_keys = list(action_spec.keys())
    self._action_spec = list(action_spec.values())
    check_key_duplication(type(self).__name__, "state", self._state_keys)
    check_key_duplication(type(self).__name__, "action", self._action_keys)

  # ------------------------------------------------------------------ config

  @property
  def config(self) -> Tuple:
    """The gen_config namedtuple used to create this spec."""
    return self.gen_config(*self._config_values)

  @property
  def reward_threshold(self) -> Optional[float]:
    """Reward threshold, None for no threshold."""
    return getattr(self.config, "reward_threshold", None)

  # ----------------------------------------------------------------- schemas

  @property
  def state_array_spec(self) -> Dict[str, ArraySpec]:
    """Flat {state key: ArraySpec}."""
    return dict(zip(self._state_keys, self._state_spec))

  @property
  def action_array_spec(self) -> Dict[str, ArraySpec]:
    """Flat {action key: ArraySpec}."""
    return dict(zip(self._action_keys, self._action_spec))

  # dm_env dialect -----------------------------------------------------------

  def observation_spec(self) -> Tuple:
    """dm_env observation spec (obs + info merged into one namedtuple)."""
    spec = self.state_array_spec
    spec = {
      k.replace("obs:", "").replace("info:", ""):
        dm_spec_transform(k.replace(":", ".").split(".")[-1], v, "obs")
      for k, v in spec.items()
      if k.startswith("obs") or k.startswith("info")
    }
    return to_namedtuple("State", to_nested_dict(spec))

  def action_spec(self) -> Union[Any, Tuple]:
    """dm_env action spec (3-key specs collapse to the bare action)."""
    spec = self.action_array_spec
    if len(spec) == 3:
      spec.pop("env_id")
      spec.pop("players.env_id")
      return dm_spec_transform(
        list(spec.keys())[0],
        list(spec.values())[0], "act"
      )
    spec = {
      k: dm_spec_transform(k.split(".")[-1], v, "act") for k, v in spec.items()
    }
    return to_namedtuple("Action", to_nested_dict(spec))

  # gym dialect ---------------------------------------------------------------

  @property
  def observation_space(self) -> Any:
    """Legacy-gym observation space (only keys starting with 'obs')."""
    spec = self.state_array_spec
    spec = {
      k.replace("obs:", ""):
        gym_spec_transform(k.replace(":", ".").split(".")[-1], v, "obs")
      for k, v in spec.items()
      if k.startswith("obs")
    }
    if len(spec) == 1:
      return list(spec.values())[0]
    import gym
    return to_nested_dict(spec, gym.spaces.Dict)

  @property
  def action_space(self) -> Any:
    """Legacy-gym action space."""
    spec = self.action_array_spec
    if len(spec) == 3:
      spec.pop("env_id")
      spec.pop("players.env_id")
      return gym_spec_transform(
        list(spec.keys())[0],
        list(spec.values())[0], "act"
      )
    spec = {
      k: gym_spec_transform(k.split(".")[-1], v, "act")
      for k, v in spec.items()
    }
    import gym
    return to_nested_dict(spec, gym.spaces.Dict)

  # gymnasium dialect ---------------------------------------------------------

  @property
  def gymnasium_observation_space(self) -> Any:
    """gymnasium observation space (only keys starting with 'obs')."""
    spec = self.state_array_spec
    spec = {
      k.replace("obs:", ""):
        gymnasium_spec_transform(k.replace(":", ".").split(".")[-1], v, "obs")
      for k, v in spec.items()
      if k.startswith("obs")
    }
    if len(spec) == 1:
      return list(spec.values())[0]
    import gymnasium
    return to_nested_dict(spec, gymnasium.spaces.Dict)

  @property
  def gymnasium_action_space(self) -> Any:
    """gymnasium action space."""
    spec = self.action_array_spec
    if len(spec) == 3:
      spec.pop("env_id")
      spec.pop("players.env_id")
      return gymnasium_spec_transform(
        list(spec.keys())[0],
        list(spec.values())[0], "act"
      )
    spec = {
      k: gymnasium_spec_transform(k.split(".")[-1], v, "act")
      for k, v in spec.items()
    }
    import gymnasium
    return to_nested_dict(spec, gymnasium.spaces.Dict)

  def __repr__(self) -> str:
    config_info = pprint.pformat(self.config)[6:]
    return f"{self.__class__.__name__}{config_info}"


def make_spec_cls(env_cls: Type[FuncEnv]) -> Type[EnvSpec]:
  """Synthesize a named EnvSpec subclass for one env family.

  Counterpart of ``EnvSpecMeta.__new__``
  (``envpool/python/env_spec.py:230-245``):
  builds the ``gen_config`` namedtuple from common+env config with defaults.
  """
  merged: Dict[str, Any] = dict(COMMON_CONFIG)
  merged.update(env_cls.default_config())
  keys: List[str] = [k.replace(".", "_") for k in merged.keys()]
  gen_config = namedtuple("Config", keys, defaults=tuple(merged.values()))
  return type(
    f"{env_cls.name}EnvSpec",
    (EnvSpec,),
    {"_env_cls": env_cls, "gen_config": gen_config},
  )
