# Portions derived from EnvPool (https://github.com/sail-sg/envpool),
# Copyright 2021 Garena Online Private Limited, licensed under the
# Apache License, Version 2.0 (http://www.apache.org/licenses/LICENSE-2.0).
# Modifications Copyright 2026 the envpool_tpu authors, same license.
"""User-facing batched API: send/recv/step/reset + dialect adapters.

The port's copy of ``envpool_tpu/core/envpool_api.py`` over
``TorchEnvPool``, without ``optree``: the dialect structures are index
trees from ``data.py``. Behavioral parity targets as in the JAX package:
- action normalization, env_id defaulting, dtype casting, one-time action
  checking: ``envpool/python/envpool.py:33-120``
- gym tuple conversion with ``terminated = done & ~trunc`` and the legacy
  ``TimeLimit.truncated`` key: ``envpool/python/gym_envpool.py:75-97``
- gymnasium 5-tuple: ``envpool/python/gymnasium_envpool.py:74-90``
- dm_env TimeStep with obs/info merged namedtuple:
  ``envpool/python/dm_envpool.py:72-88``
- class synthesis per family: ``envpool/python/api.py:25-52``.
"""

from __future__ import annotations

import pprint
import warnings
from typing import Any, Dict, List, Optional, Tuple, Type, Union

import numpy as np

from .data import (
  dm_structure,
  fill_structure,
  flatten_with_path,
  gym_structure,
  gymnasium_structure,
)
from .env import FuncEnv
from .env_spec import EnvSpec, make_spec_cls
from .pool import TorchEnvPool


class EnvPoolMixin:
  """Common send/recv/step/reset veneer over the TorchEnvPool engine."""

  _spec: EnvSpec

  def _check_action(self, actions: List[np.ndarray]) -> None:
    if hasattr(self, "_check_action_finished"):  # only check once
      return
    self._check_action_finished = True
    for a, (k, v) in zip(actions, self._spec.action_array_spec.items()):
      if v.dtype != a.dtype:
        raise RuntimeError(
          f"Expected dtype {v.dtype} with action \"{k}\", got {a.dtype}"
        )
      shape = tuple(v.shape)
      if len(shape) > 0 and shape[0] == -1:
        if a.shape[1:] != shape[1:]:
          raise RuntimeError(
            f"Expected shape {shape} with action \"{k}\", got {a.shape}"
          )
      else:
        if len(a.shape) == 0 or a.shape[1:] != shape:
          raise RuntimeError(
            f"Expected shape {('num_env', *shape)} with action \"{k}\", "
            f"got {a.shape}"
          )

  def _from(
    self,
    action: Union[Dict[str, Any], np.ndarray],
    env_id: Optional[np.ndarray] = None,
  ) -> List[np.ndarray]:
    """Flatten/complete an action into the ordered action-key list."""
    if isinstance(action, dict):
      adict = dict(flatten_with_path(action))
    else:
      if not hasattr(self, "_last_action_type"):
        self._last_action_type = self._spec._action_spec[-1].dtype
      if not hasattr(self, "_last_action_name"):
        self._last_action_name = self._spec._action_keys[-1]
      if isinstance(action, np.ndarray):
        action = action.astype(self._last_action_type, order="C")
      adict = {self._last_action_name: action}
    if env_id is None:
      if "env_id" not in adict:
        adict["env_id"] = self.all_env_ids
    else:
      adict["env_id"] = np.asarray(env_id).astype(np.int32)
    if "players.env_id" not in adict:
      adict["players.env_id"] = adict["env_id"]
    if not hasattr(self, "_action_names"):
      self._action_names = self._spec._action_keys
    return list(map(lambda k: adict[k], self._action_names))

  def __len__(self) -> int:
    """Return the number of environments."""
    return self.config["num_envs"]

  @property
  def all_env_ids(self) -> np.ndarray:
    if not hasattr(self, "_all_env_ids"):
      self._all_env_ids = np.arange(
        self.config["num_envs"], dtype=np.int32
      )
    return self._all_env_ids

  @property
  def is_async(self) -> bool:
    return self.config["batch_size"] > 0 and (
      self.config["num_envs"] != self.config["batch_size"]
    )

  def seed(self, seed: Optional[Union[int, List[int]]] = None) -> None:
    """Abandoned, kept for API compatibility."""
    warnings.warn(
      "The `seed` function in envpool is abandoned. "
      "You can set seed by make(..., seed=seed) instead.",
      stacklevel=2,
    )

  def send(
    self,
    action: Union[Dict[str, Any], np.ndarray],
    env_id: Optional[np.ndarray] = None,
  ) -> None:
    """Send a batch of actions; the device steps on its stream."""
    action = self._from(action, env_id)
    self._check_action(action)
    self._send(action)

  def recv(
    self,
    reset: bool = False,
    return_info: bool = True,
  ) -> Any:
    """Receive the oldest finished batch, converted to this dialect."""
    state_list = self._recv()
    return self._to(state_list, reset, return_info)

  def async_reset(self) -> None:
    """Async-mode entry: enqueue a reset for every env."""
    self._reset(self.all_env_ids)

  def step(
    self,
    action: Union[Dict[str, Any], np.ndarray],
    env_id: Optional[np.ndarray] = None,
  ) -> Any:
    """Synchronous step: send then recv."""
    self.send(action, env_id)
    return self.recv(reset=False, return_info=True)

  def reset(self, env_id: Optional[np.ndarray] = None) -> Any:
    """Reset env_id (all by default) and return their first timestep."""
    if env_id is None:
      env_id = self.all_env_ids
    self._reset(env_id)
    return self.recv(
      reset=True, return_info=self.config["gym_reset_return_info"]
    )

  def __repr__(self) -> str:
    config = self.config
    config_str = ", ".join(
      f"{k}={pprint.pformat(v)}" for k, v in config.items()
    )
    return f"{self.__class__.__name__}({config_str})"

  def __str__(self) -> str:
    return self.__repr__()


class DMConvertMixin:
  """dm_env output conversion."""

  def _init_dialect(self, spec: EnvSpec) -> None:
    self._dm_structure = dm_structure("State", spec._state_keys)

  def observation_spec(self) -> Tuple:
    if not hasattr(self, "_dm_observation_spec"):
      self._dm_observation_spec = self.spec.observation_spec()
    return self._dm_observation_spec

  def action_spec(self) -> Any:
    if not hasattr(self, "_dm_action_spec"):
      self._dm_action_spec = self.spec.action_spec()
    return self._dm_action_spec

  def _to(
    self, state_values: List[np.ndarray], reset: bool, return_info: bool
  ) -> Any:
    from dm_env import TimeStep
    state = fill_structure(self._dm_structure, state_values)
    return TimeStep(
      step_type=state.step_type,
      observation=state.State,
      reward=state.reward,
      discount=state.discount,
    )


class GymnasiumConvertMixin:
  """gymnasium 5-tuple conversion (``gymnasium_envpool.py:74-90``)."""

  def _init_dialect(self, spec: EnvSpec) -> None:
    self._structure = gymnasium_structure(spec._state_keys)

  @property
  def observation_space(self) -> Any:
    if not hasattr(self, "_gym_observation_space"):
      self._gym_observation_space = self.spec.gymnasium_observation_space
    return self._gym_observation_space

  @property
  def action_space(self) -> Any:
    if not hasattr(self, "_gym_action_space"):
      self._gym_action_space = self.spec.gymnasium_action_space
    return self._gym_action_space

  def _to(
    self, state_values: List[np.ndarray], reset: bool, return_info: bool
  ) -> Any:
    state = fill_structure(self._structure, state_values)
    info = state["info"]
    info["elapsed_step"] = state["elapsed_step"]
    if reset:
      return state["obs"], info
    terminated = state["done"] & ~state["trunc"]
    return state["obs"], state["reward"], terminated, state["trunc"], info


class GymConvertMixin:
  """Legacy-gym conversion incl. pre-0.26 quirks (``gym_envpool.py:75-97``)."""

  def _init_dialect(self, spec: EnvSpec) -> None:
    self._structure = gym_structure(spec._state_keys)
    try:
      import gym
      from packaging import version
      self._new_gym_api = version.parse(
        gym.__version__
      ) >= version.parse("0.26.0")
    except ImportError:
      # behave like modern gym for tuple shapes; spaces will raise if used
      self._new_gym_api = True

  @property
  def observation_space(self) -> Any:
    if not hasattr(self, "_gym_observation_space"):
      self._gym_observation_space = self.spec.observation_space
    return self._gym_observation_space

  @property
  def action_space(self) -> Any:
    if not hasattr(self, "_gym_action_space"):
      self._gym_action_space = self.spec.action_space
    return self._gym_action_space

  def _to(
    self, state_values: List[np.ndarray], reset: bool, return_info: bool
  ) -> Any:
    state = fill_structure(self._structure, state_values)
    if reset and not (return_info or self._new_gym_api):
      return state["obs"]
    info = state["info"]
    if not self._new_gym_api:
      info["TimeLimit.truncated"] = state["trunc"]
    info["elapsed_step"] = state["elapsed_step"]
    if reset:
      return state["obs"], info
    if self._new_gym_api:
      terminated = state["done"] & ~state["trunc"]
      return state["obs"], state["reward"], terminated, state["trunc"], info
    return state["obs"], state["reward"], state["done"], info


def _dialect_class(name: str, mixin: type, base_pool: type) -> type:
  """Build one concrete dialect class over a pool engine base."""

  def __init__(self, spec: EnvSpec, device: Any = None) -> None:  # noqa: N807
    base_pool.__init__(self, spec, device)
    self._init_dialect(spec)

  return type(
    name, (base_pool, mixin, EnvPoolMixin), {"__init__": __init__}
  )


DMEnvPool = _dialect_class("DMEnvPool", DMConvertMixin, TorchEnvPool)
GymnasiumEnvPool = _dialect_class(
  "GymnasiumEnvPool", GymnasiumConvertMixin, TorchEnvPool
)
GymEnvPool = _dialect_class("GymEnvPool", GymConvertMixin, TorchEnvPool)


def py_env(
  env_cls: Type[FuncEnv],
  pool_base: type = TorchEnvPool,
) -> Tuple[Type[EnvSpec], type, type, type]:
  """Synthesize (Spec, DMEnvPool, GymEnvPool, GymnasiumEnvPool) classes.

  Counterpart of ``envpool/python/api.py:25-52``: class names follow the
  same ``{Family}{Dialect}EnvPool`` convention.
  """
  name = env_cls.name
  spec_cls = make_spec_cls(env_cls)
  dm_cls = _dialect_class(f"{name}DMEnvPool", DMConvertMixin, pool_base)
  gym_cls = _dialect_class(f"{name}GymEnvPool", GymConvertMixin, pool_base)
  gymnasium_cls = _dialect_class(
    f"{name}GymnasiumEnvPool", GymnasiumConvertMixin, pool_base
  )
  return spec_cls, dm_cls, gym_cls, gymnasium_cls
