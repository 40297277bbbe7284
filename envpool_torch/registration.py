# Portions derived from EnvPool (https://github.com/sail-sg/envpool),
# Copyright 2021 Garena Online Private Limited, licensed under the
# Apache License, Version 2.0 (http://www.apache.org/licenses/LICENSE-2.0).
# Modifications Copyright 2026 the envpool_tpu authors, same license.
"""Global env registry of the port.

Same public surface as ``envpool_tpu/registration.py`` and the reference
registry (``envpool/registration.py:26-115``). The makers take one more
keyword, ``device`` (default None: the CUDA device), which selects where the
pool lives; it is not a config key, so specs of both packages agree.
"""

from __future__ import annotations

import importlib
import os
from typing import Any, Dict, List, Tuple

base_path = os.path.abspath(os.path.dirname(__file__))


class EnvRegistry:
  """A collection of available envs."""

  def __init__(self) -> None:
    self.specs: Dict[str, Tuple[str, str, Dict[str, Any]]] = {}
    self.envpools: Dict[str, Dict[str, Tuple[str, str]]] = {}

  def register(
    self, task_id: str, import_path: str, spec_cls: str, dm_cls: str,
    gym_cls: str, gymnasium_cls: str, **kwargs: Any
  ) -> None:
    """Register EnvSpec and EnvPool in the global registry."""
    assert task_id not in self.specs
    if "base_path" not in kwargs:
      kwargs["base_path"] = base_path
    self.specs[task_id] = (import_path, spec_cls, kwargs)
    self.envpools[task_id] = {
      "dm": (import_path, dm_cls),
      "gym": (import_path, gym_cls),
      "gymnasium": (import_path, gymnasium_cls),
    }

  def make(
    self, task_id: str, env_type: str, device: Any = None, **kwargs: Any
  ) -> Any:
    """Make an envpool instance of the given dialect on ``device``."""
    new_gym_api = True
    try:
      import gym
      from packaging import version
      new_gym_api = version.parse(
        gym.__version__
      ) >= version.parse("0.26.0")
    except ImportError:
      pass
    if "gym_reset_return_info" not in kwargs:
      kwargs["gym_reset_return_info"] = new_gym_api
    if new_gym_api and not kwargs["gym_reset_return_info"]:
      raise ValueError(
        "You are using gym>=0.26.0 but passed `gym_reset_return_info=False`."
        " The new gym API requires environments to return an info dictionary"
        " after resets."
      )

    assert task_id in self.specs, (
      f"{task_id} is not supported, `list_all_envs()` may help."
    )
    assert env_type in ["dm", "gym", "gymnasium"]

    spec = self.make_spec(task_id, **kwargs)
    import_path, envpool_cls = self.envpools[task_id][env_type]
    return getattr(importlib.import_module(import_path), envpool_cls)(
      spec, device
    )

  def make_dm(self, task_id: str, **kwargs: Any) -> Any:
    """Make a dm_env-dialect pool."""
    return self.make(task_id, "dm", **kwargs)

  def make_gym(self, task_id: str, **kwargs: Any) -> Any:
    """Make a (legacy) gym-dialect pool."""
    return self.make(task_id, "gym", **kwargs)

  def make_gymnasium(self, task_id: str, **kwargs: Any) -> Any:
    """Make a gymnasium-dialect pool."""
    return self.make(task_id, "gymnasium", **kwargs)

  def make_spec(self, task_id: str, **make_kwargs: Any) -> Any:
    """Build the validated EnvSpec for a task."""
    import_path, spec_cls, kwargs = self.specs[task_id]
    kwargs = {**kwargs, **make_kwargs}

    if "seed" in kwargs:
      int_max = 2**31
      assert -int_max <= kwargs["seed"] < int_max, (
        f"Seed should be in range of int32, got {kwargs['seed']}"
      )
    if "num_envs" in kwargs:
      assert kwargs["num_envs"] >= 1
    if "batch_size" in kwargs:
      assert 0 <= kwargs["batch_size"] <= kwargs.get("num_envs", 1)
    if "max_num_players" in kwargs:
      assert 1 <= kwargs["max_num_players"]

    spec_cls = getattr(importlib.import_module(import_path), spec_cls)
    config = spec_cls.gen_config(**kwargs)
    return spec_cls(config)

  def list_all_envs(self) -> List[str]:
    """Return all available task ids."""
    return list(self.specs.keys())


# global registry singleton
registry = EnvRegistry()
register = registry.register
make = registry.make
make_dm = registry.make_dm
make_gym = registry.make_gym
make_gymnasium = registry.make_gymnasium
make_spec = registry.make_spec
list_all_envs = registry.list_all_envs
