# Portions derived from EnvPool (https://github.com/sail-sg/envpool),
# Copyright 2021 Garena Online Private Limited, licensed under the
# Apache License, Version 2.0 (http://www.apache.org/licenses/LICENSE-2.0).
# Modifications Copyright 2026 the envpool_tpu authors, same license.
"""Flat-key <-> tree conversion and RL-API spec/space transforms.

The port's copy of ``envpool_tpu/core/data.py`` without ``optree``: the
dialect structures are plain nested dicts / namedtuples whose leaves are
indices into the flat state list, and ``fill_structure`` replaces each
index with its value. ``gym``, ``gymnasium`` and ``dm_env`` stay lazy
imports, used only for specs and spaces.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Any, Dict, Iterator, List, Sequence, Tuple, Type

import numpy as np

from .spec import ArraySpec

ACTION_THRESHOLD = 2**20


def to_nested_dict(flatten_dict: Dict[str, Any],
                   generator: Type = dict) -> Dict[str, Any]:
  """Convert ``{"a.b": x}`` style flat dicts into ``{"a": {"b": x}}``."""
  ret: Dict[str, Any] = generator()
  for k, v in flatten_dict.items():
    segments = k.split(".")
    ptr = ret
    for s in segments[:-1]:
      if s not in ptr:
        ptr[s] = generator()
      ptr = ptr[s]
    ptr[segments[-1]] = v
  return ret


def to_namedtuple(name: str, hdict: Dict) -> Tuple:
  """Recursively convert a hierarchical dict into a namedtuple."""
  return namedtuple(name, hdict.keys())(
    *[
      to_namedtuple(k, v) if isinstance(v, dict) else v
      for k, v in hdict.items()
    ]
  )


def flatten_with_path(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
  """Yield ``("a.b", leaf)`` pairs of a nested dict (the action dicts)."""
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from flatten_with_path(v, f"{prefix}{k}.")
  else:
    yield prefix[:-1], tree


def fill_structure(structure: Any, values: Sequence[Any]) -> Any:
  """Replace every integer leaf ``i`` of a dict/namedtuple tree by
  ``values[i]`` (the inverse of flattening the state list)."""
  if isinstance(structure, dict):
    return {k: fill_structure(v, values) for k, v in structure.items()}
  if isinstance(structure, tuple):
    return type(structure)(*(fill_structure(v, values) for v in structure))
  return values[structure]


def _is_discrete(spec: ArraySpec) -> bool:
  """Discrete-space heuristic shared by all three dialects."""
  return (
    np.prod(np.abs(spec.shape)) == 1 and np.isclose(spec.minimum, 0) and
    spec.maximum < ACTION_THRESHOLD
  )


def dm_spec_transform(name: str, spec: ArraySpec, spec_type: str) -> Any:
  """ArraySpec -> dm_env specs."""
  import dm_env.specs
  if _is_discrete(spec):
    return dm_env.specs.DiscreteArray(
      name=name,
      dtype=spec.dtype,
      num_values=int(spec.maximum - spec.minimum + 1),
    )
  return dm_env.specs.BoundedArray(
    name=name,
    shape=[s for s in spec.shape if s != -1],
    dtype=spec.dtype,
    minimum=spec.minimum,
    maximum=spec.maximum,
  )


def gym_spec_transform(name: str, spec: ArraySpec, spec_type: str) -> Any:
  """ArraySpec -> (legacy) gym spaces. Requires the optional gym package."""
  try:
    import gym
  except ImportError as e:  # pragma: no cover - env-dependent
    raise ImportError(
      "the legacy `gym` package is not installed; use the gymnasium or "
      "dm_env dialect, or install gym"
    ) from e
  if _is_discrete(spec):
    discrete_range = int(spec.maximum - spec.minimum + 1)
    try:
      return gym.spaces.Discrete(n=discrete_range, start=int(spec.minimum))
    except TypeError:  # old gym has no `start`
      return gym.spaces.Discrete(n=discrete_range)
  return gym.spaces.Box(
    shape=[s for s in spec.shape if s != -1],
    dtype=spec.dtype,
    low=spec.minimum,
    high=spec.maximum,
  )


def gymnasium_spec_transform(name: str, spec: ArraySpec,
                             spec_type: str) -> Any:
  """ArraySpec -> gymnasium spaces."""
  import gymnasium
  if _is_discrete(spec):
    discrete_range = int(spec.maximum - spec.minimum + 1)
    return gymnasium.spaces.Discrete(
      n=discrete_range, start=int(spec.minimum)
    )
  return gymnasium.spaces.Box(
    shape=[s for s in spec.shape if s != -1],
    dtype=spec.dtype,
    low=spec.minimum,
    high=spec.maximum,
  )


def dm_structure(root_name: str, keys: List[str]) -> Tuple:
  """Index tree for the dm_env dialect (obs and info merged under the root).

  Same key-rewriting rules as ``envpool/python/data.py:126-147``.
  """
  new_keys = []
  for key in keys:
    if key in ["obs", "info"]:  # single-node obs/info
      key = f"obs:{key}"
    key = key.replace("info:", "obs:")  # merge obs and info together
    key = key.replace("obs:", f"{root_name}:")
    new_keys.append(key.replace(":", "."))
  dict_tree = to_nested_dict(dict(zip(new_keys, range(len(new_keys)))))
  return to_namedtuple(root_name, dict_tree)


def gym_structure(keys: List[str]) -> Dict[str, Any]:
  """Index tree for the gym/gymnasium dialects (plain nested dict)."""
  keys = [k.replace(":", ".") for k in keys]
  return to_nested_dict(dict(zip(keys, range(len(keys)))))


gymnasium_structure = gym_structure


def check_key_duplication(cls: Any, keytype: str, keys: List[str]) -> None:
  """Raise if any key appears twice in a schema."""
  ukeys, counts = np.unique(np.asarray(keys), return_counts=True)
  if not np.all(counts == 1):
    dup_keys = ukeys[counts > 1]
    raise SystemError(
      f"{cls} schema error. {keytype} keys {list(dup_keys)} are duplicated."
    )
