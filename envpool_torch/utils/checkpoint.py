"""Checkpoint/resume for env-pool state.

The port of ``envpool_tpu/utils/checkpoint.py``. A pool's state is a tree
of arrays (``save_state()``), so a snapshot is one ``.npz``: the leaves as
``leaf_<i>`` and the tree's structure as a JSON entry, ``tree``. No orbax
and no pickle: the file reads back with numpy alone. Any pool with
``save_state``/``load_state`` works, ``TorchEnvPool`` and
``ShardedEnvPool`` alike, and a snapshot of one loads into the other.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, List

import numpy as np

from envpool_torch.core.pool import PoolState


def _npz_path(path: str) -> str:
  return path if path.endswith(".npz") else path + ".npz"


def _flatten(tree: Any, leaves: List[np.ndarray]) -> Any:
  """The JSON structure of ``tree``; its leaves appended to ``leaves``."""
  if isinstance(tree, dict):
    return {"dict": [[k, _flatten(v, leaves)] for k, v in tree.items()]}
  if isinstance(tree, tuple) and hasattr(tree, "_fields"):
    return {"namedtuple": type(tree).__name__, "fields": list(tree._fields),
            "items": [_flatten(v, leaves) for v in tree]}
  if isinstance(tree, (tuple, list)):
    return {"tuple": [_flatten(v, leaves) for v in tree]}
  leaves.append(np.asarray(tree))
  return {"leaf": len(leaves) - 1}


def _unflatten(node: Any, leaves: List[np.ndarray]) -> Any:
  if "leaf" in node:
    return leaves[node["leaf"]]
  if "dict" in node:
    return {k: _unflatten(v, leaves) for k, v in node["dict"]}
  if "tuple" in node:
    return tuple(_unflatten(v, leaves) for v in node["tuple"])
  items = [_unflatten(v, leaves) for v in node["items"]]
  if node["namedtuple"] == "PoolState" and node["fields"] == list(PoolState._fields):
    return PoolState(*items)
  return collections.namedtuple(node["namedtuple"], node["fields"])(*items)


def save_pool_state(pool: Any, path: str) -> None:
  """Write ``pool.save_state()`` to ``path`` (``.npz`` appended if
  missing)."""
  leaves: List[np.ndarray] = []
  tree = _flatten(pool.save_state(), leaves)
  path = _npz_path(path)
  os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
  with open(path, "wb") as f:
    np.savez(f, tree=np.array(json.dumps(tree)),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def load_pool_state(pool: Any, path: str) -> None:
  """Restore a snapshot written by ``save_pool_state`` into ``pool``."""
  with np.load(_npz_path(path), allow_pickle=False) as data:
    tree = json.loads(str(data["tree"]))
    leaves = [np.array(data[f"leaf_{i}"]) for i in range(len(data.files) - 1)]
  pool.load_state(_unflatten(tree, leaves))
