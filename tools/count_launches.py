"""Count the eager launches of one port step on the CPU.

Runs one ``xla()`` step of an ``envpool_torch`` pool on the CPU under a
``TorchDispatchMode`` that counts the aten ops it dispatches (views and
other ops that launch no kernel excluded), once with no lane resetting and
once with one lane's done flag set, so that the reset branch runs too. On
the card each counted op is about one kernel launch (a few ops launch more
than one, e.g. ``linalg`` solves). For the on-device MuJoCo ids (gym
``-Jax-v4`` and dm_control ``-Jax-v1``) it also counts one forward-dynamics
evaluation (``_qacc_full``) alone, for the contact ids one Newton iteration
of the contact solve (``newton_qacc`` with one iteration less that with
none), and for the cylinder and box models one pass of each such block of
the narrow phase (plane-cylinder, sphere/capsule-cylinder, plane-box,
sphere/capsule-box).

  python tools/count_launches.py --envs 8192 ReacherJax-v4 SwimmerJax-v4
  python tools/count_launches.py --envs 4096 CheetahJaxRun-v1
  python tools/count_launches.py --envs 4096 PusherJax-v4 ManipulatorJaxInsertPeg-v1
  python tools/count_launches.py --envs 1024 HumanoidCMUJaxRun-v1

Prints one JSON line per id. Counts depend on the width only through the
data (which lanes reset), so count at the width that runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(
  0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import envpool_torch  # noqa: E402

# ops that only make a view or read metadata: no kernel on the card
_NO_LAUNCH = {
  "view", "_unsafe_view", "expand", "slice", "select", "unsqueeze",
  "squeeze", "permute", "transpose", "t", "alias", "detach", "as_strided",
  "unbind", "split", "split_with_sizes", "lift_fresh", "reshape",
  "_reshape_alias", "diagonal", "unfold", "sym_size", "sym_stride",
  "sym_numel", "is_nonzero", "_local_scalar_dense", "item",
}


class Count(TorchDispatchMode):
  """Counts dispatched aten ops by name."""

  def __init__(self):
    super().__init__()
    self.ops: Counter = Counter()

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    name = func.overloadpacket.__name__
    if name not in _NO_LAUNCH:
      self.ops[name] += 1
    return func(*args, **(kwargs or {}))


def _actions(env, n: int, rng) -> torch.Tensor:
  space = env.action_space
  if hasattr(space, "n"):
    return torch.from_numpy(rng.integers(0, space.n, n).astype(np.int32))
  return torch.from_numpy(
    rng.uniform(space.low, space.high, (n, *space.shape)).astype(np.float32)
  )


def count(task_id: str, n: int) -> dict:
  torch.set_num_threads(1)
  env = envpool_torch.make_gymnasium(
    task_id, num_envs=n, seed=0, device="cpu"
  )
  rng = np.random.default_rng(0)
  env.reset()
  handle, _, send, _ = env.xla()
  handle = send(handle, _actions(env, n, rng))
  res = {"task_id": task_id, "envs": n}
  done = torch.zeros(n, dtype=torch.bool)
  one = done.clone()
  one[0] = True
  for name, flags in (("step_only", done), ("with_reset", one)):
    h = handle._replace(pool=handle.pool._replace(done=flags))
    with Count() as c:
      send(h, _actions(env, n, rng))
    res[name] = sum(c.ops.values())
    res[name + "_top"] = dict(c.ops.most_common(6))
  env_cls = env.spec._env_cls
  if task_id.endswith(("Jax-v4", "-v1")) and "Jax" in task_id:
    from envpool_torch.envs.mujoco import device_collision as dc
    from envpool_torch.envs.mujoco import device_engine as de
    if task_id.endswith("-v1"):  # dm_control: the model and substeps by task
      mdl = env_cls.mdl(env.spec.config)
      frame_skip = int(env.spec.config.frame_skip)
    else:
      mdl, frame_skip = env_cls.mdl(), env_cls.frame_skip
    st = handle.pool.env
    q, v = st["q"], st["v"]
    tau = torch.zeros_like(v)
    de._qacc_full(mdl, q, v, tau)
    with Count() as c:
      de._qacc_full(mdl, q, v, tau)
    res["forward_eval"] = sum(c.ops.values())
    res["forward_evals_per_step"] = (
      4 if mdl.integrator == 1 else 1) * frame_skip
    cd = mdl.contacts
    if cd is not None:
      xpos, xmat, _, _ = de.fk(mdl, q)
      X, R = torch.stack(xpos, 1), torch.stack(xmat, 1)
      c = dc._cconsts(mdl, q)
      for name, block, has in (
        ("plane_cylinder", dc._plane_cylinder, cd.pcy_plane),
        ("capsule_cylinder", dc._capsule_cylinder, cd.cyc_cap),
        ("plane_box", dc._plane_box, cd.pb_plane),
        ("capsule_box", dc._sphere_capsule_box, cd.sb_cap),
      ):
        if has:
          with Count() as cnt:
            block(cd, c, X, R)
          res[name + "_block"] = sum(cnt.ops.values())
    if de._has_contact_points(mdl):
      M, qfrc, ctx = de._qacc_smooth_parts(mdl, q, v, tau)
      rows = dc.assemble_rows(mdl, mdl.contacts, q, v, ctx)
      a0 = de._solve_psd(M, qfrc, floor=de._dof_floor(mdl))
      cd = mdl.contacts
      counts = []
      for iters in (0, 1):
        with Count() as c:
          dc.newton_qacc(de._dof_floor(mdl), M, a0, *rows, iters=iters,
                         ls_iters=cd.newton_ls)
        counts.append(sum(c.ops.values()))
      res["newton_iteration"] = counts[1] - counts[0]
      res["newton_iters"], res["newton_ls"] = cd.newton_iters, cd.newton_ls
  return res


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("task_ids", nargs="+")
  parser.add_argument("--envs", type=int, default=8192)
  args = parser.parse_args()
  for task_id in args.task_ids:
    print(json.dumps(count(task_id, args.envs)), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
