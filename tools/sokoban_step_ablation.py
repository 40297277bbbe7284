#!/usr/bin/env python3
"""Where the Sokoban step kernel's time goes, on one CUDA card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
nvcc:

  python3 tools/sokoban_step_ablation.py

Builds ``envpool_torch/csrc/sokoban_step.cu`` and variants of it made by
editing its source (a stage taken out, or another block shape), one nvcc
per variant, all started together. Runs each through ``SokobanEnv.step`` /
``reset`` on ``chip_smoke.py``'s phase-3 inputs (16384 envs after 30
steps, both level modes) and prints the warm microseconds of each case, in
turns (all variants, then all in reverse). Variants that keep the function
(the block shapes) are checked bit-exact against ``step_plain`` /
``reset_plain``; the others compute something else and are timed only.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "envpool_torch" / "csrc" / "sokoban_step.cu"
OUT_DIR = ROOT / "build" / "ablation"

OBS_RUN = "const int n_obs = 3 * run;"
WORLD_OUT = [("d4[q] = s4[q];", ";"), ("wo[c] = tile[c];", ";")]
NEED_WORLD = ("kMode == kStep || (kMode == kAdvance && "
              "(!a.force_reset || a.mask != nullptr));")
ENTRY = "  const int t = threadIdx.x;\n"


def shape(envs: int, threads: int, min_blocks: int) -> list:
  """The edits to another block shape: envs and threads a block, and the
  blocks an SM that ``__launch_bounds__`` asks for (the source's 32, 256
  and 4 stay where they are kept)."""
  edits = [("constexpr int kEnvs = 32;", f"constexpr int kEnvs = {envs};"),
           ("constexpr int kThreads = 256;", f"constexpr int kThreads = {threads};"),
           ("__launch_bounds__(kThreads, 4)",
            f"__launch_bounds__(kThreads, {min_blocks})")]
  return [(old, new) for old, new in edits if old != new]


# name: (edits, keeps the function)
VARIANTS = {
  "kernel": ([], True),
  "empty": ([(ENTRY, ENTRY + "  if (t >= 0) return;\n")], False),
  "no_obs": ([(OBS_RUN, "const int n_obs = 0;")], False),
  "no_world_out": (WORLD_OUT, False),
  "no_world_in": ([(NEED_WORLD, "false;")], False),
  "no_world_io": ([(OBS_RUN, "const int n_obs = 0;"), *WORLD_OUT,
                   (NEED_WORLD, "false;")], False),
  "e16_t64": (shape(16, 64, 16), True),
  "e16_t128": (shape(16, 128, 8), True),
  "e32_t128": (shape(32, 128, 8), True),
  "e32_t512": (shape(32, 512, 2), True),
  "e64_t512": (shape(64, 512, 2), True),
}


def build() -> dict:
  from envpool_torch import _build

  OUT_DIR.mkdir(parents=True, exist_ok=True)
  base = SOURCE.read_text()
  procs = {}
  for name, (edits, _) in VARIANTS.items():
    src = base
    for old, new in edits:
      if old not in src:
        raise RuntimeError(f"{name}: the kernel source no longer has {old!r}")
      src = src.replace(old, new)
    cu, so = OUT_DIR / f"sokoban_{name}.cu", OUT_DIR / f"sokoban_{name}.so"
    cu.write_text(src)
    procs[name] = (so, subprocess.Popen(
      [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent), "-o",
       str(so), str(cu)],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ))
  fns = {}
  for name, (so, proc) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode != 0:
      raise RuntimeError(f"{name}: nvcc failed\n{log}")
    regs = [l.strip() for l in log.splitlines()
            if "registers" in l or "spill" in l]
    print(f"{name}: {'; '.join(dict.fromkeys(regs))}", flush=True)
    fns[name] = ctypes.CDLL(str(so)).sokoban_launch
  return fns


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print("sokoban_step_ablation: no CUDA device", file=sys.stderr)
    return 1
  sys.path.insert(0, str(ROOT))
  import chip_smoke as cs
  import envpool_torch
  from envpool_torch.envs.sokoban import sokoban
  from envpool_torch.envs.sokoban.sokoban import SokobanEnv

  print(cs.card_line(), flush=True)
  fns = build()
  ref = sokoban._kernel()
  for fn in fns.values():
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
  for case, (cfg, state, action, keys) in cs.sokoban_step_cases(
    torch, envpool_torch, "cuda"
  ).items():
    if action is None:
      run = lambda: SokobanEnv.reset(cfg, state, keys)
      want = SokobanEnv.reset_plain(cfg, state, keys)
    else:
      run = lambda: SokobanEnv.step(cfg, state, action, keys)
      want = SokobanEnv.step_plain(cfg, state, action, keys)
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(list(fns))]:
      with mock.patch.object(sokoban, "_kernel", lambda fn=fns[name]: fn):
        got = run()
        if VARIANTS[name][1] and cs.bit_diff(torch, got, want):
          raise AssertionError(f"{name} on {case}: differs from the plain version")
        times[name].append(cs.time_cuda(torch, run, 100))
    for name, runs in times.items():
      print(f"{case:18s} {name:13s} "
            + " ".join(f"{1e3 * w:6.2f}" for w in runs) + " us warm", flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
