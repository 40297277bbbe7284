#!/usr/bin/env python3
"""Where the CarRacing background kernel's time goes, on one CUDA card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
nvcc:

  python3 tools/background_ablation.py

Builds ``envpool_torch/csrc/car_racing_sampler.cu`` and variants of it made
by editing its source (a part taken out, or a design choice undone), runs
each through the wrapper on ``chip_smoke.py``'s inputs (the main path's own
at 1024 envs: all fine, half of each, all coarse; and random), and prints
the warm and cold microseconds of each, in turns (all variants, then all in
reverse). Variants that keep the function are checked bit-exact against the
plain version; the others compute something else and are timed only.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "envpool_torch" / "csrc" / "car_racing_sampler.cu"
OUT_DIR = ROOT / "build" / "ablation"

ROW_LOOP = "#pragma unroll 1\n  for (int i"
WALK = """      int r = step(max(r_in, 0), sh4_c[k], s);
      int c = step(max(c_in[k], 0), sh3[r], s);
      r = step(r, sh2[c], s);
      c = step(c, sh1[r], s);"""
GATHER = "const uint8_t v = __ldg(win + (inside ? r * bank_cols + c : 0));"
FAST_MOD = "  if (x >= -s && x < s) return static_cast<int16_t>(x < 0 ? x + s : x);\n"
AFTER_STAGING = "  // a window outside the bank is never read"

# name: (edits, keeps the function)
VARIANTS = {
  "kernel": ([], True),
  "unroll_2": ([(ROW_LOOP, "#pragma unroll 2\n  for (int i")], True),
  "division_mod": ([(FAST_MOD, "")], True),
  "no_gather": ([(GATHER, "const uint8_t v = (r ^ c) & 7;")], False),
  "no_walk": ([(WALK, "      int r = max(r_in, 0);\n      int c = max(c_in[k], 0);")], False),
  "staging_only": ([(AFTER_STAGING, (
    "  if (tid == 0) out[e] = pal_s[rows_s[0] & 255] + sh1[0] + cols_s[0];\n"
    "  return;\n" + AFTER_STAGING
  ))], False),
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
    cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
    cu.write_text(src)
    procs[name] = (so, subprocess.Popen(
      [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ))
  fns = {}
  for name, (so, proc) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode != 0:
      raise RuntimeError(f"{name}: nvcc failed\n{log}")
    regs = [l.split(":", 1)[1].strip() for l in log.splitlines() if "registers" in l]
    print(f"{name}: {'; '.join(regs)}", flush=True)
    fns[name] = ctypes.CDLL(str(so)).car_racing_background
  return fns


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print("background_ablation: no CUDA device", file=sys.stderr)
    return 1
  sys.path.insert(0, str(ROOT))
  import chip_smoke as cs
  import envpool_torch
  from envpool_torch.envs.box2d import car_racing, sampler

  fns = build()
  ref = sampler._kernel()
  for fn in fns.values():
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
  print(cs.card_line())
  palette = car_racing._constants(torch.device("cuda"))["palette1"]
  for case, (fine, coarse, use_fine) in cs.background_cases(
    torch, envpool_torch, "cuda"
  ).items():
    args = (fine, coarse, use_fine, palette)
    want = sampler.background_plain(*args)
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(list(fns))]:
      with mock.patch.object(sampler, "_kernel", lambda fn=fns[name]: fn):
        got = sampler.fused_background(*args)
        if VARIANTS[name][1] and not torch.equal(got, want):
          raise AssertionError(f"{name} on {case}: differs from the plain version")
        warm = cs.time_cuda(torch, lambda: sampler.fused_background(*args), 100)
        cold = cs.time_cold(torch, lambda: sampler.fused_background(*args))
      times[name].append((warm, cold))
    for name, runs in times.items():
      print(f"{case:12s} {name:13s} " + "  ".join(
        f"warm {1e3 * w:6.2f} us cold {1e3 * c:6.2f} us" for w, c in runs
      ), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
