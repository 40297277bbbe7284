#!/usr/bin/env python3
"""Drive the envpool_torch port once on one CUDA card and check it.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
nvcc (``/usr/local/cuda``):

  python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
  1. the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from ``envpool_torch/csrc`` (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (CarRacing-v2, 1024 envs, 8 tracks), bit-exact, with
     times from CUDA events (L2 warm, and cold: 64 MB written before each
     launch) and the byte bound. The background kernel runs on the main
     path's own inputs (all coarse after a reset, all fine after 60 steps,
     half of each) and on random inputs with a random per-env path. The
     threefry kernel (``csrc/threefry.cu``) against ``threefry_plain`` at
     Sokoban's shapes (16384 keys: the pool's split of a strided view, a
     contiguous split, a single-word draw, the pool's fold_in under a
     broadcast key), at 1 key x 131,072 counters (PPO's permutation) and on
     empty outputs; the step kernel (``csrc/sokoban_step.cu``) at 16384
     envs in both level modes, from a pool's state after a reset and 30
     steps, actions in [-5, 7], its step and its reset mode, against
     ``step_plain``/``reset_plain`` on the card and on CPU copies, every
     output bit for bit; both timed warm and cold beside their bound (bytes,
     and threefry blocks at THREEFRY_OPS 32-bit operations) and their plain
     time, threefry also beside an empty kernel of its grid (the launch
     floor); the same kernel's advance mode (the pool's whole advance, one
     launch) at 16384 envs in both level modes, from a pool's state after 30
     steps with the carried done flag set on 2% of the lanes: a full send,
     a masked send to a quarter of the lanes, a forced reset and a forced
     masked reset, against the pool's general path over the plain versions
     (``_advance_ids(..., plain=True)``) on the card and in a CPU pool, the
     new pool state and every output bit for bit, each timed warm and cold
     beside the pool step's bound and the plain advance's time; the
     wrappers' host microseconds per call;
  4. the main path: ``make_gymnasium("CarRacing-v2", num_envs=1024)`` on the
     card, reset + 300 steps; a pool with ``max_episode_steps=64`` over 150
     steps (every lane auto-resets twice); an async pool (batch 256) for 20
     steps; a 100-step ``xla()`` loop and ``commit()``. The background
     kernel's launch count must grow by exactly one per render;
  5. the card against the port on the CPU: the card pool's snapshot loaded
     into a CPU pool, one step each with the same actions;
  6. Sokoban-v0, the headline workload, at the width ``bench.py`` runs it:
     ``make_gymnasium("Sokoban-v0", num_envs=16384, max_episode_steps=60,
     levels_dir="", n_levels_to_load=1024)``, reset + 150 steps of random
     actions in [-1, 3] (every lane must auto-reset, NaN rewards exactly at
     the noops), timed through ``step`` and through a 150-step ``xla()``
     loop; sequential mode on the sample levels (1024 envs, 200 steps: the
     level indices follow the stream); a 256-env pool of each mode on the
     card against the CPU port over 100 steps (200 until phase 17's run
     outgrew the time limit), every output field bit for
     bit; one ``torch.profiler`` trace of ``xla()`` steps (device time,
     launches per step, idle share). The headline run is the main path of
     the advance kernel: the counts start at 0 before it, the advance kernel
     must launch exactly once per advance (1 + 300), threefry only at the
     pool's init (2), the step and reset modes and the set kernel never,
     and the trace gives each kernel's time and launches per step;
  7. CartPole-v1 at 8192 envs (``bench.py``'s width), the card against the
     CPU port step for step, to float tolerance;
  8. PPO (``envpool_torch.train``): ``examples/ppo_sokoban.py``'s
     configuration (Sokoban-v0 as in phase 6, the full-width bf16
     ``SokobanCNN()``, ``PPOConfig(num_steps=32, lr=2.5e-4)``) at 1024 and
     16384 envs, the rollout captured: 2 iterations with the update eager
     (the iteration before the update was captured), then 3 and 2 from the same state with the update
     captured (``graph.CapturedCall``), after 2 iterations the parameters,
     Adam state, key, handle and metrics bit for bit against the eager
     update's; each iteration's env-steps/s, rollout and update times by
     CUDA events, the update graph's capture and instantiate seconds and
     nodes, every metric finite, ``mean_reward`` in the Sokoban range, the
     parameters changed, then a rollout and a captured update traced apart
     (launches, device time, idle share); one float32
     iteration on the card against the CPU port from the same parameters
     and key (TF32 off; equal actions >= 0.99, parameters within 1e-4); PPO
     learning CartPole-v1 on the card with ``tests/test_learning.py``'s
     configuration and asserts;
  9. the small device families, which reach no kernel of their own:
     PongJaxDemo-v5 at 4096 envs for 128 steps (``bench.py:343-344``;
     gray, 84x84, stack 4, frame_skip 4), MiniGrid-Empty-8x8-v0 and
     MiniGrid-Empty-Random-6x6-v0 at 8192 envs (``bench.py:338-339``), 300
     and 150 steps, and every toy text id at 8192 envs, 50 steps each,
     numpy-seeded uniform actions: env-steps/s through ``step`` (and the
     ``xla()`` loop for Pong and MiniGrid), one traced ``xla()`` step
     (device time, launches, idle share), peak memory; then every toy text
     and MiniGrid id and Pong at 256 envs on the card against the CPU port
     until every lane has ended
     an episode (Pong also from scores one point short of 21): every output
     field and the final state bit for bit, Pong's observations to the
     resize rule (at most 1 level off, on under 0.5% of the pixels);
 10. the Box2D family, which reaches no kernel of its own: each of
     LunarLander-v2, LunarLanderContinuous-v2, BipedalWalker-v3 and
     BipedalWalkerHardcore-v3 at 8192 envs (``bench.py:336-337``'s width),
     reset + 100 numpy-seeded uniform actions, half through ``step`` and
     half in the ``xla()`` loop: env-steps/s, every reward finite, the
     observations finite (the walkers' lanes that blew up are counted), the
     lidar in [0, 1], episodes ended and each auto-reset FIRST with elapsed
     0 and reward 0, one traced ``xla()`` step, peak memory; then each id at
     256 envs on the card against the CPU port over a horizon (100 steps,
     the walkers 10), the lanes that part counted against a bound, the
     others to 1e-3 relative with integer, bool, contact and lidar fields
     equal;
 11. the on-device MuJoCo family, which reaches no kernel of its own (the
     engine is eager PyTorch over the committed model data; no mujoco
     import): ReacherJax-v4, InvertedPendulumJax-v4,
     InvertedDoublePendulumJax-v4 and SwimmerJax-v4 at 8192 envs
     (``bench.py:347-348``'s width), the reset (timed alone) + 60
     numpy-seeded uniform actions, half through ``step`` and half in the
     ``xla()`` loop (phases 12 to 14 drive their ids the same way):
     env-steps/s, every output finite, Reacher's lanes all truncated at 50
     and restarted, each auto-reset FIRST with elapsed 0 and reward 0, one
     traced ``xla()`` step, peak memory; then per model ``step_smooth``
     of one env-step from 256 seeded float64 states on the card against
     the CPU to 1e-10 relative, with the process asking for TF32; and each
     id at 256 envs over 15 steps on the card against the CPU port, the
     lanes that part counted against a bound, the others to 1e-3 relative
     with integer and bool fields equal;
 12. the contact device MuJoCo ids (plane-capsule and capsule-capsule
     contacts, the free joint; no kernel of their own): HalfCheetahJax-v4
     at 4096 envs over 20 steps, HopperJax-v4 and Walker2dJax-v4 at 4096
     over 10, AntJax-v4 at 2048 over 4, HumanoidJax-v4 and
     HumanoidStandupJax-v4 at 1024 over 2 (``bench.py:353-367``'s widths;
     cut in depth to make room for phases 15 and 17), half
     through ``step``
     and half in the ``xla()`` loop: env-steps/s, every output finite, the
     lanes that ended and their auto-resets, one traced ``xla()`` step
     (Ant and the Humanoids: one traced forward evaluation, times the
     evaluations per step; not a whole step), peak memory, with nothing
     else running on the host. Then three child processes on the CPU
     (``--cpu-reference``, 2 cores each: the contact ids but the Humanoids
     with phase 13's; the Humanoids; phase 14's) compute the port's CPU
     side of phases 12 to 14 while the card computes its own: per model ``step_smooth`` of one env-step (the
     warm-start chain) from seeded float64 states that mix grounded,
     penetrating and airborne ones (256 lanes, the Humanoids 64), held on
     the card to 1e-10 relative with the process asking for TF32; and each
     id's pool at 256 envs over 6 steps (the Humanoids 3; cut in depth to
     make room for phases 16 and 17), held on the card by the parted-lanes
     rule;
 13. the dm_control device tier (box and tendon rows in the contact
     engine; no kernel of its own): CheetahJaxRun-v1 at 4096 envs over 20
     steps and HumanoidJaxRun-v1 at 1024 over 4 (``bench.py:362-367``'s
     widths), the reset timed alone (cheetah's settles 200 substeps), half
     through ``step`` and half in the ``xla()`` loop: env-steps/s, every
     output finite, discount 1, one traced ``xla()`` step (Humanoid: one
     traced forward evaluation times 5), peak memory. Their CPU side runs
     in phase 12's first child process, after every timed cell: per box
     or tendon model (cartpole three_poles, ball_in_cup, humanoid)
     ``step_smooth`` of one env-step from seeded float64 states (256 lanes,
     humanoid 64) held on the card to 1e-10 relative with TF32 requested;
     one id of each of the 13 domains at 64 envs over 6 steps (swimmer15
     and humanoid 3), held on the card by the parted-lanes rule;
 14. the rest of the device tier (cylinder contacts, the per-env body-pose
     override, the widest model; no kernel of their own): PusherJax-v4 at
     4096 envs over 10 steps, ManipulatorJaxInsertPeg-v1 at 4096 over 2
     and HumanoidCMUJaxRun-v1 at 1024 over 2 (``bench.py:353-367``'s
     widths; cut in depth to make room for phases 15 and 17), as phase 13
     drives its cells (Pusher one traced ``xla()`` step; the others one
     traced forward evaluation times 10). Their CPU side runs in phase
     12's third child after every timed cell: per model
     one float64 env-step (Pusher's finger against the object, insert_peg's
     peg in its slot, humanoid_CMU low over the floor) held on the card to
     1e-10 relative with TF32 requested; each of the 7 new ids at 64 envs
     (Pusher 6 steps, manipulator 3, humanoid_CMU 2) held on the card by
     the parted-lanes rule;
 15. sharding (``envpool_torch.parallel``; the sampler is its only kernel):
     on ``make_mesh()`` (one shard on this card) and on a mesh of 4 logical
     shards of cuda:0, CarRacing-v2 at 1024 envs over 25 steps bit for bit
     against ``TorchEnvPool`` with the sampler launched once per shard per
     render, and Sokoban-v0 at 16384 envs over 64 steps in both level
     modes bit for bit against the unsharded pool (env-steps/s, launches
     of a traced ``xla()`` step); PPO at ``examples/ppo_sokoban.py``'s
     width (``SokobanCNN()``, 1024 envs, 32 steps) for 2 iterations
     unsharded and on the 4-shard env mesh, and one iteration on a (2, 2)
     env x model mesh, both meshes' iterations (on one card the unsharded
     one, captured) bit for bit against the unsharded iteration; one more
     on the (2, 2) mesh through the per-row path that a mesh over several
     cards runs (``rollout_rows``/``update_rows``): the rollout's pool
     outputs equal where the actions agree, the differing actions within a
     bound, the metrics within rtol 1e-3 (atol 1e-5); on both meshes,
     ``ShardedEnvPool.rollout`` (Sokoban-v0, 16384 envs, 16 steps) captured
     against the same steps eagerly and, also on a (2, 2) env x model mesh,
     ``ShardedPPOTrainStep`` (1024 envs, one iteration of 8 steps) captured
     against ``eager``, bit for bit, with env-steps/s, the (2, 2) mesh's
     bit for bit against the 4-shard mesh's; a
     file checkpoint of the
     4-shard Sokoban pool replayed bit for
     bit; a ``trace`` that lists CUDA kernels; ``dryrun_multichip(8)``;
 16. the host tier (``HostEnvPool`` and its bridge to the card; no kernel
     of its own), in a child process stopped at HOST_CHILD_TIMEOUT s (a
     host function that never runs hangs the child, not the script):
     first each call that waits for the stream (``Tensor.item``/``.cpu``,
     ``Event``/``Stream.synchronize``, ``torch.cuda.synchronize``, 4096
     ``CUDAGraph.replay``s of a graph with a host node) behind a pending
     host function, which takes the GIL: each must return; then the port's
     Atari wrapper stack at the JAX package's
     defaults (gray, 84x84, stack 4, frame_skip 4, noop_max 30) over a
     scripted emulator with ``tests/test_atari_stack.py``'s rules (the
     card's machine has no ale_py and no ROM), 256 envs on as many threads
     as the host has cores: reset + 48 steps through ``step``, an async
     pool (batch 64) for 48 recv/send rounds, eager ``xla()`` loops on
     cuda:0 of 48 steps with the actions on the card (the sends under
     ``set_sync_debug_mode("error")``) and of 12 with the actions on the
     host, and ``graph.CapturedScan`` over the first 12 steps (the host
     step a host node; its one synchronizing call the wait after the
     replays, under ``set_sync_debug_mode("warn")``): env-steps/s, the ms a send takes to return and
     the host step's, the stream time per step past it, bytes and
     CUDA-event time of the copy to the card per step; every output of
     the three loops, kept on the card, bit for bit against the ``step``
     loop's outputs at the same seed and actions; a captured scan whose
     host step fails raises after its replays, the steps queued behind it
     leave the pool alone, and it replays again once raised; a host-API
     ``step`` right after a pending eager send waits for it; one PPO iteration over
     the scripted stack (32 envs, ``AtariCNN``, 4 steps) captured against
     eager on a twin pool, bit for bit; every lane lost a life and ended a
     game, with the common fields' override rules after
     each; the registry lists every id, and making ``Hopper-v4`` and
     ``CheetahRun-v1`` without mujoco raises an ImportError that names it
     (with mujoco, 8 envs x 20 ``xla()`` steps of each on the card);
 17. the last host families over scripted wheels (the card's machine has
     neither procgen nor vizdoom), in a child process that puts them in
     place before it imports the port, so the registry lists their ids:
     procgen's ``BigfishHard-v0`` with ``tests/test_procgen_stack.py``'s
     rules at 256 envs, reset + 100 steps through ``step``, an async pool
     (batch 64) for 100 rounds and ``xla()`` on cuda:0 for 100 steps with
     the actions on the card; ``VizdoomCustom-v1`` with
     ``tests/test_vizdoom_stack.py``'s rules at the JAX package's defaults
     (84x84, stack 4, frame_skip 4) at 256 envs, the same loops 32 steps
     deep (every episode ends twice), with float64 buttons drawn on the
     card and with ``use_combined_action=True`` and int32 ids: env-steps/s,
     bytes and CUDA-event time of the copy per step, every ``xla()`` output
     bit for bit against the ``step`` loop's (procgen's first 25 also
     through ``graph.CapturedScan``), the action in the spec's dtype and shape
     where it reaches the workers, the common fields' rules; then the
     port's examples in child processes on the card, all at once
     (``python -m envpool_torch.examples.ppo_sokoban --iterations 2``,
     ``ppo_mujoco --iterations 2``, ``xla_step``, ``cleanrl_ppo
     --iterations 1 --num-steps 32``, ``sb3_example``, ``tianshou_example`` and
     ``acme_example``, the last three driving their adapters alone): exit
     0, every number they print finite, their seconds; ``acme_example``
     needs ``dm_env`` and is not run, with the reason printed, where the
     machine lacks it. ``async_loop`` steps ``Ant-v4``, which needs mujoco,
     so only the CPU tests run it;
 18. captured rollouts (``envpool_torch.core.graph``): in a child process
     (its traces in a fresh profiler), both forms of the set-handle kernel
     of ``csrc/graph_cond.cu`` against their plain versions through IF
     and WHILE nodes: the `any` form against
     ``pred.any()`` on 24 predicates (none, all, the last and 1% of 1 and
     of 16384 lanes; none, the first and the last of 15, 16, 17 and 16383;
     ``pred[1:]`` of 16385, a view off 16-byte alignment), the counted form
     against ``set_counted_plain`` in ``fori_loop``s of 1, 2, 3 and 198
     rounds at the top of a step (behind memory the step wrote and freed),
     in a WHILE body and in taken and skipped IF bodies, two replays of two
     calls; 33 captures, one on each of PyTorch's pooled streams in turn,
     with a nested body; then, in four turns at 1 and 16384 lanes, a replay of
     1024 skipped IF nodes each: (a) the kernel and its node (and the
     kernel alone, from a CUDA-only trace), (b) PyTorch's own IF node over
     ``pred.any()`` where the card's PyTorch has one (else library_ms is
     null, with the reason printed), (c) an empty kernel and the node (the
     floor of any one-launch design), and ``graph.cond``'s node (the
     operands' clone in front: the kernels line's ``ms``; (a) is its
     ``node_ms``); and (d) an empty-bodied ``fori_loop`` of
     198 rounds with its counter carried through ``while_loop`` and in the
     counted form, per round, each replay traced for its launches; then for each
     id of ``CAPTURED`` the same seed and actions through the eager
     ``xla()`` loop and through ``graph.CapturedScan``, every output field
     and the final pool state bit for bit, the capture and its replays
     under ``torch.cuda.set_sync_debug_mode("error")``: eager and captured
     env-steps/s, capture and instantiate seconds, graph nodes, peak
     memory, launches per captured step and the device's idle share (the
     second step's replay alone, by CUDA events and by a CUDA-only trace;
     null where the trace came back empty), the set kernels of both forms
     that replay launches and the bytes that ``cond``'s operand clones copy
     in it, both counted from the structure recorded during the capture
     (the nodes and the loops they sit in, whether the reset branch ran);
     the threefry, step and advance kernels' launches recorded into the
     graphs; Sokoban-v0's step graph must hold no conditional node, and
     the same cell runs again over the pool's general path (the fused
     advance off: graph.cond over the step kernel) beside it;
     the masked entry points with a device env_id; CheetahJaxRun-v1
     and PusherJax-v4 with lanes that reset through the IF node (Pusher's
     reset through its WHILE node); then the PPO rollout on Sokoban-v0 at
     ``examples/ppo_sokoban.py``'s width captured against its eager steps;
 19. one JSON line of kernel results, then ``{"ok": true, "device": ...}``.

Without a CUDA device, or outside a checkout, it fails and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

N_ENVS = 1024
MAIN_STEPS = 300
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, device memory
INT_OPS_PER_S = 67e12          # H100 SXM, CUDA cores (fp32 rate)
SAMPLER_OPS_PER_PIXEL = 10     # 4 subtract + conditional-add pairs, 1 index multiply-add


def log(*args) -> None:
  """Print a line; in the main process also append it to the timeline file
  (``build/chip_smoke/timeline.log``), stamped with the seconds since the
  script started, so that each phase's share of the run can be read."""
  print(*args, flush=True)
  timeline = getattr(log, "timeline", None)
  if timeline is not None:
    text = " ".join(str(a) for a in args)
    timeline.write(f"[{time.perf_counter() - log.t0:8.1f} s] {text}\n")
    timeline.flush()


def card_line() -> str:
  res = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, timeout=60, check=True,
  )
  return res.stdout.strip().splitlines()[0]


def sync(torch, device) -> None:
  if torch.device(device).type == "cuda":
    torch.cuda.synchronize()


def queue_ahead(torch, ms: float) -> None:
  """Keep the card busy for about ``ms`` so that the launches enqueued after
  this run back to back: the host's Python and ctypes overhead per call can
  exceed a small kernel's time, and CUDA events would time the host."""
  if not hasattr(queue_ahead, "cycles_per_ms"):
    torch.cuda._sleep(1000)   # loads the kernel before it is timed
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    queue_ahead.cycles_per_ms = 10_000_000 / start.elapsed_time(end)
  torch.cuda._sleep(int(ms * queue_ahead.cycles_per_ms))


def host_ms(torch, fn) -> float:
  """Milliseconds of one call of ``fn`` on the host clock, synchronised: at
  least its host overhead."""
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  fn()
  torch.cuda.synchronize()
  return 1e3 * (time.perf_counter() - t0)


def time_cuda(torch, fn, reps: int, warmup: int = 3, queue: bool = True) -> float:
  """Mean milliseconds of ``fn`` on the card over ``reps`` runs back to back,
  by CUDA events. With ``queue``, the runs wait behind ``queue_ahead`` and
  the timing fails if the host fell behind the card; without, ``fn`` must
  take longer on the card than on the host (the plain versions do)."""
  for _ in range(warmup):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  if queue:
    queue_ahead(torch, 2 * reps * host_ms(torch, fn) + 1)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  if queue and start.query():
    raise AssertionError("timing: the card caught up with the host")
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def random_actions(rng, n: int) -> np.ndarray:
  return np.stack([
    rng.uniform(-1, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n)
  ], 1).astype(np.float32)


# --------------------------------------------------------------- phase 3


def sampler_inputs(torch, rng, bank, s_dim: int, n: int, device):
  rows_b, cols_b = bank.shape
  scal = np.stack([
    rng.integers(0, (rows_b - s_dim) // 8 + 1, n),
    rng.integers(0, (cols_b - s_dim) // 128 + 1, n),
  ], 1)
  shifts = [rng.integers(-s_dim, s_dim + 1, (n, s_dim)) for _ in range(4)]
  rows = rng.integers(-32, s_dim + 32, (n, 96))
  cols = rng.integers(-32, s_dim + 32, (n, 96))
  return (bank, *[
    torch.from_numpy(x.astype(np.int32)).to(device)
    for x in (scal, *shifts, rows, cols)
  ])


def background_cases(torch, envpool_torch, device) -> dict:
  """The background kernel's inputs at N=1024: the main path's own, right
  after a reset (all coarse), after 60 steps (all fine) and half of each,
  and random inputs with a random per-env path."""
  from envpool_torch.envs.box2d import car_racing

  env = envpool_torch.make_gymnasium(
    "CarRacing-v2", num_envs=N_ENVS, seed=SEED, device=device
  )
  env.reset()

  def state():
    return envpool_torch.state_from_numpy(env.save_state(), device).env

  after_reset = state()
  rng = np.random.default_rng(SEED + 6)
  for _ in range(60):
    env.step(random_actions(rng, N_ENVS))
  after_60 = state()
  half = N_ENVS // 2
  mix = {k: torch.cat([after_reset[k][:half], after_60[k][half:]]) for k in after_60}
  cases = {}
  for name, st, share in (
    ("real_fine", after_60, 1.0), ("real_mix", mix, 0.5),
    ("real_coarse", after_reset, 0.0),
  ):
    cases[name] = car_racing.background_inputs(SEED, 8, st)
    got = float(cases[name][2].float().mean())
    if got != share:
      raise AssertionError(f"{name}: fine share {got}, expected {share}")
  banks = car_racing._device_bank(SEED, 8, device)
  cases["random"] = (
    sampler_inputs(torch, rng, banks["fine"], car_racing.FINE_WIN, N_ENVS, device),
    sampler_inputs(torch, rng, banks["coarse"], car_racing.COARSE_WIN, N_ENVS, device),
    torch.from_numpy(rng.random(N_ENVS) < 0.5).to(device),
  )
  return cases


def time_cold(torch, fn, reps: int = 20) -> float:
  """Mean milliseconds of ``fn`` on the card by CUDA events around each
  run, with the L2 flushed before each (64 MB written), all queued ahead."""
  flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
  fn()
  ahead = 2 * reps * (host_ms(torch, fn) + host_ms(torch, flush.zero_)) + 1
  pairs = []
  queue_ahead(torch, ahead)
  for i in range(reps):
    flush.fill_(i & 0xFF)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    pairs.append((start, end))
  if pairs[0][0].query():
    raise AssertionError("timing: the card caught up with the host")
  torch.cuda.synchronize()
  return sum(s.elapsed_time(e) for s, e in pairs) / reps


def background_bound(torch, fine, coarse, use_fine, palette):
  """(byte ms, op ms, bytes) the fused kernel cannot go below: per env, the
  chosen path's distinct inputs read once, at most one bank byte per
  in-window pixel, the RGB image written once."""
  n_bytes = use_fine.numel() + palette.numel()
  pixels = 0
  for path, chosen in ((fine, use_fine), (coarse, ~use_fine)):
    bank, scal, *per_env = path
    s_dim = per_env[0].shape[1]
    k = int(chosen.sum())
    distinct = {t.data_ptr(): t for t in (scal, *per_env)}.values()
    n_bytes += sum(k * t[0].numel() * t.element_size() for t in distinct)
    rows, cols = per_env[4], per_env[5]
    r0, c0 = 8 * scal[:, 0].long(), 128 * scal[:, 1].long()
    window_ok = (
      (r0 >= 0) & (r0 + s_dim <= bank.shape[0]) & (c0 >= 0)
      & (c0 + s_dim <= bank.shape[1])
    )
    in_r = ((rows >= 0) & (rows < s_dim)).sum(1)
    in_c = ((cols >= 0) & (cols < s_dim)).sum(1)
    pixels += int((in_r * in_c * (window_ok & chosen)).sum())
  n_bytes += pixels + use_fine.numel() * 96 * 96 * 3
  return (1e3 * n_bytes / HBM_BYTES_PER_S,
          1e3 * SAMPLER_OPS_PER_PIXEL * pixels / INT_OPS_PER_S, n_bytes)


def check_background(torch, envpool_torch, device, card: str) -> dict:
  """The fused background kernel against its plain version on every case
  of ``background_cases``, bit-exact; warm and cold times, plain times and
  the bound."""
  from envpool_torch.envs.box2d import car_racing, sampler

  palette = car_racing._constants(torch.device(device))["palette1"]
  res = {"max_abs_err": 0, "cases": {}}
  for name, (fine, coarse, use_fine) in background_cases(
    torch, envpool_torch, device
  ).items():
    args = (fine, coarse, use_fine, palette)
    got = sampler.fused_background(*args)
    want = sampler.background_plain(*args)
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    if not torch.equal(got, want):
      raise AssertionError(f"background {name}: kernel != plain, max err {err}")
    ms = time_cuda(torch, lambda: sampler.fused_background(*args), 50)
    ms_cold = time_cold(torch, lambda: sampler.fused_background(*args))
    plain_ms = time_cuda(
      torch, lambda: sampler.background_plain(*args), 10, queue=False
    )
    byte_ms, op_ms, n_bytes = background_bound(torch, *args)
    bound_ms = max(byte_ms, op_ms)
    log(f"background {name}: N={N_ENVS}, fine share "
        f"{float(use_fine.float().mean()):.3f}, bit-exact, kernel {ms:.4f} ms "
        f"warm, {ms_cold:.4f} ms cold, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us ({n_bytes} B, "
        f"{'bytes' if byte_ms >= op_ms else 'operations'}), "
        f"{100 * bound_ms / ms:.1f}% of bound warm, library none [{card}]")
    res["max_abs_err"] = max(res["max_abs_err"], err)
    res["cases"][name] = {
      "ms": ms, "ms_cold": ms_cold, "plain_ms": plain_ms, "bound_ms": bound_ms,
      "bound_by": "bytes" if byte_ms >= op_ms else "operations",
    }
    if name == "real_fine":
      res["shard"] = background_shard(torch, args, card)
  return res


def background_shard(torch, args, card) -> dict:
  """The main path's all-fine render at one shard's width (N / SHARDS
  envs, phase 15's 4-shard pool): bit-exact, warm time against its bound."""
  from envpool_torch.envs.box2d import sampler

  k = N_ENVS // SHARDS
  fine, coarse, use_fine, palette = args
  cut = [(p[0], *(t[:k] for t in p[1:])) for p in (fine, coarse)]
  shard_args = (*cut, use_fine[:k], palette)
  got = sampler.fused_background(*shard_args)
  if not torch.equal(got, sampler.background_plain(*shard_args)):
    raise AssertionError("background at one shard's width: kernel != plain")
  ms = time_cuda(torch, lambda: sampler.fused_background(*shard_args), 50)
  byte_ms, op_ms, n_bytes = background_bound(torch, *shard_args)
  bound_ms = max(byte_ms, op_ms)
  log(f"background real_fine at one shard's width: N={k}, bit-exact, kernel "
      f"{ms:.4f} ms warm, bound {bound_ms * 1e3:.2f} us ({n_bytes} B), "
      f"{100 * bound_ms / ms:.1f}% of bound [{card}]")
  return {"n": k, "ms": ms, "bound_ms": bound_ms}


def bit_diff(torch, got, want) -> int:
  """0 where the two trees are equal bit for bit (floats by their bits),
  else the largest absolute difference of their integer or bit views."""
  from envpool_torch.core.pool import tree_map

  gl, wl = [], []
  tree_map(gl.append, got)
  tree_map(wl.append, want)
  if len(gl) != len(wl):
    raise AssertionError(f"trees of {len(gl)} and {len(wl)} leaves")
  err = 0
  for g, w in zip(gl, wl):
    if g.dtype != w.dtype or g.shape != w.shape:
      raise AssertionError(f"{g.dtype} {tuple(g.shape)} against {w.dtype} {tuple(w.shape)}")
    if g.is_floating_point():
      bits = torch.int64 if g.element_size() == 8 else torch.int32
      g, w = g.view(bits), w.view(bits)
    if g.numel() and not torch.equal(g, w.to(g.device)):
      err = max(err, int((g.long() - w.to(g.device).long()).abs().max()))
  return err


def threefry_cases(torch, device) -> dict:
  """The threefry kernel's inputs (keys, n_ctr, pair, data): the main
  path's shapes at SOKOBAN_ENVS keys (the pool's split of its carry, a view
  ``both[:, 0]``; a contiguous split; the single-word draw of a view
  ``both[:, 1]``; the pool's fold_in of env ids under one broadcast key),
  PPO's permutation draw (1 key x 131,072 counters), and empty outputs."""
  from envpool_torch.core import prng

  g = np.random.default_rng(SEED + 30)

  def keys(*shape):
    return torch.from_numpy(
      g.integers(0, 2**32, shape + (2,), dtype=np.uint64).astype(np.int64)
    ).to(device)

  n = SOKOBAN_ENVS
  both = keys(n, 2)
  ids = torch.arange(n, dtype=torch.int32, device=device)
  return {
    "split": (both[:, 0], 2, True, None),
    "split_contiguous": (keys(n), 2, True, None),
    "bits": (both[:, 1], 1, False, None),
    "fold_in": (prng.prng_key(SEED, device).expand(n, 2), 1, True, ids),
    "bits_wide": (keys(), 131072, False, None),
    "empty_keys": (keys(0), 2, True, None),
    "empty_counters": (keys(n), 0, False, None),
  }


def threefry_bound(keys, n_ctr: int, pair: bool, data):
  """(byte ms, op ms, bytes): each distinct key read once (a broadcast key
  once), the data read, the output written once; THREEFRY_OPS 32-bit
  operations per hash."""
  n_keys = keys.numel() // 2
  distinct = 1 if n_keys and keys.stride(0) == 0 else n_keys
  n_bytes = (16 * distinct + (0 if data is None else data.numel() * data.element_size())
             + n_keys * n_ctr * (16 if pair else 8))
  ops = n_keys * n_ctr * THREEFRY_OPS
  return 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * ops / INT_OPS_PER_S, n_bytes


def empty_grid(torch, total: int):
  """A launcher of ``csrc/threefry.cu``'s empty kernel on the grid that
  ``threefry_launch`` gives ``total`` outputs: the launch floor beside the
  kernel's time."""
  import ctypes
  from envpool_torch import _build

  fn = _build.load("threefry").threefry_empty_launch
  fn.argtypes, fn.restype = [ctypes.c_longlong, ctypes.c_void_p], ctypes.c_int

  def launch():
    err = fn(total, torch.cuda.current_stream().cuda_stream)
    if err:
      raise RuntimeError(f"threefry_empty_launch failed: CUDA error {err}")
  return launch


def check_threefry(torch, device, card: str) -> dict:
  """The threefry kernel against ``threefry_plain`` on every case of
  ``threefry_cases``, bit for bit; warm and cold times, plain times, bound,
  and an empty kernel of the same grid timed the same way."""
  from envpool_torch.core import prng

  res = {"max_abs_err": 0, "cases": {}}
  for name, (keys, n_ctr, pair, data) in threefry_cases(torch, device).items():
    def kernel():
      return prng.threefry_kernel(keys, n_ctr, pair, data)

    def plain():
      return prng.threefry_plain(keys, n_ctr, pair, data)

    err = bit_diff(torch, kernel(), plain())
    torch.cuda.synchronize()
    if err:
      raise AssertionError(f"threefry {name}: kernel != plain, max err {err}")
    byte_ms, op_ms, n_bytes = threefry_bound(keys, n_ctr, pair, data)
    bound_ms = max(byte_ms, op_ms)
    r = {"keys": keys.numel() // 2, "counters": n_ctr, "pair": pair,
         "bound_ms": bound_ms, "bound_by": "bytes" if byte_ms >= op_ms else "operations"}
    if keys.numel() and n_ctr:
      r["ms"] = time_cuda(torch, kernel, 50)
      r["ms_cold"] = time_cold(torch, kernel)
      r["plain_ms"] = time_cuda(torch, plain, 10, queue=False)
      r["empty_ms"] = time_cuda(torch, empty_grid(torch, r["keys"] * n_ctr), 50)
      log(f"threefry {name}: {r['keys']} keys x {n_ctr} counters "
          f"({'pair' if pair else 'xor'}), bit-exact, kernel {r['ms']:.5f} ms warm, "
          f"{r['ms_cold']:.5f} ms cold, an empty kernel of its grid "
          f"{r['empty_ms']:.5f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{bound_ms * 1e3:.3f} us ({n_bytes} B, {r['bound_by']}), "
          f"{100 * bound_ms / r['ms']:.1f}% of bound warm, library none [{card}]")
    else:
      log(f"threefry {name}: empty output {tuple(kernel().shape)}, equal, no launch")
    res["cases"][name] = r
  return res


def sokoban_step_cases(torch, envpool_torch, device) -> dict:
  """The step kernel's inputs at SOKOBAN_ENVS envs in both level modes:
  the pool's state after a reset and 30 steps (mid-episode, some lanes at
  their cap), actions in [-5, 7] (noops and out-of-range actions) and the
  pool's step key, a view ``both[:, 1]``; each mode's step and reset."""
  from envpool_torch.core import prng

  modes = {
    "random": SOKOBAN_KW,
    "sequential": dict(levels_dir=sokoban_levels_dir(envpool_torch),
                       load_sequentially=True, max_episode_steps=60),
  }
  n = SOKOBAN_ENVS
  g = np.random.default_rng(SEED + 31)
  cases = {}
  for mode, kw in modes.items():
    env = envpool_torch.make_gymnasium(
      "Sokoban-v0", num_envs=n, seed=SEED, device=device, **kw
    )
    env.reset()
    for a in sokoban_actions(SEED + 32, 30, n):
      env.step(a)
    st = envpool_torch.state_from_numpy(env.save_state(), device)
    keys = prng.split(st.rng, 2)[:, 1]
    action = torch.from_numpy(g.integers(-5, 8, n).astype(np.int32)).to(device)
    cases[f"{mode}_step"] = (env._cfg, st.env, action, keys)
    cases[f"{mode}_reset"] = (env._cfg, st.env, None, keys)
    del env
  return cases


def sokoban_kernel_bound(cfg, state, action, fresh: int):
  """(byte ms, op ms, bytes) of one step-kernel call: what it must read
  (the state, or the cursor alone in reset mode; the actions; the keys and
  a bank row, its two indices and, in random mode, the file's start and
  length per fresh lane) and write (the state, the obs, elapsed_step and
  reward, done and trunc) once; the fresh lanes' threefry blocks as
  32-bit operations (13 in random mode, the cap's 2 in sequential mode)."""
  n, dd = state["world"].shape[0], state["world"].shape[1] ** 2
  state_bytes = n * (dd + 8 + 6 * 4)
  sequential = bool(cfg.load_sequentially)
  per_fresh = 16 + dd + 8 + (0 if sequential else 12)
  read = (4 * n if action is None else state_bytes + 4 * n) + fresh * per_fresh
  write = state_bytes + 3 * n * dd + 4 * n + (0 if action is None else 6 * n)
  capped = int(cfg.min_episode_steps) < int(cfg.max_episode_steps)
  blocks = (2 if capped else 0) + (0 if sequential else 11)
  ops = fresh * blocks * THREEFRY_OPS
  return (1e3 * (read + write) / HBM_BYTES_PER_S, 1e3 * ops / INT_OPS_PER_S,
          read + write)


def check_sokoban_step(torch, envpool_torch, device, card: str) -> dict:
  """The step kernel (``SokobanEnv.step``/``reset`` on the card) against
  ``step_plain``/``reset_plain`` on the card and on CPU copies of the same
  inputs, every output bit for bit; warm and cold times, plain times, the
  bound."""
  from envpool_torch.core.pool import tree_map
  from envpool_torch.envs.sokoban.sokoban import SokobanEnv

  res = {"max_abs_err": 0, "cases": {}}
  for name, (cfg, state, action, keys) in sokoban_step_cases(
    torch, envpool_torch, device
  ).items():
    if action is None:
      def kernel():
        return SokobanEnv.reset(cfg, state, keys)

      def plain():
        return SokobanEnv.reset_plain(cfg, state, keys)
    else:
      def kernel():
        return SokobanEnv.step(cfg, state, action, keys)

      def plain():
        return SokobanEnv.step_plain(cfg, state, action, keys)
    got, want = kernel(), plain()
    cpu = lambda t: t.cpu()
    on_cpu = (SokobanEnv.reset_plain(cfg, tree_map(cpu, state), keys.cpu())
              if action is None else
              SokobanEnv.step_plain(cfg, tree_map(cpu, state), action.cpu(), keys.cpu()))
    err = max(bit_diff(torch, got, want), bit_diff(torch, got, on_cpu))
    if err:
      raise AssertionError(f"sokoban_step {name}: kernel != plain, max err {err}")
    fresh = state["world"].shape[0] if action is None else int(want[3].sum())
    r = {"fresh_lanes": fresh}
    if action is not None:
      r["noops"] = int((action < 0).sum())
      r["out_of_range"] = int((action > 3).sum())
      if not (fresh and r["noops"] and r["out_of_range"]):
        raise AssertionError(f"sokoban_step {name}: a case without done lanes, noops "
                             f"or out-of-range actions: {r}")
    byte_ms, op_ms, n_bytes = sokoban_kernel_bound(cfg, state, action, fresh)
    r["bound_ms"] = max(byte_ms, op_ms)
    r["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    r["ms"] = time_cuda(torch, kernel, 50)
    r["ms_cold"] = time_cold(torch, kernel)
    r["plain_ms"] = time_cuda(torch, plain, 10, queue=False)
    log(f"sokoban_step {name}: {SOKOBAN_ENVS} envs, {fresh} fresh lanes, bit-exact "
        f"against plain on the card and on the CPU, kernel {r['ms']:.5f} ms warm, "
        f"{r['ms_cold']:.5f} ms cold, plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms'] * 1e3:.3f} us ({n_bytes} B, {r['bound_by']}), "
        f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound warm, library none [{card}]")
    res["cases"][name] = r
  return res


# the share of lanes whose carried done flag phase 3's advance cases set
ADVANCE_DONE_SHARE = 0.02
# threefry blocks per fresh lane of one advance: random mode's level draws
# (the level's split, the two randint's splits and their 4 words: 11) and
# the cap's 2; sequential mode the cap's
FRESH_BLOCKS = {"random": 13, "sequential": 2}


def sokoban_advance_cases(torch, envpool_torch, device) -> dict:
  """The advance kernel's inputs at SOKOBAN_ENVS envs in both level modes:
  the pool's state after a reset and 30 steps with the carried done flag
  set on ADVANCE_DONE_SHARE of the lanes (one advance then resets some lanes
  and steps the others, some of which finish), actions in [-5, 7]: a full
  send, a masked send to a random quarter of the lanes (some lanes outside
  it carry the flag), a forced reset of every lane and a forced reset of
  the quarter. name -> (mode, card pool, CPU pool, state, action or None,
  env_id or None, forced)."""
  modes = {
    "random": SOKOBAN_KW,
    "sequential": dict(levels_dir=sokoban_levels_dir(envpool_torch),
                       load_sequentially=True, max_episode_steps=60),
  }
  n = SOKOBAN_ENVS
  g = np.random.default_rng(SEED + 33)
  cases = {}
  for mode, kw in modes.items():
    env = envpool_torch.make_gymnasium(
      "Sokoban-v0", num_envs=n, seed=SEED, device=device, **kw
    )
    cpu = envpool_torch.make_gymnasium("Sokoban-v0", num_envs=n, seed=SEED,
                                       device="cpu", **kw)
    env.reset()
    for a in sokoban_actions(SEED + 32, 30, n):
      env.step(a)
    flags = torch.from_numpy(g.random(n) < ADVANCE_DONE_SHARE).to(device)
    ps = env._state._replace(done=flags)
    action = torch.from_numpy(g.integers(-5, 8, n).astype(np.int32)).to(device)
    ids = torch.from_numpy(np.sort(g.choice(n, n // 4, replace=False))).to(device)
    outside = torch.ones(n, dtype=torch.bool, device=device).index_fill_(0, ids, False)
    if not bool((flags & outside).any()):
      raise AssertionError(f"sokoban_advance {mode}: no lane outside the mask carries done")
    cases[f"{mode}_full"] = (mode, env, cpu, ps, action, None, False)
    cases[f"{mode}_masked"] = (mode, env, cpu, ps, action[ids], ids, False)
    cases[f"{mode}_forced"] = (mode, env, cpu, ps, None, None, True)
    cases[f"{mode}_forced_masked"] = (mode, env, cpu, ps, None, ids, True)
  return cases


def sokoban_advance_bound(ps, n_mask: int, reset: int, fresh: int, masked: bool,
                          forced: bool, mode: str):
  """(byte ms, op ms, bytes) of one pool advance of a Sokoban pool, counting
  what this advance needs, each byte once. Every lane reads its key and
  cursor and writes its new state (world, player, six int32 fields), key,
  elapsed and done flag. A lane outside the mask reads the rest of its
  state, its elapsed and its done flag; a stepping lane the rest of its
  state, its action and its done flag; a reset lane its done flag unless
  the reset is forced; a fresh lane its bank row, the row's two indices
  and, in random mode, the file's start and length. A lane in the mask
  writes its obs, reward, done, trunc, step_type and discount
  (``elapsed_step`` is the pool's elapsed; the ``info:`` outputs are state
  fields and the pool's env ids, written by no one). The mask is read once.
  The split's 2 threefry blocks per lane in the mask and FRESH_BLOCKS per
  fresh lane as 32-bit operations."""
  n, dd = ps.env["world"].shape[0], ps.env["world"].shape[1] ** 2
  rest = dd + 8 + 5 * 4  # world, player, the int32 fields but the cursor
  kept, stepping = n - n_mask, n_mask - reset
  read = (n * (16 + 4) + kept * (rest + 4 + 1) + stepping * (rest + 4 + 1)
          + (0 if forced else reset) + fresh * (dd + 8 + (12 if mode == "random" else 0))
          + (n if masked else 0))
  write = n * (dd + 8 + 6 * 4 + 16 + 4 + 1) + n_mask * (3 * dd + 4 + 1 + 1 + 4 + 4)
  ops = (2 * n_mask + FRESH_BLOCKS[mode] * fresh) * THREEFRY_OPS
  return (1e3 * (read + write) / HBM_BYTES_PER_S, 1e3 * ops / INT_OPS_PER_S,
          read + write)


def host_us(torch, fn, reps: int = 50) -> float:
  """Host microseconds per call of ``fn`` with the card kept busy ahead of
  it, so that no call waits for the card: the wrapper's own cost."""
  fn()
  queue_ahead(torch, 2 * reps * host_ms(torch, fn) + 1)
  t0 = time.perf_counter()
  for _ in range(reps):
    fn()
  us = 1e6 * (time.perf_counter() - t0) / reps
  torch.cuda.synchronize()
  return us


def check_sokoban_advance(torch, envpool_torch, device, card: str) -> dict:
  """The advance kernel (``TorchEnvPool._advance_ids`` of a Sokoban pool on
  the card) against the plain advance (the pool's general path over
  ``step_plain``/``reset_plain``, ``plain=True``) on the card and on CPU
  copies in a CPU pool, new pool state and every output bit for bit; warm
  and cold times beside the pool step's bound, the plain advance's time,
  and the wrappers' host microseconds per call."""
  from envpool_torch.core.pool import tree_map
  from envpool_torch.envs.sokoban.sokoban import SokobanEnv

  res = {"max_abs_err": 0, "cases": {}}
  cpu = lambda t: t.cpu()
  for name, (mode, env, cpu_env, ps, action, ids, forced) in sokoban_advance_cases(
    torch, envpool_torch, device
  ).items():
    ab = None if action is None else {"action": action}

    def kernel():
      new, outs = env._advance_ids(ps, ab, ids, forced)
      return new, tuple(outs)

    def plain():
      new, outs = env._advance_ids(ps, ab, ids, forced, plain=True)
      return new, tuple(outs)

    n0 = SokobanEnv.advance_launches
    got, want = kernel(), plain()
    if SokobanEnv.advance_launches != n0 + 1:
      raise AssertionError(f"sokoban_advance {name}: {SokobanEnv.advance_launches - n0} "
                           f"advance launches in one advance")
    new_c, outs_c = cpu_env._advance_ids(
      tree_map(cpu, ps), None if ab is None else tree_map(cpu, ab),
      None if ids is None else ids.cpu(), forced)
    err = max(bit_diff(torch, got, want), bit_diff(torch, got, (new_c, tuple(outs_c))))
    if err:
      raise AssertionError(f"sokoban_advance {name}: kernel != plain, max err {err}")
    keys = env._state_keys
    outs = got[1]
    in_mask = SOKOBAN_ENVS if ids is None else ids.numel()
    rows = ps.done if ids is None else ps.done[ids]
    if forced:
      fresh = in_mask
    else:
      fresh = int(rows.sum()) + int(outs[keys.index("done")].sum())
    r = {"mode": mode, "in_mask": in_mask, "fresh_lanes": fresh, "forced": forced,
         "reset_lanes": in_mask if forced else int(rows.sum())}
    if name.endswith("_full") and not (0 < r["reset_lanes"] < fresh < in_mask):
      raise AssertionError(f"sokoban_advance {name}: no mix of reset, finishing and "
                           f"stepping lanes: {r}")
    byte_ms, op_ms, n_bytes = sokoban_advance_bound(
      ps, in_mask, r["reset_lanes"], fresh, ids is not None, forced, mode)
    r["bound_ms"] = max(byte_ms, op_ms)
    r["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    r["ms"] = time_cuda(torch, kernel, 50)
    r["ms_cold"] = time_cold(torch, kernel)
    r["plain_ms"] = time_cuda(torch, plain, 5, queue=False)
    log(f"sokoban_advance {name}: {SOKOBAN_ENVS} envs, {in_mask} in the mask, "
        f"{r['reset_lanes']} reset and {fresh} fresh lanes, one launch, bit-exact "
        f"against the plain advance on the card and on the CPU, kernel "
        f"{r['ms']:.5f} ms warm, {r['ms_cold']:.5f} ms cold, plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.3f} us ({n_bytes} B, "
        f"{r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of bound warm, "
        f"library none [{card}]")
    if name == "random_full":
      cfg, a = env._cfg, action
      sub = env._state.rng  # any [n, 2] keys: the step mode's host cost
      r["host_us"] = {
        "fused_advance": host_us(torch, lambda: SokobanEnv.fused_advance(
          cfg, ps, a, None, False)),
        "pool_advance": host_us(torch, lambda: env._advance_ids(ps, ab, None, False)),
        "step_mode": host_us(torch, lambda: SokobanEnv.step(cfg, ps.env, a, sub)),
      }
      log(f"sokoban_advance host microseconds per call (the card kept busy "
          f"ahead): SokobanEnv.fused_advance {r['host_us']['fused_advance']:.1f}, "
          f"the pool's advance around it {r['host_us']['pool_advance']:.1f}, "
          f"SokobanEnv.step (step mode) {r['host_us']['step_mode']:.1f} [{card}]")
    res["cases"][name] = r
  return res


# --------------------------------------------------------------- phase 4


def renders_for(done_before: np.ndarray) -> int:
  """Background launches of one advance: one for the step, which always
  runs (as the JAX package's does; a forced reset runs the reset alone),
  and one for the reset when a lane resets."""
  return 1 + int(done_before.any())


def run_sync(torch, envpool_torch, sampler, device, steps, seed, **kw):
  """reset + ``steps`` steps; checks outputs and the exact launch count.
  Returns (env, last actions, env-steps/s, launches, per-lane resets)."""
  rng = np.random.default_rng(seed)
  sampler.fused_background.launches = 0
  env = envpool_torch.make_gymnasium(
    "CarRacing-v2", num_envs=N_ENVS, seed=SEED, device=device, **kw
  )
  obs, info = env.reset()
  expected = 1
  assert obs.shape == (N_ENVS, 96, 96, 3) and obs.dtype == np.uint8
  done = np.zeros(N_ENVS, bool)
  resets = np.zeros(N_ENVS, int)
  acts = [random_actions(rng, N_ENVS) for _ in range(steps)]
  sync(torch, device)
  t0 = time.perf_counter()
  for a in acts:
    expected += renders_for(done)
    obs, rew, term, trunc, info = env.step(a)
    done = term | trunc
    resets += info["elapsed_step"] == 0
  secs = time.perf_counter() - t0
  assert obs.shape == (N_ENVS, 96, 96, 3) and obs.dtype == np.uint8
  assert np.isfinite(rew).all() and rew.dtype == np.float32
  assert np.all(obs[:, 95, :48] == 0)        # indicator bar background
  launches = sampler.fused_background.launches
  if launches != expected:
    raise AssertionError(f"sampler launches {launches}, expected {expected}")
  return env, acts[-1], steps * N_ENVS / secs, launches, resets


def run_async(envpool_torch, sampler, device, iters=20, batch=256):
  """An async pool: ``iters`` recv/send rounds of ``batch``-env cohorts."""
  rng = np.random.default_rng(SEED + 2)
  sampler.fused_background.launches = 0
  env = envpool_torch.make_gymnasium(
    "CarRacing-v2", num_envs=N_ENVS, batch_size=batch, seed=SEED, device=device
  )
  env.async_reset()
  expected = N_ENVS // batch
  done = np.zeros(N_ENVS, bool)
  seen = []
  for _ in range(iters):
    obs, rew, term, trunc, info = env.recv()
    ids = info["env_id"]
    assert obs.shape == (batch, 96, 96, 3) and np.isfinite(rew).all()
    done[ids] = term | trunc
    seen.append(ids)
    expected += renders_for(done[ids])
    env.send(random_actions(rng, batch), ids)
  order = np.stack(seen[: N_ENVS // batch]).ravel()
  assert np.array_equal(np.sort(order), np.arange(N_ENVS)), "cohorts lost envs"
  if sampler.fused_background.launches != expected:
    raise AssertionError(
      f"async launches {sampler.fused_background.launches}, expected {expected}"
    )
  return sampler.fused_background.launches


def run_functional(torch, env, sampler, steps=100):
  """A ``steps``-step ``xla()`` loop on the device, then ``commit``."""
  rng = np.random.default_rng(SEED + 3)
  acts = torch.from_numpy(
    np.stack([random_actions(rng, N_ENVS) for _ in range(steps)])
  ).to(env.device)
  handle, recv, send, step = env.xla()
  keys = env.spec._state_keys
  done_i, elapsed_i = keys.index("done"), keys.index("elapsed_step")
  before = env.save_state()
  done = before.done
  sampler.fused_background.launches = 0
  expected = 0
  sync(torch, env.device)
  t0 = time.perf_counter()
  for i in range(steps):
    expected += renders_for(done)
    handle = send(handle, acts[i])
    done = handle.out[done_i].cpu().numpy()
  sync(torch, env.device)
  secs = time.perf_counter() - t0
  if sampler.fused_background.launches != expected:
    raise AssertionError(
      f"xla() launches {sampler.fused_background.launches}, expected {expected}"
    )
  env.commit(handle)
  after = env.save_state()
  np.testing.assert_array_equal(after.elapsed, handle.out[elapsed_i].cpu().numpy())
  assert not np.array_equal(after.env["pos"], before.env["pos"])
  return steps * N_ENVS / secs, sampler.fused_background.launches


def profile_call(torch, fn, per: int = 1):
  """Trace one call of ``fn`` with ``torch.profiler``; returns (device
  microseconds per ``per``, [(kernel name, us per ``per``, launches per
  ``per``)], busiest first). Only device-side events count, so nothing is
  counted twice, and only the CUDA activity is recorded: the CPU operator
  events would add nothing to the counts and several times their
  processing time (PPO's 78k-launch rollout took ~37 s to trace with
  them)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  rows = [
    (e.key, e.self_device_time_total / per, e.count / per)
    for e in prof.key_averages()
    if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
  ]
  rows.sort(key=lambda r: -r[1])
  return sum(r[1] for r in rows), rows


def profile_steps(torch, env, acts):
  """Trace ``len(acts) - 1`` ``xla()`` steps after one untraced step, per
  step (see ``profile_call``)."""
  steps = len(acts) - 1
  handle, _, send, _ = env.xla()
  handle = send(handle, acts[0])

  def run():
    nonlocal handle
    for i in range(1, steps + 1):
      handle = send(handle, acts[i])

  return profile_call(torch, run, steps)


def log_profile(name, busy_us, rows, step_us, card, top=12) -> None:
  if busy_us <= 0:
    log(f"profile: {name}: the profiler saw no device time (not measured)")
    return
  log(f"profile: {name}, device kernels {busy_us:.1f} us per step in "
      f"{sum(r[2] for r in rows):.0f} launches; untraced step {step_us:.1f} "
      f"us, so the device idles {100 * (1 - busy_us / step_us):.1f}% [{card}]")
  for kname, us, count in rows[:top]:
    log(f"  {us:9.1f} us/step {count:6.1f} launches/step  {kname[:100]}")


# --------------------------------------------------------------- phase 5


def card_vs_cpu(envpool_torch, env, action) -> dict:
  """The card pool's snapshot through one step on the card and on the CPU."""
  snap = env.save_state()
  cpu = envpool_torch.make_gymnasium(
    "CarRacing-v2", num_envs=N_ENVS, seed=SEED, device="cpu"
  )
  cpu.load_state(snap)
  want = cpu.step(action)
  got = env.step(action)
  for i in (2, 3):
    np.testing.assert_array_equal(got[i], want[i])
  for k in ("env_id", "elapsed_step", "tile_visited_count"):
    np.testing.assert_array_equal(got[-1][k], want[-1][k])
  rew_err = float(np.abs(got[1] - want[1]).max())
  assert rew_err <= 1e-4, rew_err
  obs_eq = float((got[0] == want[0]).all(-1).mean())
  assert obs_eq >= 0.995, obs_eq
  g_st, w_st = env.save_state(), cpu.save_state()
  for k in ("track_id", "visited", "visited_count", "new_lap"):
    np.testing.assert_array_equal(g_st.env[k], w_st.env[k], err_msg=k)
  np.testing.assert_array_equal(g_st.rng, w_st.rng)
  pos_err = float(np.abs(g_st.env["pos"] - w_st.env["pos"]).max())
  return {"obs_equal": obs_eq, "reward_max_err": rew_err, "pos_max_err": pos_err}


# --------------------------------------------------------------- phase 6

SOKOBAN_ENVS = 16384
SOKOBAN_STEPS = 150
# bench.py's Sokoban-v0 cell (bench.py:309-317)
SOKOBAN_KW = dict(max_episode_steps=60, levels_dir="", n_levels_to_load=1024)


# one threefry-2x32 block in native 32-bit ops: 20 rounds of add, rotate
# and xor, and 5 key injections
THREEFRY_OPS = 120
# threefry blocks per env in one random-mode step: the pool's split (2),
# _fresh_episode's split (2), _load_level's split (2), two randint of a
# split and two single-word draws (2 x 4), the cap's bits (1)
SOKOBAN_THREEFRY_BLOCKS = 15


def sokoban_step_bound(handle, done, action, dim=10):
  """(byte ms, op ms, bytes) one fused Sokoban step could not go below:
  the pool state read and written once, the actions read, every output
  written once, one bank row read per terminal lane of this step; the
  threefry blocks as 32-bit operations."""
  from envpool_torch.core.pool import tree_map

  sizes = []
  tree_map(lambda t: sizes.append(t.numel() * t.element_size()), handle.pool)
  outs = sum(o.numel() * o.element_size() for o in handle.out)
  n_bytes = (2 * sum(sizes) + action.numel() * action.element_size() + outs
             + int(done.sum()) * dim * dim)
  ops = action.shape[0] * SOKOBAN_THREEFRY_BLOCKS * THREEFRY_OPS
  return 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * ops / INT_OPS_PER_S, n_bytes


def sokoban_levels_dir(envpool_torch) -> str:
  return os.path.join(
    os.path.dirname(envpool_torch.__file__), "envs", "sokoban", "sample_levels"
  )


def sokoban_actions(seed: int, steps: int, n: int) -> np.ndarray:
  """Uniform actions in [-1, 3]: a quarter of them are noops."""
  return np.random.default_rng(seed).integers(-1, 4, (steps, n)).astype(np.int32)


def sokoban_headline(torch, envpool_torch, device, n=SOKOBAN_ENVS,
                     steps=SOKOBAN_STEPS):
  """Reset + ``steps`` random steps through ``step`` (outputs copied to the
  host), then ``steps`` more through the ``xla()`` interface. Returns (env,
  step-loop env-steps/s, xla() env-steps/s, terminal steps per lane)."""
  env = envpool_torch.make_gymnasium(
    "Sokoban-v0", num_envs=n, seed=SEED, device=device, **SOKOBAN_KW
  )
  obs, info = env.reset()
  assert obs.shape == (n, 3, 10, 10) and obs.dtype == np.uint8
  np.testing.assert_array_equal(info["elapsed_step"], 0)
  acts = sokoban_actions(SEED + 7, steps, n)
  dones = np.zeros(n, np.int64)
  sync(torch, device)
  t0 = time.perf_counter()
  for a in acts:
    obs, rew, term, trunc, info = env.step(a)
    dones += term | trunc
    if not np.array_equal(np.isnan(rew), a < 0):
      raise AssertionError("Sokoban: NaN rewards are not exactly the noops")
  secs = time.perf_counter() - t0
  assert obs.shape == (n, 3, 10, 10) and obs.dtype == np.uint8
  assert np.all(np.abs(rew[a >= 0]) < 15.0)
  if dones.min() < 1:
    raise AssertionError(f"Sokoban: {int((dones == 0).sum())} lanes never reset")

  keys = env.spec._state_keys
  dev_acts = torch.from_numpy(sokoban_actions(SEED + 8, steps, n)).to(device)
  handle, recv, send, step = env.xla()
  sync(torch, device)
  t1 = time.perf_counter()
  for i in range(steps):
    handle = send(handle, dev_acts[i])
  sync(torch, device)
  secs_xla = time.perf_counter() - t1
  rew = handle.out[keys.index("reward")].cpu().numpy()
  np.testing.assert_array_equal(np.isnan(rew), dev_acts[-1].cpu().numpy() < 0)
  bound = sokoban_step_bound(handle, handle.out[keys.index("done")], dev_acts[-1])
  env.commit(handle)
  return env, steps * n / secs, steps * n / secs_xla, dones, bound


def sokoban_sequential(torch, envpool_torch, device, n=1024, steps=200):
  """Sequential mode on the sample levels: lane e's k-th episode plays
  stream position (e + k * n) mod n_levels, visible from the step that
  ends episode k - 1 (reset-into-terminal-obs). Returns (env, episodes,
  env-steps/s of the step loop)."""
  from envpool_torch.envs.sokoban import level_loader

  levels_dir = sokoban_levels_dir(envpool_torch)
  bank = level_loader.load_bank(levels_dir, 10)
  env = envpool_torch.make_gymnasium(
    "Sokoban-v0", num_envs=n, seed=SEED, device=device,
    levels_dir=levels_dir, load_sequentially=True,
  )
  episode = np.zeros(n, np.int64)
  lanes = np.arange(n)

  def check(info, t):
    pos = (lanes + episode * n) % bank.n_levels
    for key, table in (("level_idx", bank.level_idx),
                       ("level_file_idx", bank.file_idx)):
      if not np.array_equal(info[key], table[pos]):
        raise AssertionError(f"sequential mode, step {t}: {key} off the stream")

  _, info = env.reset()
  check(info, 0)
  secs = 0.0
  for t, a in enumerate(sokoban_actions(SEED + 9, steps, n), 1):
    t0 = time.perf_counter()
    _, _, term, trunc, info = env.step(a)
    secs += time.perf_counter() - t0
    episode += term | trunc
    check(info, t)
  assert episode.min() >= 1, "a lane never finished an episode"
  return env, int(episode.sum()), steps * n / secs


def sokoban_card_vs_cpu(envpool_torch, device, n=256, steps=100) -> dict:
  """A pool of each level mode on the card and on the CPU, same seed and
  actions: every output field of reset + ``steps`` steps and the final
  state equal bit for bit (NaN rewards in the same places)."""
  modes = {
    "random": SOKOBAN_KW,
    "sequential": dict(levels_dir=sokoban_levels_dir(envpool_torch),
                       load_sequentially=True),
  }
  acts = sokoban_actions(SEED + 10, steps, n)
  res = {}
  for mode, kw in modes.items():
    runs = []
    for dev in (device, "cpu"):
      env = envpool_torch.make_gymnasium(
        "Sokoban-v0", num_envs=n, seed=SEED, device=dev, **kw
      )
      env.async_reset()
      outs = [env._recv()]
      for a in acts:
        env.send(a)
        outs.append(env._recv())
      runs.append((env.spec._state_keys, outs, env.save_state()))
    (keys, got, g_st), (_, want, w_st) = runs
    for t, (g, w) in enumerate(zip(got, want)):
      for k, gv, wv in zip(keys, g, w):
        assert gv.dtype == wv.dtype, (mode, t, k)
        np.testing.assert_array_equal(gv, wv, err_msg=f"{mode} step {t} {k}")
    for k in w_st.env:
      np.testing.assert_array_equal(g_st.env[k], w_st.env[k], err_msg=k)
    np.testing.assert_array_equal(g_st.rng, w_st.rng)
    res[mode] = {
      "fields": len(keys), "steps": steps,
      "nan_rewards": int(sum(np.isnan(o[keys.index("reward")]).sum() for o in got)),
      "terminals": int(sum(o[keys.index("done")].sum() for o in got)),
    }
  return res


# --------------------------------------------------------------- phase 7


def cartpole_card_vs_cpu(torch, envpool_torch, device, n=8192, steps=100) -> dict:
  """CartPole-v1 on the card against the CPU port, step for step: before
  each step the CPU pool loads the card pool's state, so each comparison
  is one step from identical states (the pole's instability would grow an
  ulp into any size over a free run). Returns errors and a step-loop rate."""
  card = envpool_torch.make_gymnasium(
    "CartPole-v1", num_envs=n, seed=SEED, device=device
  )
  cpu = envpool_torch.make_gymnasium(
    "CartPole-v1", num_envs=n, seed=SEED, device="cpu"
  )
  g, w = card.reset(), cpu.reset()
  np.testing.assert_array_equal(g[0], w[0])   # threefry uniform: bit-exact
  acts = np.random.default_rng(SEED + 11).integers(0, 2, (steps, n)).astype(np.int32)
  obs_err, resets = 0.0, 0
  for a in acts:
    cpu.load_state(card.save_state())
    g, w = card.step(a), cpu.step(a)
    obs_err = max(obs_err, float(np.abs(g[0] - w[0]).max()))
    for i in (1, 2, 3):
      np.testing.assert_array_equal(g[i], w[i])
    np.testing.assert_array_equal(g[4]["elapsed_step"], w[4]["elapsed_step"])
    resets += int((g[4]["elapsed_step"] == 0).sum())
  if obs_err > 1e-5:
    raise AssertionError(f"CartPole card vs cpu: obs error {obs_err}")
  assert resets > 0
  sync(torch, device)
  t0 = time.perf_counter()
  for a in acts:
    card.step(a)
  sps = steps * n / (time.perf_counter() - t0)
  return {"obs_max_err": obs_err, "auto_resets": resets, "step_sps": sps}


# --------------------------------------------------------------- phase 8

# examples/ppo_sokoban.py:29-45: PPOConfig(num_steps=32, lr=2.5e-4), the
# other fields at their defaults (2 epochs of 4 minibatches)
PPO_STEPS = 32
PPO_LR = 2.5e-4
# iterations with the update eager (as it ran before its capture), held bit for bit against as
# many with it captured
PPO_EAGER_ITERS = 2
# a Sokoban step's reward lies in [step - box, step + box + finished]
SOKOBAN_REWARD_RANGE = (-1.1, 10.9)
# the CartPole learning check of tests/test_learning.py:20-43; the port's
# own parameter draws at ppo_init seed 12 clear its bar on the CPU with a
# margin (tests/test_torch_ppo.py::test_ppo_learns_cartpole)
CARTPOLE_PPO_SEED = 12


def ppo_iteration(torch, step, state, eager_update=False):
  """One timed iteration through ``rollout`` and ``update`` (or
  ``update_eager``): -> (state, metrics as floats, host s, rollout ms and
  update ms by CUDA events)."""
  ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  ev[0].record()
  rollout = step.rollout(state)
  ev[1].record()
  state, metrics = (step.update_eager if eager_update else step.update)(state, rollout)
  ev[2].record()
  torch.cuda.synchronize()
  secs = time.perf_counter() - t0
  return (state, {k: float(v) for k, v in metrics.items()}, secs,
          ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]))


def ppo_state_equal(torch, got, want, tag: str) -> None:
  """Parameters, Adam moments and count, key and pool handle bit for bit."""
  bit_equal(torch, (got.params, got.opt_state["mu"], got.opt_state["nu"], got.key),
            (want.params, want.opt_state["mu"], want.opt_state["nu"], want.key), tag)
  bit_equal(torch, got.handle, want.handle, tag + " handle")
  if got.opt_state["count"] != want.opt_state["count"]:
    raise AssertionError(f"{tag}: Adam counts {got.opt_state['count']} and "
                         f"{want.opt_state['count']}")


def ppo_sokoban(torch, envpool_torch, device, n, iters, card) -> dict:
  """PPO over the full-width SokobanCNN (three 128-channel 3x3 convs, a
  256-unit dense layer, bf16) on Sokoban-v0 at ``n`` envs, the rollout
  captured in both runs: PPO_EAGER_ITERS iterations with the update run
  eagerly (the iteration before its capture), then ``iters`` from the same state with the
  update captured (``graph.CapturedCall``; the first one captures it), each
  timed (rollout and update by CUDA events, the iteration on the host
  clock); after PPO_EAGER_ITERS iterations the two runs' parameters, Adam
  moments, keys, handles and metrics must be equal bit for bit. Then a
  rollout and a captured update traced apart by ``torch.profiler``. Every
  metric finite, ``mean_reward`` in the Sokoban range, the parameters
  changed."""
  from envpool_torch.models import SokobanCNN
  from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init

  pool = envpool_torch.make_gymnasium(
    "Sokoban-v0", num_envs=n, seed=SEED, device=device, **SOKOBAN_KW
  )
  net = SokobanCNN()
  cfg = PPOConfig(num_steps=PPO_STEPS, lr=PPO_LR)
  state0, tx = ppo_init(pool, net, cfg, seed=SEED)
  torch.cuda.reset_peak_memory_stats()
  res = {}
  ends = {}
  for mode, count in (("eager_update", PPO_EAGER_ITERS), ("captured", iters)):
    step = make_ppo_train_step(pool, net, cfg, tx)
    state, rows = state0, []
    for it in range(count):
      state, m, secs, rollout_ms, update_ms = ppo_iteration(
        torch, step, state, eager_update=mode == "eager_update")
      if not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"PPO Sokoban {n} envs, {mode} iteration {it}: {m}")
      lo, hi = SOKOBAN_REWARD_RANGE
      if not lo <= m["mean_reward"] <= hi:
        raise AssertionError(f"PPO Sokoban: mean_reward {m['mean_reward']}")
      row = {"sps": n * PPO_STEPS / secs, "iter_ms": 1e3 * secs,
             "rollout_ms": rollout_ms, "update_ms": update_ms,
             "update_share": update_ms / (1e3 * secs), **m}
      rows.append(row)
      log(f"PPO Sokoban-v0 {n} envs, {mode} iteration {it}: {row['sps']:.1f} "
          f"env-steps/s, {row['iter_ms']:.1f} ms (rollout {rollout_ms:.1f} ms, "
          f"update {update_ms:.1f} ms by CUDA events, {100 * row['update_share']:.1f}% "
          f"of the iteration); pg_loss {m['pg_loss']:.5f} v_loss {m['v_loss']:.5f} "
          f"entropy {m['entropy']:.5f} mean_reward {m['mean_reward']:.5f} [{card}]")
      if it + 1 == PPO_EAGER_ITERS:
        ends[mode] = (state, m)
    res[mode] = {"iters": rows}
  (got, got_m), (want, want_m) = ends["captured"], ends["eager_update"]
  ppo_state_equal(torch, got, want, f"PPO {n} envs, captured update")
  if got_m != want_m:
    raise AssertionError(f"PPO {n} envs, captured metrics {got_m} against {want_m}")
  changed = sum(not torch.equal(state.params[k], state0.params[k]) for k in state0.params)
  if changed != len(state0.params):
    raise AssertionError(f"PPO Sokoban: {len(state0.params) - changed} tensors unchanged")
  graph_ = step._update
  res.update(update_capture_s=graph_.capture_s, update_instantiate_s=graph_.instantiate_s,
             update_nodes=graph_.nodes, update_host_nodes=graph_.host_nodes,
             peak_gb=torch.cuda.max_memory_allocated() / 2**30)
  # the steady iterations: the first captured one also captures the update
  steady = res["captured"]["iters"][1:]
  eager = res["eager_update"]["iters"][1:]
  res["sps"] = float(np.mean([r["sps"] for r in steady]))
  res["eager_update_sps"] = float(np.mean([r["sps"] for r in eager]))
  res["update_ms"] = float(np.mean([r["update_ms"] for r in steady]))
  res["eager_update_ms"] = float(np.mean([r["update_ms"] for r in eager]))
  log(f"PPO Sokoban-v0 {n} envs: after {PPO_EAGER_ITERS} iterations the "
      f"captured update's parameters, Adam moments, key, handle and metrics "
      f"equal the eager update's bit for bit; captured {res['sps']:.1f} "
      f"env-steps/s (update {res['update_ms']:.2f} ms) against "
      f"{res['eager_update_sps']:.1f} with the update eager "
      f"({res['eager_update_ms']:.2f} ms); the update's graph: capture "
      f"{graph_.capture_s:.3f} s, instantiate {graph_.instantiate_s:.3f} s, "
      f"{graph_.nodes} nodes [{card}]")
  last = steady[-1]
  traced = {}
  rollout = None

  def run_rollout():
    nonlocal rollout
    rollout = step.rollout(state)

  for phase, fn in (("rollout", run_rollout),
                    ("update", lambda: step.update(state, rollout))):
    busy_us, rows = profile_call(torch, fn)
    wall_us = 1e3 * last[f"{phase}_ms"]
    traced[phase] = {"busy_ms": busy_us / 1e3, "launches": sum(r[2] for r in rows),
                     "idle": 1 - busy_us / wall_us}
    log(f"profile: PPO Sokoban-v0 {phase} of {n} envs (captured), device kernels "
        f"{busy_us / 1e3:.1f} ms in {traced[phase]['launches']:.0f} launches; "
        f"untraced {phase} {wall_us / 1e3:.1f} ms, so the device idles "
        f"{100 * traced[phase]['idle']:.1f}% [{card}]")
    for kname, us, count in rows[:6]:
      log(f"  {us / 1e3:9.2f} ms {count:7.0f} launches  {kname[:100]}")
  busy_ms = sum(t["busy_ms"] for t in traced.values())
  res.update(traced=traced, busy_ms=busy_ms,
             launches=sum(t["launches"] for t in traced.values()),
             idle=1 - busy_ms / last["iter_ms"])
  log(f"profile: PPO Sokoban-v0 iteration of {n} envs, device kernels "
      f"{busy_ms:.1f} ms in {res['launches']:.0f} launches "
      f"({traced['rollout']['launches'] / PPO_STEPS:.0f} per rollout step); "
      f"untraced iteration {last['iter_ms']:.1f} ms, so the device idles "
      f"{100 * res['idle']:.1f}%; peak memory {res['peak_gb']:.2f} GiB [{card}]")
  return res


def ppo_card_vs_cpu(torch, envpool_torch, device) -> dict:
  """One PPO iteration on the card and on the CPU port from the same
  parameters and key, float32 with TF32 off: Sokoban-v0 with 64 envs of
  7x7 rooms, num_steps=8, SokobanCNN(channels=(16, 16, 16)). Returns the
  share of equal actions and the largest parameter difference."""
  from envpool_torch.models import SokobanCNN
  from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init

  tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
  runs = []
  params = None
  for dev in (device, "cpu"):
    pool = envpool_torch.make_gymnasium(
      "Sokoban-v0", num_envs=64, seed=SEED, device=dev, dim_room=7,
      max_episode_steps=60, levels_dir="", n_levels_to_load=64,
    )
    net = SokobanCNN(channels=(16, 16, 16), dtype=torch.float32)
    cfg = PPOConfig(num_steps=8)
    state, tx = ppo_init(pool, net, cfg, seed=SEED)
    if params is None:
      params = {k: v.cpu() for k, v in state.params.items()}
    state = state._replace(params={k: v.to(dev) for k, v in params.items()})
    step = make_ppo_train_step(pool, net, cfg, tx)
    rollout = step.rollout(state)
    new, metrics = step.update(state, rollout)
    runs.append((rollout[2]["action"].cpu(), {k: v.cpu() for k, v in new.params.items()},
                 {k: float(v) for k, v in metrics.items()}))
  torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
  (g_act, g_par, g_m), (w_act, w_par, w_m) = runs
  moved = max(float((w_par[k] - params[k]).abs().max()) for k in params)
  return {
    "equal_actions": float((g_act == w_act).double().mean()),
    "param_max_diff": max(float((g_par[k] - w_par[k]).abs().max()) for k in params),
    "param_max_move": moved,
    "metric_max_rel": max(abs(g_m[k] - w_m[k]) / max(abs(w_m[k]), 1e-6) for k in w_m),
  }


def ppo_learns_cartpole(torch, envpool_torch, device) -> list:
  """tests/test_learning.py:20-43 on the card, with its asserts: 64 envs,
  MLPActorCritic(hidden=(64, 64)), num_steps=64, 4 epochs of 4
  minibatches, lr 3e-4, 30 iterations."""
  from envpool_torch.models import MLPActorCritic
  from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init

  pool = envpool_torch.make_gymnasium("CartPole-v1", num_envs=64, seed=SEED, device=device)
  net = MLPActorCritic(num_actions=2, hidden=(64, 64))
  cfg = PPOConfig(num_steps=64, update_epochs=4, num_minibatches=4, lr=3e-4, ent_coef=0.01)
  state, tx = ppo_init(pool, net, cfg, seed=CARTPOLE_PPO_SEED)
  step = make_ppo_train_step(pool, net, cfg, tx)
  rewards = []
  for _ in range(30):
    state, metrics = step(state)
    rewards.append(float(metrics["mean_reward"]))
  best = float(np.max(rewards[5:]))
  if not (best > rewards[0] and best > 0.985):
    raise AssertionError(f"PPO did not learn CartPole on the card: {rewards}")
  return rewards


# --------------------------------------------------------------- phase 9

# bench.py's small device cells: MiniGrid-Empty-8x8-v0 at 8192 envs
# (bench.py:338-339) and PongJaxDemo-v5 at 4096 envs x 128 steps
# (bench.py:343-344); the random-start MiniGrid path and the toy text ids at
# the MiniGrid width
PONG_ENVS, PONG_STEPS = 4096, 128
SMALL_ENVS, SMALL_STEPS = 8192, 300
# 300 until the Box2D phase came, 150 until MuJoCo's, 100 until phase 17's
# run outgrew the time limit
TOY_TEXT_STEPS = 50
# task id -> (action count, the rewards a step may give; an auto-reset
# step gives 0)
TOY_TEXT = {
  "Catch-v0": (3, {-1.0, 0.0, 1.0}),
  "FrozenLake-v1": (4, {0.0, 1.0}),
  "FrozenLake8x8-v1": (4, {0.0, 1.0}),
  "Taxi-v3": (6, {-10.0, -1.0, 0.0, 20.0}),
  "NChain-v0": (2, {0.0, 2.0, 10.0}),
  "CliffWalking-v0": (4, {-100.0, -1.0, 0.0}),
  "Blackjack-v1": (2, {-1.0, 0.0, 1.0}),
}
# MiniGrid id -> steps, past its cap (256 and 144) so that every lane ends
# an episode (the random-start id 300 until phase 17's run outgrew the
# time limit)
MINIGRID = {"MiniGrid-Empty-8x8-v0": SMALL_STEPS, "MiniGrid-Empty-Random-6x6-v0": 150}
PONG_CARD_CPU_STEPS = 101   # every lane truncates once at the cap of 100
PONG_WIN_STEPS = 30         # then from scores one point short of 21


def small_actions(seed: int, steps: int, n: int, n_act: int) -> np.ndarray:
  return np.random.default_rng(seed).integers(0, n_act, (steps, n)).astype(np.int32)


def small_family(torch, envpool_torch, device, task_id, n, steps, n_act, check,
                 card, xla=True):
  """reset + ``steps`` uniform random actions through ``step`` (outputs
  copied to the host), ``check(obs, rew, info, dones, total)`` on the last
  step (``dones`` and ``total`` summed over the run per lane), then the same count through the ``xla()`` loop (with
  ``xla``), a traced ``xla()`` step (device time, launches, idle share) and
  the peak memory."""
  env = envpool_torch.make_gymnasium(task_id, num_envs=n, seed=SEED, device=device)
  torch.cuda.reset_peak_memory_stats()
  acts = small_actions(SEED + 14, steps, n, n_act)
  env.reset()
  dones = np.zeros(n, np.int64)
  total = np.zeros(n, np.float64)
  sync(torch, device)
  t0 = time.perf_counter()
  for a in acts:
    obs, rew, term, trunc, info = env.step(a)
    dones += term | trunc
    total += rew
  secs = time.perf_counter() - t0
  check(obs, rew, info, dones, total)
  res = {"sps": steps * n / secs, "step_ms": 1e3 * secs / steps, "episodes": int(dones.sum())}
  dev_acts = torch.from_numpy(acts).to(device)
  if xla:
    handle, _, send, _ = env.xla()
    sync(torch, device)
    t1 = time.perf_counter()
    for i in range(steps):
      handle = send(handle, dev_acts[i])
    sync(torch, device)
    secs_xla = time.perf_counter() - t1
    res.update(sps_xla=steps * n / secs_xla, xla_step_ms=1e3 * secs_xla / steps)
    env.commit(handle)
  busy_us, rows = profile_steps(torch, env, dev_acts[:3])
  step_us = 1e3 * res.get("xla_step_ms", res["step_ms"])
  res.update(busy_ms=busy_us / 1e3, launches=sum(r[2] for r in rows),
             idle=1 - busy_us / step_us if busy_us > 0 else None,
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
  rate = (f"{res['sps']:.1f} env-steps/s via step, {res['sps_xla']:.1f} in the "
          f"xla() loop" if xla else f"{res['sps']:.1f} env-steps/s via step")
  log(f"{task_id}: {n} envs, reset + {steps} steps, {res['episodes']} episodes "
      f"ended; {rate}; peak memory {res['peak_gib']:.3f} GiB [{card}]")
  log_profile(f"{task_id} xla() step of {n} envs", busy_us, rows, step_us, card, top=4)
  return res


def pong_check(obs, rew, info, dones, total):
  """Pong after 128 steps: no episode ended (the cap is 27000 and 21 points
  take longer), so every lane's score difference equals its summed rewards;
  points were scored; the frames carry paddles and ball."""
  assert obs.shape == (PONG_ENVS, 4, 84, 84) and obs.dtype == np.uint8
  assert set(np.unique(rew)) <= {-1.0, 0.0, 1.0}
  assert dones.sum() == 0, "a Pong episode ended within 128 steps"
  np.testing.assert_array_equal(info["score"][:, 0] - info["score"][:, 1], total)
  assert np.abs(total).sum() > 0, "no point scored"
  assert len(np.unique(obs[:, -1])) > 2


def minigrid_check(task_id):
  def check(obs, rew, info, dones, total):
    assert obs["image"].shape == (SMALL_ENVS, 7, 7, 3)
    assert ((rew >= 0) & (rew < 1)).all()
    assert dones.min() >= 1, f"{task_id}: a lane never ended an episode"
  return check


def toy_text_check(task_id):
  rewards = TOY_TEXT[task_id][1]

  def check(obs, rew, info, dones, total):
    assert set(np.unique(rew)) <= rewards, (task_id, np.unique(rew))
    assert len(obs) == SMALL_ENVS
  return check


def pool_run(envpool_torch, task_id, device, acts, kw, state=None):
  """A pool's raw outputs (spec order) through reset + a step per action
  row, or, from ``state``, a step per row; and its final snapshot."""
  env = envpool_torch.make_gymnasium(
    task_id, num_envs=acts.shape[1], seed=SEED, device=device, **kw
  )
  outs = []
  if state is None:
    env.async_reset()
    outs.append(env._recv())
  else:
    env.load_state(state)
  for a in acts:
    env.send(a)
    outs.append(env._recv())
  return env.spec._state_keys, outs, env.save_state()


def frames_close(got, want) -> int:
  """The resize rule: at most 1 level off, on under 0.5% of the pixels;
  returns the count off."""
  d = np.abs(got.astype(np.int16) - want.astype(np.int16))
  if d.max() > 1 or (d > 0).mean() >= 0.005:
    raise AssertionError(f"frames: max diff {d.max()}, share off {(d > 0).mean()}")
  return int((d > 0).sum())


def compare_runs(task_id, card_run, cpu_run) -> dict:
  """Every output field of the card's run against the CPU port's: bit for
  bit, observations of Pong to the resize rule; the final env state bit
  for bit."""
  (keys, got, g_st), (_, want, w_st) = card_run, cpu_run
  off = 0
  for t, (g, w) in enumerate(zip(got, want)):
    for k, gv, wv in zip(keys, g, w):
      if gv.dtype != wv.dtype:
        raise AssertionError(f"{task_id} step {t} {k}: dtype {gv.dtype} != {wv.dtype}")
      if k == "obs" and task_id == "PongJaxDemo-v5":
        off += frames_close(gv, wv)
      else:
        np.testing.assert_array_equal(gv, wv, err_msg=f"{task_id} step {t} {k}")
  for k in w_st.env:
    if not (k == "stack" and task_id == "PongJaxDemo-v5"):
      np.testing.assert_array_equal(g_st.env[k], w_st.env[k], err_msg=f"{task_id} {k}")
  np.testing.assert_array_equal(g_st.rng, w_st.rng)
  done = np.stack([o[keys.index("done")] for o in want])
  return {"outputs": len(got), "fields": len(keys), "pixels_off": off,
          "episodes": int(done.sum()), "lanes_ended": float(done.any(0).mean())}


def small_card_vs_cpu(envpool_torch, device, n=256, steps=60) -> dict:
  """Every toy text and MiniGrid id and Pong, 256 envs on the card and on
  the CPU port from the same seed and actions. The caps above 50 are cut to
  50 so that every lane ends an episode in 60 steps; Pong keeps a cap of
  100 for 101 steps, then both continue 30 steps from the card's state with
  the scores set one point short of 21 (its 21-point end)."""
  res = {}
  ids = [(t, TOY_TEXT[t][0]) for t in TOY_TEXT] + [(t, 7) for t in envpool_torch.list_all_envs()
                                                    if t.startswith("MiniGrid-")]
  for task_id, n_act in ids:
    cap = envpool_torch.make_spec(task_id).config.max_episode_steps
    kw = {"max_episode_steps": 50} if cap > 50 else {}
    acts = small_actions(SEED + 16, steps, n, n_act)
    res[task_id] = compare_runs(
      task_id, *(pool_run(envpool_torch, task_id, d, acts, kw) for d in (device, "cpu"))
    )
    if res[task_id]["lanes_ended"] < 1:
      raise AssertionError(f"{task_id}: a lane never ended an episode")
  kw = {"max_episode_steps": 100}
  acts = small_actions(SEED + 17, PONG_CARD_CPU_STEPS, n, 6)
  card_run = pool_run(envpool_torch, "PongJaxDemo-v5", device, acts, kw)
  res["PongJaxDemo-v5"] = compare_runs(
    "PongJaxDemo-v5", card_run, pool_run(envpool_torch, "PongJaxDemo-v5", "cpu", acts, kw)
  )
  state = card_run[2]
  score = np.asarray([[20, 20], [20, 19], [19, 20], [20, 20]] * (n // 4), np.int32)
  state = state._replace(env={**state.env, "score": score},
                         elapsed=np.zeros_like(state.elapsed), done=np.zeros_like(state.done))
  acts = small_actions(SEED + 18, PONG_WIN_STEPS, n, 6)
  win = compare_runs("PongJaxDemo-v5", *(
    pool_run(envpool_torch, "PongJaxDemo-v5", d, acts, kw, state) for d in (device, "cpu")
  ))
  if win["episodes"] < n // 2:
    raise AssertionError(f"Pong: {win['episodes']} 21-point ends of {n} lanes")
  res["PongJaxDemo-v5 (21-point end)"] = win
  return res


# --------------------------------------------------------------- phase 10

# bench.py runs LunarLander-v2 at 8192 envs (bench.py:336-337); the other
# Box2D ids at the same width. Each id runs 100 steps after a reset (300
# until the MuJoCo phase came, 150 until the contact MuJoCo phase came): the
# first half through step (outputs copied to the host), the second half in
# the xla() loop.
BOX2D_ENVS, BOX2D_STEPS = 8192, 100
BOX2D_IDS = ("LunarLander-v2", "LunarLanderContinuous-v2", "BipedalWalker-v3",
             "BipedalWalkerHardcore-v3")
# the card against the CPU port: 256 envs over a horizon per id. The
# landers are smooth; the walkers' 9 simultaneous contact impulses are
# chaotic, so an ulp grows into a lane that parts within tens of steps
# (tests/test_torch_bipedal_walker.py), and their horizon is short
BOX2D_CMP_ENVS = 256
BOX2D_CMP = {   # task id -> (steps, share of lanes that may part)
  "LunarLander-v2": (100, 0.05), "LunarLanderContinuous-v2": (100, 0.05),
  "BipedalWalker-v3": (10, 0.25), "BipedalWalkerHardcore-v3": (10, 0.25),
}
BOX2D_TOL = 1e-3   # float fields: |card - cpu| <= BOX2D_TOL * (1 + |cpu|)
# the share of walker lanes that may blow up to NaN in a run (the CPU port
# and the JAX package: 78 of 1024 BipedalWalker-v3 lanes in 300 steps)
BOX2D_BLOWN_UP = 0.2


def box2d_actions(task_id: str, seed: int, steps: int, n: int) -> np.ndarray:
  """Uniform actions in the id's action space."""
  rng = np.random.default_rng(seed)
  if task_id == "LunarLander-v2":
    return rng.integers(0, 4, (steps, n)).astype(np.int32)
  width = 2 if task_id.startswith("LunarLander") else 4
  return rng.uniform(-1, 1, (steps, n, width)).astype(np.float32)


def box2d_family(torch, envpool_torch, device, task_id, card) -> dict:
  """reset + BOX2D_STEPS uniform random actions at BOX2D_ENVS envs, half
  through step and half in the xla() loop, with the checks: rewards and
  discounts finite, observations and rewards finite (the walkers: but
  for the lanes that blew up, counted and bounded), the lidar in [0, 1], some lanes end an episode and
  each auto-reset gives elapsed 0, reward 0 and FIRST; then a traced
  xla() step and the peak memory."""
  n, half = BOX2D_ENVS, BOX2D_STEPS // 2
  env = envpool_torch.make_gymnasium(task_id, num_envs=n, seed=SEED, device=device)
  torch.cuda.reset_peak_memory_stats()
  acts = box2d_actions(task_id, SEED + 19, BOX2D_STEPS, n)
  env.reset()
  host = []
  sync(torch, device)
  t0 = time.perf_counter()
  for a in acts[:half]:
    host.append(env.step(a))
  secs = time.perf_counter() - t0
  # the pool's own peak: the xla() half below keeps its outputs for the checks
  peak = torch.cuda.max_memory_allocated()
  dev_acts = torch.from_numpy(acts[half:]).to(device)
  handle, _, send, _ = env.xla()
  outs = []
  sync(torch, device)
  t1 = time.perf_counter()
  for a in dev_acts:
    handle = send(handle, a)
    outs.append(handle.out)
  sync(torch, device)
  secs_xla = time.perf_counter() - t1
  env.commit(handle)
  res = {"sps": half * n / secs, "step_ms": 1e3 * secs / half,
         "sps_xla": half * n / secs_xla, "xla_step_ms": 1e3 * secs_xla / half}
  keys = env.spec._state_keys
  field = {k: np.stack([o[keys.index(k)].cpu().numpy() for o in outs])
           for k in ("obs", "reward", "discount", "done", "elapsed_step", "step_type")}
  obs = np.concatenate([np.stack([h[0] for h in host]), field["obs"]])
  rew = np.concatenate([np.stack([h[1] for h in host]), field["reward"]])
  done = np.concatenate([np.stack([h[2] | h[3] for h in host]), field["done"]])
  assert np.isfinite(field["discount"]).all(), task_id
  bad = ~(np.isfinite(obs).all(-1) & np.isfinite(rew))
  if task_id.startswith("LunarLander"):
    assert not bad.any(), f"{task_id}: {int(bad.sum())} non-finite outputs"
  else:
    # the JAX package's walker blows up to NaN in a few lanes under random
    # actions (its 9 contact impulses are applied together), and a NaN lane
    # that did not fall in that step runs on to the time limit; the port
    # reproduces it
    lanes = bad.any(0)
    assert lanes.mean() < BOX2D_BLOWN_UP, f"{task_id}: {int(lanes.sum())} lanes blew up"
    lidar = obs[..., 14:][~bad]
    assert ((lidar >= 0) & (lidar <= 1)).all(), f"{task_id}: lidar outside [0, 1]"
  assert done.any(), f"{task_id}: no lane ended an episode"
  # the xla() half: a lane done at t restarts at t + 1
  after = field["done"][:-1]
  for k, first in (("elapsed_step", 0), ("reward", 0.0), ("step_type", 0)):
    assert (field[k][1:][after] == first).all(), f"{task_id}: auto-reset {k}"
  res.update(episodes=int(done.sum()), auto_resets=int(after.sum()),
             nonfinite_obs=int(bad.sum()), nonfinite_lanes=int(bad.any(0).sum()))
  busy_us, rows = profile_steps(torch, env, dev_acts[:3])
  step_us = 1e3 * res["xla_step_ms"]
  res.update(busy_ms=busy_us / 1e3, launches=sum(r[2] for r in rows),
             idle=1 - busy_us / step_us if busy_us > 0 else None,
             peak_gib=peak / 2**30)
  log(f"{task_id}: {n} envs, reset + {half} steps via step ({res['sps']:.1f} "
      f"env-steps/s) + {half} in the xla() loop ({res['sps_xla']:.1f} env-steps/s); "
      f"{res['episodes']} episodes ended, {res['auto_resets']} auto-resets checked; "
      f"{res['nonfinite_obs']} non-finite observations in {res['nonfinite_lanes']} "
      f"lanes; peak memory {res['peak_gib']:.3f} GiB [{card}]")
  log_profile(f"{task_id} xla() step of {n} envs", busy_us, rows, step_us, card, top=8)
  return res


def box2d_blocks(torch, envpool_torch, device, task_id, card) -> dict:
  """The largest blocks of a walker step's launches, each traced alone at
  BOX2D_ENVS envs: the reset's terrain, one physics step (8 substeps, the
  lidar, the obs) and the lander's physics step for comparison."""
  from envpool_torch.core import prng
  from envpool_torch.envs.box2d import bipedal_walker

  keys = prng.split(prng.prng_key(SEED, device), BOX2D_ENVS)
  env_cls = envpool_torch.make_spec(task_id)._env_cls
  state, _, _ = env_cls.reset(None, None, keys)
  action = torch.from_numpy(box2d_actions(task_id, SEED + 21, 1, BOX2D_ENVS)[0]).to(device)
  blocks = {"physics step": lambda: env_cls.step(None, state, action, keys),
            "reset": lambda: env_cls.reset(None, None, keys)}
  if task_id.startswith("Bipedal"):
    blocks["terrain"] = lambda: bipedal_walker._terrain_heights(keys, env_cls.hardcore)
  res = {}
  for name, fn in blocks.items():
    fn()
    busy_us, rows = profile_call(torch, fn)
    res[name] = {"busy_ms": busy_us / 1e3, "launches": sum(r[2] for r in rows)}
  log(f"{task_id} blocks at {BOX2D_ENVS} envs (each traced alone): " + "; ".join(
    f"{k} {v['launches']:.0f} launches, {v['busy_ms']:.3f} ms of device time"
    for k, v in res.items()) + f" [{card}]")
  return res


def box2d_card_vs_cpu(torch, envpool_torch, device, task_id) -> dict:
  """BOX2D_CMP_ENVS envs on the card and on the CPU port from the same seed
  and actions over the id's horizon, with the process asking for TF32
  (the walker's step holds it off itself). A lane parts at its first step
  where an integer or bool field, a contact flag or the lidar differs, or a
  float field by more than BOX2D_TOL * (1 + |x|); the reset's terrain is
  equal bit for bit."""
  steps, share = BOX2D_CMP[task_id]
  acts = box2d_actions(task_id, SEED + 20, steps, BOX2D_CMP_ENVS)
  flag = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    card_run = pool_run(envpool_torch, task_id, device, acts, {})
  finally:
    torch.backends.cuda.matmul.allow_tf32 = flag
  cpu_run = pool_run(envpool_torch, task_id, "cpu", acts, {})
  (keys, got, g_st), (_, want, w_st) = card_run, cpu_run
  walker = task_id.startswith("Bipedal")
  exact_obs = [8, 13] + list(range(14, 24)) if walker else [6, 7]
  parted = np.zeros(BOX2D_CMP_ENVS, bool)
  worst = np.zeros(BOX2D_CMP_ENVS)
  for g, w in zip(got, want):
    for k, gv, wv in zip(keys, g, w):
      if gv.dtype != wv.dtype:
        raise AssertionError(f"{task_id} {k}: dtype {gv.dtype} != {wv.dtype}")
      if k in ("obs", "reward"):
        gv2, wv2 = gv.reshape(len(gv), -1), wv.reshape(len(wv), -1)
        err = np.abs(gv2.astype(np.float64) - wv2) / (1 + np.abs(wv2))
        err = np.where(np.isnan(gv2) & np.isnan(wv2), 0.0, err)
        worst = np.maximum(worst, err.max(1))
        bad = ~(err <= BOX2D_TOL).all(1)
        if k == "obs":
          bad |= (gv2[:, exact_obs] != wv2[:, exact_obs]).any(1)
      else:
        bad = (gv != wv).reshape(len(gv), -1).any(1)
      parted |= bad
  terrain = "terrain" if walker else "smooth_y"
  first = np.asarray(want[0][keys.index("elapsed_step")]) == 0
  ends = np.stack([o[keys.index("done")] for o in want]).any(0)
  # a lane that never ended kept its reset's terrain
  keep = first & ~ends & ~parted
  np.testing.assert_array_equal(g_st.env[terrain][keep], w_st.env[terrain][keep])
  res = {"steps": steps, "lanes": BOX2D_CMP_ENVS, "parted": int(parted.sum()),
         "max_rel_err_unparted": float(worst[~parted].max(initial=0.0)),
         "terrain_lanes_equal": int(keep.sum())}
  if parted.mean() > share:
    raise AssertionError(f"{task_id} card vs cpu: {res}")
  return res


# --------------------------------------------------------------- phase 11

# bench.py runs ReacherJax-v4 at 8192 envs (bench.py:347-348); the other
# contact-free device MuJoCo ids at the same width, registry defaults. Each
# id runs 60 steps after a reset (100 until the contact MuJoCo phase came):
# the first half through step (outputs copied to the host), the second half
# in the xla() loop. Reacher's cap of 50 truncates every lane at step 50,
# and each restarts at step 51.
MUJOCO_ENVS, MUJOCO_STEPS = 8192, 60
MUJOCO_IDS = ("ReacherJax-v4", "InvertedPendulumJax-v4",
              "InvertedDoublePendulumJax-v4", "SwimmerJax-v4")
# the card against the CPU port: float64 step_smooth of one env-step from
# 256 seeded states to 1e-10 relative; the float32 pools at 256 envs over
# 15 steps (50 until the contact MuJoCo phase came, 30 until phase 17's
# run outgrew the time limit), a lane parting at its
# first integer, bool or float field off by more than MUJOCO_TOL * (1 +
# |x|), counted against the id's share
MUJOCO_CMP_ENVS, MUJOCO_CMP_STEPS = 256, 15
MUJOCO_F64_TOL, MUJOCO_TOL = 1e-10, 1e-3
MUJOCO_PARTED = {"ReacherJax-v4": 0.02, "InvertedPendulumJax-v4": 0.02,
                 "InvertedDoublePendulumJax-v4": 0.1, "SwimmerJax-v4": 0.1}


def mujoco_actions(envpool_torch, task_id: str, seed: int, steps: int,
                   n: int) -> np.ndarray:
  """Uniform actions in the id's action space."""
  spec = envpool_torch.make_spec(task_id).action_array_spec["action"]
  rng = np.random.default_rng(seed)
  return rng.uniform(spec.minimum, spec.maximum,
                     (steps, n, spec.shape[-1])).astype(np.float32)


def mujoco_family(torch, envpool_torch, device, task_id, card,
                  n=MUJOCO_ENVS, steps=MUJOCO_STEPS, trace_step=True) -> dict:
  """The reset, timed alone, then ``steps`` uniform actions at ``n`` envs,
  half through step and half in the xla() loop, with the checks: every
  observation, reward and discount finite (the engine's divergence guard
  resets a lane that blows up), each auto-reset FIRST with elapsed 0 and
  reward 0, and the id's episodes: the pendulums' terminal rules,
  Reacher's cap (every lane at 50), the dm_control ids' discount 1 and no
  lane done before the cap of 1000; then a traced xla() step
  (``trace_step``; else one traced forward evaluation, times the
  evaluations per step), the byte bound of a fused env-step and the peak
  memory."""
  half = steps // 2
  env = envpool_torch.make_gymnasium(task_id, num_envs=n, seed=SEED, device=device)
  torch.cuda.reset_peak_memory_stats()
  acts = mujoco_actions(envpool_torch, task_id, SEED + 23, steps, n)
  sync(torch, device)
  t0 = time.perf_counter()
  obs0, _ = env.reset()
  sync(torch, device)
  reset_s = time.perf_counter() - t0
  host = []
  t0 = time.perf_counter()
  for a in acts[:half]:
    host.append(env.step(a))
  secs = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated()
  dev_acts = torch.from_numpy(acts[half:]).to(device)
  handle, _, send, _ = env.xla()
  outs = []
  sync(torch, device)
  t1 = time.perf_counter()
  for a in dev_acts:
    handle = send(handle, a)
    outs.append(handle.out)
  sync(torch, device)
  secs_xla = time.perf_counter() - t1
  env.commit(handle)
  res = {"envs": n, "steps": steps, "reset_s": reset_s, "sps": half * n / secs,
         "step_ms": 1e3 * secs / half, "sps_xla": half * n / secs_xla,
         "xla_step_ms": 1e3 * secs_xla / half}
  keys = env.spec._state_keys
  field = {k: np.stack([o[keys.index(k)].cpu().numpy() for o in outs])
           for k in ("reward", "discount", "done", "trunc", "elapsed_step",
                     "step_type")}
  # the observation ("obs", or the dm_control ids' "obs:<name>" fields)
  obs = [flat_obs(obs0)] + [flat_obs(h[0]) for h in host] + [
    np.concatenate([o[i].cpu().numpy().reshape(n, -1) for i, k in enumerate(keys)
                    if k.split(":")[0] == "obs"], 1) for o in outs]
  rew = np.concatenate([np.stack([h[1] for h in host]), field["reward"]])
  done = np.concatenate([np.stack([h[2] | h[3] for h in host]), field["done"]])
  assert all(np.isfinite(x).all() for x in obs), f"{task_id}: non-finite obs"
  assert np.isfinite(rew).all(), f"{task_id}: non-finite reward"
  assert np.isfinite(field["discount"]).all(), task_id
  if task_id == "ReacherJax-v4":
    assert done[49].all() and not done[:49].any(), "Reacher: cap of 50"
    # step 51, the first after the cap, is in the xla() half
    first, elapsed = field["step_type"][50 - half], field["elapsed_step"][50 - half]
    assert (first == 0).all() and (elapsed == 0).all(), "Reacher restart"
  elif task_id in ("InvertedPendulumJax-v4", "InvertedDoublePendulumJax-v4"):
    assert done.any(), f"{task_id}: no lane ended an episode"
  elif task_id.endswith("-v1"):  # dm_control: no terminal state
    assert (field["discount"] == 1.0).all(), f"{task_id}: discount"
    assert not done.any(), f"{task_id}: a lane ended before its cap"
  # the xla() half: a lane done at t restarts at t + 1
  after = field["done"][:-1]
  for k, first in (("elapsed_step", 0), ("reward", 0.0), ("step_type", 0)):
    assert (field[k][1:][after] == first).all(), f"{task_id}: auto-reset {k}"
  res.update(episodes=int(done.sum()), lanes_ended=int(done.any(0).sum()),
             auto_resets=int(after.sum()))
  env_cls, cfg = env.spec._env_cls, env.spec.config
  if hasattr(env_cls, "frame_skip"):  # the gym ids: class constants
    mdl, frame_skip = env_cls.mdl(), env_cls.frame_skip
  else:  # the dm_control ids: from the config
    mdl, frame_skip = env_cls.mdl(cfg), int(cfg.frame_skip)
  step_us = 1e3 * res["xla_step_ms"]
  if trace_step:
    busy_us, rows = profile_steps(torch, env, dev_acts[:2])
    traced = "xla() step"
  else:
    from envpool_torch.envs.mujoco import device_engine
    st = env.save_state().env
    q, v = (torch.from_numpy(st[k]).to(device) for k in ("q", "v"))
    tau = device_engine.actuator_force(mdl, dev_acts[0])
    evals = (4 if mdl.integrator == 1 else 1) * frame_skip
    # manipulator's receptacle and target: the state's body-pose overrides
    mut = (env_cls._mut(cfg, torch.from_numpy(st["target"]).to(device))
           if hasattr(env_cls, "_mut") else None)
    device_engine._qacc_full(mdl, q, v, tau, mut=mut)
    busy_us, rows = profile_call(
      torch, lambda: device_engine._qacc_full(mdl, q, v, tau, mut=mut))
    res.update(eval_busy_ms=busy_us / 1e3, eval_launches=sum(r[2] for r in rows),
               evals_per_step=evals)
    busy_us, rows = busy_us * evals, [(k, us * evals, c * evals) for k, us, c in rows]
    traced = f"forward evaluation x {evals} per step"
  # a fused env-step could not go below reading q, v and ctrl and writing
  # q and v once per env (float32), at the card's memory rate
  n_bytes = 4 * n * (2 * mdl.nq + 2 * mdl.nv + len(mdl.act_gear))
  res.update(traced=traced, busy_ms=busy_us / 1e3, launches=sum(r[2] for r in rows),
             idle=1 - busy_us / step_us if busy_us > 0 else None,
             peak_gib=peak / 2**30, bound_bytes=n_bytes,
             bound_us=1e6 * n_bytes / HBM_BYTES_PER_S)
  log(f"{task_id} step bound (no fused kernel yet, queued): "
      f"{res['bound_us']:.3f} us per step of {n} envs ({n_bytes} B, bytes)")
  log(f"{task_id}: {n} envs, reset {reset_s:.3f} s + {half} steps via step "
      f"({res['sps']:.1f} env-steps/s, {res['step_ms']:.2f} ms per step) + "
      f"{steps - half} in the xla() loop ({res['sps_xla']:.1f} env-steps/s, "
      f"{res['xla_step_ms']:.2f} ms); {res['episodes']} episodes ended "
      f"({res['lanes_ended']} lanes), {res['auto_resets']} auto-resets "
      f"checked, every output finite; peak memory {res['peak_gib']:.3f} GiB "
      f"[{card}]")
  log_profile(f"{task_id} {traced} of {n} envs", busy_us, rows, step_us, card, top=8)
  return res


def flat_obs(obs) -> np.ndarray:
  """A gymnasium observation (a dict for the dm_control ids) as one
  ``[N, k]`` array."""
  if isinstance(obs, dict):
    return np.concatenate([np.asarray(obs[k]).reshape(len(obs[k]), -1)
                           for k in sorted(obs)], 1)
  return np.asarray(obs).reshape(len(obs), -1)


def mujoco_states(mdl, n: int, seed: int):
  """(q, v, ctrl) float64 of ``n`` seeded lanes around ``init_qpos``."""
  rng = np.random.default_rng(seed)
  q = mdl.init_qpos + rng.uniform(-0.3, 0.3, (n, mdl.nq))
  v = rng.uniform(-1.0, 1.0, (n, mdl.nv))
  return q, v, rng.uniform(-1.0, 1.0, (n, len(mdl.act_gear)))


def mujoco_step64(torch, mdl, nstep: int, arrays, device, mut=None) -> list:
  """(q, v) after ``step_smooth`` of one env-step (``nstep`` substeps; with
  contacts, the warm-start chain) from float64 (q, v, ctrl) on ``device``,
  with the process asking for TF32: the contact solve's matmuls hold TF32
  off and the rest runs no matmul, so nothing may round otherwise. With
  ``mut`` (a function of a float64 tensor of targets to ``fk``'s body-pose
  overrides) ``arrays`` holds the targets fourth."""
  from envpool_torch.envs.mujoco import device_engine

  flag = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    q, v, ctrl, *target = (torch.from_numpy(a).to(device) for a in arrays)
    over = mut(target[0]) if mut is not None else None
    return [x.cpu().numpy() for x in device_engine.step_smooth(
      mdl, q, v, ctrl, nstep=nstep, mut=over)]
  finally:
    torch.backends.cuda.matmul.allow_tf32 = flag


def mujoco_float64(task_id, nstep: int, card, cpu) -> dict:
  """The card's float64 env-step against the CPU's, to MUJOCO_F64_TOL
  relative."""
  err = max(float(np.abs(g - w).max() / max(1.0, np.abs(w).max()))
            for g, w in zip(card, cpu))
  if not err <= MUJOCO_F64_TOL:
    raise AssertionError(f"{task_id} float64 card vs cpu: {err}")
  return {"lanes": len(card[0]), "substeps": nstep, "max_rel_err": err}


def mujoco_card_vs_cpu(task_id, keys, got, want, bound: float) -> dict:
  """A pool's outputs on the card (``got``) against the CPU port's
  (``want``) from the same seed and actions: a lane parts at its first
  integer or bool field that differs, or float field off by more than
  MUJOCO_TOL * (1 + |x|); the lanes that part are counted against
  ``bound``, a share of the lanes."""
  n = len(got[0][0])
  parted = np.zeros(n, bool)
  worst = np.zeros(n)
  first = np.full(n, len(got))
  for t, (g, w) in enumerate(zip(got, want)):
    for k, gv, wv in zip(keys, g, w):
      if gv.dtype != wv.dtype:
        raise AssertionError(f"{task_id} {k}: dtype {gv.dtype} != {wv.dtype}")
      if gv.dtype.kind == "f":
        gv2, wv2 = gv.reshape(len(gv), -1), wv.reshape(len(wv), -1)
        err = (np.abs(gv2.astype(np.float64) - wv2) / (1 + np.abs(wv2))).max(1)
        worst = np.maximum(worst, np.where(parted, worst, err))
        bad = ~(err <= MUJOCO_TOL)
      else:
        bad = (gv != wv).reshape(len(gv), -1).any(1)
      first = np.where(bad & ~parted, np.minimum(first, t), first)
      parted |= bad
  res = {"steps": len(got) - 1, "lanes": n, "parted": int(parted.sum()),
         "first_parted_output": int(first.min()) if parted.any() else None,
         "max_rel_err_unparted": float(worst[~parted].max(initial=0.0))}
  if parted.mean() > bound:
    raise AssertionError(f"{task_id} card vs cpu: {res}")
  return res


def log_checks(task_id, f64, cmp, bound: float) -> None:
  log(f"{task_id} float64 step_smooth card vs cpu port, {f64['lanes']} seeded "
      f"states, {f64['substeps']} substeps (TF32 requested): max relative "
      f"error {f64['max_rel_err']:.3g} (limit {MUJOCO_F64_TOL:g})")
  first = cmp["first_parted_output"]
  first = "" if first is None else f"; the first at output {first}"
  log(f"{task_id} card vs cpu port, {cmp['lanes']} envs, reset + {cmp['steps']} "
      f"steps: {cmp['parted']} lanes parted (at most {bound:.0%} allowed{first}), "
      f"the others within {cmp['max_rel_err_unparted']:.3g} relative (limit "
      f"{MUJOCO_TOL:g}) with integer and bool fields equal")


def mujoco_checks(torch, envpool_torch, device, task_id) -> dict:
  """Phase 11's card against the CPU port, both sides computed here: the
  float64 env-step from MUJOCO_CMP_ENVS seeded states, and the pools over
  MUJOCO_CMP_STEPS steps."""
  env_cls = envpool_torch.make_spec(task_id)._env_cls
  mdl, nstep = env_cls.mdl(), env_cls.frame_skip
  arrays = mujoco_states(mdl, MUJOCO_CMP_ENVS, SEED + 24)
  f64 = mujoco_float64(task_id, nstep, mujoco_step64(torch, mdl, nstep, arrays, device),
                       mujoco_step64(torch, mdl, nstep, arrays, "cpu"))
  acts = mujoco_actions(envpool_torch, task_id, SEED + 25, MUJOCO_CMP_STEPS,
                        MUJOCO_CMP_ENVS)
  keys, got, _ = pool_run(envpool_torch, task_id, device, acts, {})
  _, want, _ = pool_run(envpool_torch, task_id, "cpu", acts, {})
  cmp = mujoco_card_vs_cpu(task_id, keys, got, want, MUJOCO_PARTED[task_id])
  log_checks(task_id, f64, cmp, MUJOCO_PARTED[task_id])
  return {"float64_card_vs_cpu": f64, "card_vs_cpu": cmp}


# --------------------------------------------------------------- phase 12

# the six contact ids at bench.py's widths (bench.py:353-354 HalfCheetah at
# 4096, :358-359 Ant at 2048 x 100 steps, :366-367 the humanoid program at
# 1024), registry defaults: (envs, steps after the reset, half through step
# and half in the xla() loop; 40, 40, 40, 20, 10 and 10 steps until phase
# 15 came, 40, 20, 20, 10, 6 and 6 until phase 17's run outgrew the time
# limit). Ant and the Humanoids trace one forward evaluation (their steps
# are 37k-100k launches), the others one step
CONTACT_RUNS = {
  "HalfCheetahJax-v4": (4096, 20), "HopperJax-v4": (4096, 10),
  "Walker2dJax-v4": (4096, 10), "AntJax-v4": (2048, 4),
  "HumanoidJax-v4": (1024, 2), "HumanoidStandupJax-v4": (1024, 2),
}
CONTACT_TRACE_STEP = ("HalfCheetahJax-v4", "HopperJax-v4", "Walker2dJax-v4")
# the card against the CPU port: float64 step_smooth of one env-step (the
# warm-start chain included) from seeded states, 256 lanes (the Humanoids
# 64), to 1e-10 relative with TF32 requested; the float32 pools at 256 envs
# over 6 steps (the Humanoids 3; 20 and 10 until phase 16 came, 10 and 5
# until phase 17's run outgrew the time limit), lanes
# that part counted against the id's share. HalfCheetah's Euler contacts
# part lanes at float32 rounding (the JAX package against itself at two
# XLA optimisation levels parts 7 of 16 lanes in 20 steps); no lane of the
# others parted on the CPU. The others' shares are set from the readings
# on an H100 (PERF.md section 5; the same in every run): twice the lanes
# that parted, at least 3 of 256
CONTACT_CMP_STEPS = {t: 3 if t.startswith("Humanoid") else 6 for t in CONTACT_RUNS}
CONTACT_F64_LANES = {t: 64 if t.startswith("Humanoid") else 256 for t in CONTACT_RUNS}
CONTACT_PARTED = {
  "HalfCheetahJax-v4": 0.5, "HopperJax-v4": 3 / MUJOCO_CMP_ENVS,
  "Walker2dJax-v4": 3 / MUJOCO_CMP_ENVS, "AntJax-v4": 6 / MUJOCO_CMP_ENVS,
  "HumanoidJax-v4": 3 / MUJOCO_CMP_ENVS, "HumanoidStandupJax-v4": 12 / MUJOCO_CMP_ENVS,
}


def contact_states(mdl, task_id: str, n: int, seed: int):
  """(q, v, ctrl) float64 of ``n`` lanes that mix grounded, penetrating and
  airborne states, as ``tests/test_device_contacts.py::_random_state``
  makes them: free roots at a random height and orientation (half near
  upright, half random), planar roots at a random height (HalfCheetah's
  partly below the floor), joints perturbed."""
  rng = np.random.default_rng(seed)
  q = np.tile(mdl.init_qpos, (n, 1))
  if 0 in mdl.jnt_type:  # a free root: position, quaternion, joints
    q[:, :2] += rng.uniform(-0.3, 0.3, (n, 2))
    q[:, 2] = rng.uniform(0.2, 0.8, n) if task_id == "AntJax-v4" else rng.uniform(0.4, 1.4, n)
    quat = np.where(rng.random((n, 1)) < 0.5,
                    np.concatenate([np.ones((n, 1)), rng.uniform(-0.2, 0.2, (n, 3))], 1),
                    rng.normal(size=(n, 4)))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] += rng.uniform(-0.3, 0.3, (n, mdl.nq - 7))
  else:
    q += rng.uniform(-0.2, 0.2, (n, mdl.nq))
    q[:, 1] = (rng.uniform(-0.45, 0.1, n) if task_id == "HalfCheetahJax-v4"
               else rng.uniform(0.55, 1.1, n))
  return q, rng.uniform(-1.0, 1.0, (n, mdl.nv)), rng.uniform(-1.0, 1.0, (n, len(mdl.act_gear)))


def contact_float64_inputs(envpool_torch, task_id):
  env_cls = envpool_torch.make_spec(task_id)._env_cls
  mdl = env_cls.mdl()
  return mdl, env_cls.frame_skip, contact_states(mdl, task_id, CONTACT_F64_LANES[task_id], SEED + 26)


def contact_cmp_actions(envpool_torch, task_id):
  return mujoco_actions(envpool_torch, task_id, SEED + 27, CONTACT_CMP_STEPS[task_id],
                        MUJOCO_CMP_ENVS)


# --------------------------------------------------------------- phase 13

# the dm_control device tier at bench.py's widths (bench.py:362-363
# CheetahJaxRun-v1 at 4096, :366-367 HumanoidJaxRun-v1 at 1024), registry
# defaults: (envs, steps after the reset, half through step and half in
# the xla() loop; 40 and 10 until phase 17's run outgrew the time limit).
# The reset is timed on its own (cheetah's settles 200 substeps); Humanoid
# traces one forward evaluation (times 5 per step)
DMC_RUNS = {"CheetahJaxRun-v1": (4096, 20), "HumanoidJaxRun-v1": (1024, 4)}
DMC_TRACE_STEP = ("CheetahJaxRun-v1",)
# the card against the CPU port: float64 step_smooth of one env-step from
# seeded states (256 lanes, humanoid 64) to 1e-10 relative with TF32
# requested, for the box and tendon models; the float32 pools of one task
# per domain at 64 envs over 6 steps (swimmer15 and humanoid 3; 10 and 5
# until phase 17's run outgrew the time limit), a lane
# parting as in phase 11, counted against the id's share. The shares are
# set from the first two runs of this phase on an H100 (PERF.md section 5),
# which parted no lane but 1 of 64 of swimmer15: 3 lanes of 64 for each
# id, 4 for swimmer15
DMC_F64 = {"cartpole_three_poles": 256, "ball_in_cup": 256, "humanoid": 64}
DMC_CMP = {
  "PendulumJaxSwingup-v1": 6, "CartpoleJaxThreePoles-v1": 6,
  "AcrobotJaxSwingup-v1": 6, "ReacherJaxHard-v1": 6,
  "PointMassJaxHard-v1": 6, "SwimmerJaxSwimmer15-v1": 3,
  "FishJaxSwim-v1": 6, "FingerJaxTurnHard-v1": 6, "HopperJaxHop-v1": 6,
  "WalkerJaxRun-v1": 6, "CheetahJaxRun-v1": 6, "BallInCupJaxCatch-v1": 6,
  "HumanoidJaxRun-v1": 3,
}
DMC_CMP_ENVS = 64
DMC_PARTED = {t: 3 / DMC_CMP_ENVS for t in DMC_CMP}
DMC_PARTED["SwimmerJaxSwimmer15-v1"] = 4 / DMC_CMP_ENVS


def dmc_float64_inputs(name: str):
  """(model, substeps of one env-step, seeded float64 (q, v, ctrl)) of a
  dm_control model variant: ``contact_states``' mix for humanoid, the
  poles and the cup's ball perturbed for the others."""
  from envpool_torch.envs.mujoco.device_model import load_dmc_model
  mdl = load_dmc_model(name)
  nstep = {"cartpole_three_poles": 1, "ball_in_cup": 10, "humanoid": 5}[name]
  if name == "humanoid":
    arrays = contact_states(mdl, "HumanoidJax-v4", DMC_F64[name], SEED + 31)
  else:
    rng = np.random.default_rng(SEED + 31)
    n = DMC_F64[name]
    q = mdl.init_qpos + rng.uniform(-0.4, 0.4, (n, mdl.nq))
    arrays = (q, rng.uniform(-1.0, 1.0, (n, mdl.nv)),
              rng.uniform(-1.0, 1.0, (n, len(mdl.act_gear))))
  return mdl, nstep, arrays


def dmc_cmp_actions(envpool_torch, task_id):
  return mujoco_actions(envpool_torch, task_id, SEED + 32, DMC_CMP[task_id],
                        DMC_CMP_ENVS)


# --------------------------------------------------------------- phase 14

# the rest of the device tier at bench.py's widths (bench.py:353-354 the
# contact gym ids at 4096, :362-363 the dm_control ids at 4096, :366-367
# the humanoid programs at 1024), registry defaults: (envs, steps after the
# reset, half through step and half in the xla() loop; 40, 10 and 10
# steps until phase 15 came, 20, 6 and 6 until phase 17's run outgrew the
# time limit). Manipulator and humanoid_CMU trace one forward evaluation
# (10 per step)
LAST_RUNS = {"PusherJax-v4": (4096, 10), "ManipulatorJaxInsertPeg-v1": (4096, 2),
             "HumanoidCMUJaxRun-v1": (1024, 2)}
LAST_TRACE_STEP = ("PusherJax-v4",)
# the card against the CPU port: float64 step_smooth of one env-step per
# model (64 lanes, humanoid_CMU 32) to 1e-10 relative with TF32 requested;
# the float32 pools of the 7 new ids at 64 envs (6, 3 and 2 steps; 10, 5
# and 3 until phase 17's run outgrew the time limit), a lane parting as in
# phase 11, counted against the id's share. The shares are set from the
# readings on an H100 (PERF.md section 5: no lane parted but 1 of 64 of
# insert_peg), as phase 13's are: 3 lanes of 64 per id
LAST_F64 = {"PusherJax-v4": 64, "ManipulatorJaxInsertPeg-v1": 64,
            "HumanoidCMUJaxRun-v1": 32}
LAST_CMP = {"PusherJax-v4": 6, "ManipulatorJaxBringBall-v1": 3,
            "ManipulatorJaxBringPeg-v1": 3, "ManipulatorJaxInsertBall-v1": 3,
            "ManipulatorJaxInsertPeg-v1": 3, "HumanoidCMUJaxStand-v1": 2,
            "HumanoidCMUJaxRun-v1": 2}
LAST_CMP_ENVS = 64
LAST_PARTED = {t: 3 / LAST_CMP_ENVS for t in LAST_CMP}


def pusher_states(torch, mdl, n: int, seed: int):
  """(q, v, ctrl) float64 of ``n`` Pusher lanes whose finger capsule
  (geom 13) reaches the table, the object cylinder (geom 19) dropped
  0.03-0.09 from it: the capsule-cylinder and plane-cylinder rows."""
  from envpool_torch.envs.mujoco import device_engine

  rng = np.random.default_rng(seed)
  draws = 64 * n  # ~4% of uniform arm poses reach the table
  arm = rng.uniform(mdl.jnt_range[:7, 0], mdl.jnt_range[:7, 1], (draws, 7))
  q = np.concatenate([arm, np.zeros((draws, mdl.nq - 7))], 1)
  xpos, xmat, _, _ = device_engine.fk(mdl, torch.from_numpy(q))
  pos = {g: (xpos[mdl.geom_body[g]] + device_engine._mv(
    xmat[mdl.geom_body[g]], torch.from_numpy(mdl.geom_pos[g]))).numpy()
    for g in (13, 19)}
  low = np.where((pos[13][:, 2] > -0.30) & (pos[13][:, 2] < -0.24))[0][:n]
  assert len(low) == n, len(low)
  q = q[low]
  ang = rng.uniform(0, 2 * np.pi, n)
  near = pos[13][low, :2] + rng.uniform(0.03, 0.09, (n, 1)) * np.stack(
    [np.cos(ang), np.sin(ang)], 1)
  q[:, -3] = near[:, 0] - pos[19][low, 0]  # the object's x slide
  q[:, -4] = near[:, 1] - pos[19][low, 1]  # its y slide
  return q, rng.uniform(-1.0, 1.0, (n, mdl.nv)), rng.uniform(-2.0, 2.0, (n, 7))


def last_float64_inputs(torch, envpool_torch, task_id):
  """(model, substeps, seeded float64 (q, v, ctrl[, target]), the
  overrides' function or None) of one model of phase 14."""
  spec = envpool_torch.make_spec(task_id)
  env_cls, cfg, n = spec._env_cls, spec.config, LAST_F64[task_id]
  if task_id == "PusherJax-v4":
    mdl = env_cls.mdl()
    return mdl, env_cls.frame_skip, pusher_states(torch, mdl, n, SEED + 41), None
  mdl = env_cls.mdl(cfg)
  rng = np.random.default_rng(SEED + 41)
  if task_id == "HumanoidCMUJaxRun-v1":
    return mdl, int(cfg.frame_skip), contact_states(
      mdl, "HumanoidJax-v4", n, SEED + 41), None
  # manipulator: the reset's arms and targets, the peg in its slot, tilted
  # by up to 0.02 rad and moved by up to 5 mm (the box rows active in every
  # lane). Deeper placements make the step chaotic: 1e-14 on q moves the
  # float64 result by O(1) within the env-step, on the CPU alone
  keys = torch.from_numpy(np.stack([np.arange(n), np.full(n, 7)], 1))
  state, _, _ = env_cls.reset(cfg, None, keys)
  q, target = (state[k].double().numpy() for k in ("q", "target"))
  q[:, 8:11] = target + rng.uniform(-1.0, 1.0, (n, 3)) * [0.005, 0.005, 0.02]
  return mdl, int(cfg.frame_skip), (
    q, rng.uniform(-0.1, 0.1, (n, mdl.nv)), rng.uniform(-1.0, 1.0, (n, 5)),
    target), lambda t: env_cls._mut(cfg, t)


def last_cmp_actions(envpool_torch, task_id):
  return mujoco_actions(envpool_torch, task_id, SEED + 42, LAST_CMP[task_id],
                        LAST_CMP_ENVS)


# the CPU side of phases 12-14 in three processes at once, each with 2 of
# the host's 8 cores, balanced to end with the card's side of the
# comparisons (two processes with 3 cores each until phase 17's run
# outgrew the time limit; one with 6 until phase 16 came): per part, the
# (kind, id or model) items it computes
REFERENCE_PARTS = {
  "contact": [("contact", t) for t in CONTACT_RUNS if not t.startswith("Humanoid")]
             + [("dmc_f64", m) for m in DMC_F64] + [("dmc", t) for t in DMC_CMP],
  "humanoids": [("contact", t) for t in CONTACT_RUNS if t.startswith("Humanoid")],
  "last": [("last_f64", t) for t in LAST_F64] + [("last", t) for t in LAST_CMP],
}
REFERENCE_THREADS = 2


def cpu_reference(part: str, path: str) -> int:
  """The CPU side of phases 12, 13 and 14, in a process of its own: for
  each item of ``REFERENCE_PARTS[part]``, a contact id's float64 env-step
  from ``contact_states`` and its float32 pool's outputs ("contact"), a
  dm_control model's float64 env-step ("dmc_f64"), a dm_control id's pool
  outputs ("dmc"), and phase 14's float64 env-step ("last_f64") or pool
  outputs ("last"); written to ``path`` (npz)."""
  import torch

  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  import envpool_torch

  torch.set_num_threads(REFERENCE_THREADS)
  actions = {"contact": contact_cmp_actions, "dmc": dmc_cmp_actions,
             "last": last_cmp_actions}
  out = {}
  for kind, name in REFERENCE_PARTS[part]:
    t0 = time.perf_counter()
    if kind in ("contact", "dmc_f64", "last_f64"):
      mut = None
      if kind == "contact":
        mdl, nstep, arrays = contact_float64_inputs(envpool_torch, name)
      elif kind == "dmc_f64":
        mdl, nstep, arrays = dmc_float64_inputs(name)
      else:
        mdl, nstep, arrays, mut = last_float64_inputs(torch, envpool_torch, name)
      out[f"{name}/f64/q"], out[f"{name}/f64/v"] = mujoco_step64(
        torch, mdl, nstep, arrays, "cpu", mut)
    if kind in actions:
      keys, outs, _ = pool_run(envpool_torch, name, "cpu",
                               actions[kind](envpool_torch, name), {})
      for t, o in enumerate(outs):
        for k, x in zip(keys, o):
          out[f"{name}/pool/{t}/{k}"] = np.asarray(x)
    print(f"cpu reference {kind} {name}: {time.perf_counter() - t0:.1f} s", flush=True)
  np.savez(path, **out)
  return 0


def contact_phase(torch, envpool_torch, device, card, scratch: str):
  """Phases 12, 13 and 14: the six contact ids', the two dm_control cells'
  and phase 14's three cells' throughput runs first, with nothing else on
  the host; then three child processes (no card) compute the CPU reference
  of the three phases while the card computes its side of the
  comparisons; then each id is held to it. Returns (phase 12's results,
  phase 13's, phase 14's)."""
  t12 = time.perf_counter()
  res = {t: mujoco_family(torch, envpool_torch, device, t, card, n, steps,
                          trace_step=t in CONTACT_TRACE_STEP)
         for t, (n, steps) in CONTACT_RUNS.items()}
  log(f"contact throughput runs: {time.perf_counter() - t12:.1f} s")
  t13 = time.perf_counter()
  dmc = {t: mujoco_family(torch, envpool_torch, device, t, card, n, steps,
                          trace_step=t in DMC_TRACE_STEP)
         for t, (n, steps) in DMC_RUNS.items()}
  log(f"dm_control throughput runs: {time.perf_counter() - t13:.1f} s")
  t14 = time.perf_counter()
  last = {t: mujoco_family(torch, envpool_torch, device, t, card, n, steps,
                           trace_step=t in LAST_TRACE_STEP)
          for t, (n, steps) in LAST_RUNS.items()}
  log(f"phase 14 throughput runs: {time.perf_counter() - t14:.1f} s")
  t12c = time.perf_counter()
  env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
  children = []
  try:
    for part in REFERENCE_PARTS:
      ref_path = os.path.join(scratch, f"reference_{part}.npz")
      log_path = os.path.join(scratch, f"reference_{part}.log")
      with open(log_path, "w") as log_file:
        children.append((ref_path, log_path, subprocess.Popen(
          [sys.executable, os.path.abspath(__file__), "--cpu-reference", part,
           ref_path],
          stdout=log_file, stderr=subprocess.STDOUT, env=env)))
    on_card = {}
    for task_id in CONTACT_RUNS:
      mdl, nstep, arrays = contact_float64_inputs(envpool_torch, task_id)
      keys, got, _ = pool_run(envpool_torch, task_id, device,
                              contact_cmp_actions(envpool_torch, task_id), {})
      on_card[task_id] = nstep, mujoco_step64(torch, mdl, nstep, arrays, device), keys, got
    dmc_f64 = {}
    for name in DMC_F64:
      mdl, nstep, arrays = dmc_float64_inputs(name)
      dmc_f64[name] = nstep, mujoco_step64(torch, mdl, nstep, arrays, device)
    dmc_pools = {}
    for task_id in DMC_CMP:
      keys, got, _ = pool_run(envpool_torch, task_id, device,
                              dmc_cmp_actions(envpool_torch, task_id), {})
      dmc_pools[task_id] = keys, got
    last_f64, last_pools = {}, {}
    for task_id in LAST_F64:
      mdl, nstep, arrays, mut = last_float64_inputs(torch, envpool_torch, task_id)
      last_f64[task_id] = nstep, mujoco_step64(torch, mdl, nstep, arrays, device, mut)
    for task_id in LAST_CMP:
      keys, got, _ = pool_run(envpool_torch, task_id, device,
                              last_cmp_actions(envpool_torch, task_id), {})
      last_pools[task_id] = keys, got
    log(f"contact, dm_control and phase 14 card side of the comparisons: "
        f"{time.perf_counter() - t12c:.1f} s")
    rcs = [child.wait(timeout=900) for _, _, child in children]
  finally:
    for _, _, child in children:
      if child.poll() is None:
        child.kill()
        child.wait()
  ref = {}
  for (ref_path, log_path, _), rc in zip(children, rcs):
    with open(log_path) as f:
      for line in f.read().splitlines()[-20:]:
        log(f"  {line}")
    if rc != 0:
      raise AssertionError(f"the CPU reference process {log_path} exited {rc}")
    with np.load(ref_path) as part:
      ref.update({k: part[k] for k in part.files})
  for task_id, (nstep, step64, keys, got) in on_card.items():
    f64 = mujoco_float64(task_id, nstep, step64,
                         [ref[f"{task_id}/f64/q"], ref[f"{task_id}/f64/v"]])
    want = [[ref[f"{task_id}/pool/{t}/{k}"] for k in keys] for t in range(len(got))]
    cmp = mujoco_card_vs_cpu(task_id, keys, got, want, CONTACT_PARTED[task_id])
    log_checks(task_id, f64, cmp, CONTACT_PARTED[task_id])
    res[task_id].update(float64_card_vs_cpu=f64, card_vs_cpu=cmp)
  for name, (nstep, step64) in dmc_f64.items():
    f64 = mujoco_float64(name, nstep, step64, [ref[f"{name}/f64/q"], ref[f"{name}/f64/v"]])
    log(f"{name} float64 step_smooth card vs cpu port, {f64['lanes']} seeded "
        f"states, {nstep} substeps (TF32 requested): max relative error "
        f"{f64['max_rel_err']:.3g} (limit {MUJOCO_F64_TOL:g})")
    dmc.setdefault("float64_card_vs_cpu", {})[name] = f64
  for pools, parted, out in ((dmc_pools, DMC_PARTED, dmc),
                             (last_pools, LAST_PARTED, last)):
    for task_id, (keys, got) in pools.items():
      want = [[ref[f"{task_id}/pool/{t}/{k}"] for k in keys] for t in range(len(got))]
      cmp = mujoco_card_vs_cpu(task_id, keys, got, want, parted[task_id])
      first = cmp["first_parted_output"]
      first = "" if first is None else f"; the first at output {first}"
      log(f"{task_id} card vs cpu port, {cmp['lanes']} envs, reset + {cmp['steps']} "
          f"steps: {cmp['parted']} lanes parted (at most {parted[task_id]:.2%} "
          f"allowed{first}), the others within {cmp['max_rel_err_unparted']:.3g} "
          f"relative (limit {MUJOCO_TOL:g}) with integer and bool fields equal")
      out.setdefault("card_vs_cpu", {})[task_id] = cmp
  for task_id, (nstep, step64) in last_f64.items():
    f64 = mujoco_float64(task_id, nstep, step64,
                         [ref[f"{task_id}/f64/q"], ref[f"{task_id}/f64/v"]])
    log(f"{task_id} float64 step_smooth card vs cpu port, {f64['lanes']} seeded "
        f"states, {nstep} substeps (TF32 requested): max relative error "
        f"{f64['max_rel_err']:.3g} (limit {MUJOCO_F64_TOL:g})")
    last.setdefault("float64_card_vs_cpu", {})[task_id] = f64
  log(f"contact, dm_control and phase 14 card vs cpu: "
      f"{time.perf_counter() - t12c:.1f} s")
  return res, dmc, last


# --------------------------------------------------------------- phase 15

# sharding on the card (envpool_torch.parallel): make_mesh(), one shard on
# this card, and a mesh of SHARDS logical shards of cuda:0. CarRacing runs
# 25 steps and Sokoban 64, past its cap of 60 (50 and 100 until phase 17's
# run outgrew the time limit)
SHARDS = 4
SHARD_DEVICE = "cuda:0"
SHARD_CAR_STEPS = 25
SHARD_SOKOBAN_STEPS = 64
SHARD_PPO_ITERS = 2
SHARD_ROLLOUT_STEPS = 16  # the sharded rollout, captured against eager
SHARD_CAPTURE_STEPS = 8  # the sharded trainer's steps, captured against eager
# PPO on Sokoban, sharded against unsharded from the same parameters and
# key. A shard's convs and GEMMs run at a quarter of the batch, where cuDNN
# and cuBLAS may pick other kernels: a logit off in its last bits flips a
# near-tie of the Gumbel draw, and that lane's trajectory goes its own way.
# The share of actions that may differ per rollout, set from the readings
# (PERF.md section 5: none differed in 3 rollouts of 32,768 actions): 0.1%;
# the metrics within rtol 1e-3 (atol 1e-5: pg_loss is a mean of
# near-cancelling terms), ten times the CPU test's 1e-4 / 1e-6 in bf16
SHARD_PPO_FLIPS = 1e-3
SHARD_PPO_RTOL, SHARD_PPO_ATOL = 1e-3, 1e-5


def shard_meshes(torch):
  from envpool_torch.parallel import make_mesh

  return {"make_mesh()": make_mesh(),
          f"{SHARDS} shards of cuda:0": make_mesh(devices=[SHARD_DEVICE] * SHARDS)}


def same_outputs(got, want, tag: str) -> None:
  """Equal values through the dialect's tuples and dicts (NaN equal)."""
  if isinstance(want, dict):
    assert sorted(got) == sorted(want), tag
    for k in want:
      same_outputs(got[k], want[k], f"{tag}/{k}")
  elif isinstance(want, tuple):
    for i, (g, w) in enumerate(zip(got, want)):
      same_outputs(g, w, f"{tag}/{i}")
  else:
    np.testing.assert_array_equal(got, want, err_msg=tag)


def lockstep(torch, envpool_torch, task_id, kw, acts, pools_for, counter=None):
  """The unsharded pool and one sharded pool per mesh driven in lockstep
  through ``step``, every output field of each step bit for bit against
  the unsharded pool's. Returns per pool name (env, env-steps/s, counter
  increments, renders expected from its shards' done flags)."""
  from envpool_torch.parallel.sharded import ShardedGymnasiumEnvPool

  spec = envpool_torch.make_spec(task_id, **kw)
  pools = {"unsharded": envpool_torch.make_gymnasium(task_id, device=SHARD_DEVICE, **kw)}
  for name, mesh in pools_for.items():
    pools[name] = ShardedGymnasiumEnvPool(spec, mesh)
  n = int(spec.config.num_envs)
  res = {k: {"env": p, "secs": 0.0, "launches": 0, "renders": 0} for k, p in pools.items()}
  done = {k: np.ones(n, bool) for k in pools}
  for t in range(len(acts) + 1):
    want = None
    for name, env in pools.items():
      r = res[name]
      shards = len(getattr(env, "_shards", [None]))
      b = n // shards
      # the reset is forced: one render per shard
      r["renders"] += shards if t == 0 else sum(
        renders_for(done[name][s * b:(s + 1) * b]) for s in range(shards))
      if counter is not None:
        counter.launches = 0
      sync(torch, SHARD_DEVICE)
      t0 = time.perf_counter()
      out = env.reset() if t == 0 else env.step(acts[t - 1])
      sync(torch, SHARD_DEVICE)
      if t:
        r["secs"] += time.perf_counter() - t0
        done[name] = out[2] | out[3]
      else:
        done[name] = np.zeros(n, bool)
      if counter is not None:
        r["launches"] += counter.launches
      if want is None:
        want = out
      else:
        same_outputs(out, want, f"{task_id} {name} step {t}")
  for r in res.values():
    r["sps"] = len(acts) * n / r["secs"]
  return res


def car_racing_sharded(torch, envpool_torch, sampler, card) -> dict:
  """CarRacing-v2 at N_ENVS, reset + SHARD_CAR_STEPS steps, on both meshes
  bit for bit against TorchEnvPool; the sampler launched once per shard per
  render."""
  rng = np.random.default_rng(SEED + 40)
  acts = [random_actions(rng, N_ENVS) for _ in range(SHARD_CAR_STEPS)]
  res = lockstep(torch, envpool_torch, "CarRacing-v2", dict(num_envs=N_ENVS, seed=SEED),
                 acts, shard_meshes(torch), counter=sampler.fused_background)
  out = {}
  for name, r in res.items():
    if r["launches"] != r["renders"]:
      raise AssertionError(f"CarRacing {name}: sampler launches {r['launches']}, "
                           f"expected {r['renders']} (one per shard per render)")
    per_render = r["launches"] / (SHARD_CAR_STEPS + 1)
    out[name] = {"sps": r["sps"], "launches": r["launches"], "per_render": per_render}
    log(f"sharded CarRacing-v2 {name}: {N_ENVS} envs, reset + {SHARD_CAR_STEPS} "
        f"steps bit for bit against TorchEnvPool; sampler launches "
        f"{r['launches']} = {per_render:.0f} per render (one per shard); "
        f"{r['sps']:.1f} env-steps/s via step [{card}]")
  return out


def sokoban_sharded(torch, envpool_torch, card) -> dict:
  """Sokoban-v0 at SOKOBAN_ENVS over SHARD_SOKOBAN_STEPS steps of actions
  in [-1, 3], random and sequential level modes (every lane auto-resets at
  the cap of 60), both meshes bit for bit against the unsharded pool;
  env-steps/s and launches per traced xla() step. Returns the results and
  the 4-shard random-mode pool."""
  out, keep = {}, None
  for mode in ("random", "sequential"):
    kw = dict(num_envs=SOKOBAN_ENVS, seed=SEED, **SOKOBAN_KW,
              load_sequentially=mode == "sequential")
    acts = sokoban_actions(SEED + 41, SHARD_SOKOBAN_STEPS, SOKOBAN_ENVS)
    res = lockstep(torch, envpool_torch, "Sokoban-v0", kw, acts, shard_meshes(torch))
    dev_acts = torch.from_numpy(sokoban_actions(SEED + 42, 4, SOKOBAN_ENVS)).to(SHARD_DEVICE)
    for name, r in res.items():
      busy_us, rows = profile_steps(torch, r["env"], dev_acts)
      launches = sum(x[2] for x in rows)
      out[f"{mode} {name}"] = {"sps": r["sps"], "launches": launches,
                               "busy_us": busy_us}
      log(f"sharded Sokoban-v0 {mode} mode {name}: {SOKOBAN_ENVS} envs, reset + "
          f"{SHARD_SOKOBAN_STEPS} steps bit for bit against the unsharded pool; "
          f"{r['sps']:.1f} env-steps/s via step; a traced xla() step "
          f"{launches:.0f} launches, {busy_us:.1f} us of device kernels [{card}]")
    if mode == "random":
      keep = res[f"{SHARDS} shards of cuda:0"]["env"]
  return out, keep


def flips_and_outputs(want, got):
  """(share of differing actions, pool outputs checked): the rollouts'
  obs, reward and done equal wherever the lane's actions agreed so far."""
  wa, ga = want["action"].cpu().numpy(), got["action"].cpu().numpy()
  agree = np.cumprod(wa == ga, axis=0).astype(bool)          # [T, N]
  before = np.concatenate([np.ones_like(agree[:1]), agree[:-1]])
  checked = 0
  for k, mask in (("obs", before), ("reward", agree), ("done", agree)):
    w, g = want[k].cpu().numpy()[mask], got[k].cpu().numpy()[mask]
    np.testing.assert_array_equal(g, w, err_msg=f"sharded PPO rollout {k}")
    checked += int(mask.sum())
  return float((wa != ga).mean()), checked


def metrics_close(got: dict, want: dict, tag: str) -> float:
  worst = 0.0
  for k in want:
    diff = abs(got[k] - want[k])
    if not (np.isfinite(got[k]) and diff <= SHARD_PPO_ATOL + SHARD_PPO_RTOL * abs(want[k])):
      raise AssertionError(f"{tag}: {k} {got[k]} against {want[k]}")
    worst = max(worst, diff / max(abs(want[k]), 1e-12))
  return worst


def ppo_sharded(torch, envpool_torch, card) -> dict:
  """examples/ppo_sokoban.py's full width (SokobanCNN(), 1024 envs,
  PPOConfig(num_steps=32, lr=2.5e-4)): SHARD_PPO_ITERS iterations unsharded
  and on the 4-shard env mesh, and one on a (2, 2) mesh with
  model_axis="model", through the trainer's ``rollout`` and ``update`` (on
  this card's meshes the unsharded iteration, captured) and once more
  through the per-row path that a mesh over several cards runs
  (``rollout_rows`` / ``update_rows``, eager: each row's block, the model
  axis's column blocks). Each sharded iteration starts from the unsharded
  run's parameters, optimizer state and key (its pool from its own last
  iteration): bf16 would carry the float32 parameters' last-bit
  differences into whole bf16 steps. Rollout outputs equal where the
  actions agree, differing actions within SHARD_PPO_FLIPS, metrics close;
  the one-device paths' parameters, Adam moments, key and metrics equal
  the unsharded iteration's bit for bit."""
  from envpool_torch.models import SokobanCNN
  from envpool_torch.parallel import Mesh, ShardedEnvPool, make_mesh
  from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init

  n = 1024
  spec = envpool_torch.make_spec("Sokoban-v0", num_envs=n, seed=SEED, **SOKOBAN_KW)
  cfg = PPOConfig(num_steps=PPO_STEPS, lr=PPO_LR)
  model_mesh = Mesh(np.array([SHARD_DEVICE] * 4, object).reshape(2, 2),
                    ("env", "model"))
  # name -> (mesh, model axis, iterations, through the per-row path)
  layouts = {
    "unsharded": (None, None, SHARD_PPO_ITERS, False),
    f"env mesh of {SHARDS}": (make_mesh(devices=[SHARD_DEVICE] * SHARDS), None,
                              SHARD_PPO_ITERS, False),
    "(2, 2) env x model": (model_mesh, "model", 1, False),
    "(2, 2) env x model, per row": (model_mesh, "model", 1, True),
  }
  runs = {}
  for name, (mesh, model_axis, _, _) in layouts.items():
    pool = (envpool_torch.make_gymnasium("Sokoban-v0", num_envs=n, seed=SEED,
                                         device=SHARD_DEVICE, **SOKOBAN_KW)
            if mesh is None else ShardedEnvPool(spec, mesh))
    net = SokobanCNN()
    state, tx = ppo_init(pool, net, cfg, seed=SEED)
    step = make_ppo_train_step(pool, net, cfg, tx, mesh=mesh, model_axis=model_axis)
    runs[name] = {"state": state, "rows": [], "step": step}
  for it in range(SHARD_PPO_ITERS):
    start = runs["unsharded"]["state"]
    for name, (mesh, _, iters, per_row) in layouts.items():
      if it >= iters:
        continue
      run = runs[name]
      state = run["state"]._replace(params=start.params, opt_state=start.opt_state,
                                    key=start.key)
      step = run["step"]
      sync(torch, SHARD_DEVICE)
      t0 = time.perf_counter()
      rollout = step.rollout_rows(state) if per_row else step.rollout(state)
      sync(torch, SHARD_DEVICE)
      t1 = time.perf_counter()
      run["state"], metrics = (step.update_rows if per_row else step.update)(state, rollout)
      sync(torch, SHARD_DEVICE)
      t2 = time.perf_counter()
      traj = rollout[2] if mesh is None else step.gather(rollout[2], torch.device(SHARD_DEVICE))
      run["rows"].append({"traj": traj, "metrics": {k: float(v) for k, v in metrics.items()},
                          "state": run["state"], "per_row": per_row,
                          "rollout_ms": 1e3 * (t1 - t0), "update_ms": 1e3 * (t2 - t1)})
  out = {}
  base = runs["unsharded"]["rows"]
  for name, run in runs.items():
    res = []
    for it, row in enumerate(run["rows"]):
      m = row["metrics"]
      if not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"PPO {name} iteration {it}: {m}")
      entry = {"iter_ms": row["rollout_ms"] + row["update_ms"],
               "rollout_ms": row["rollout_ms"], "update_ms": row["update_ms"], **m}
      extra = ""
      if name != "unsharded" and not row["per_row"]:
        # one card: the unsharded iteration, bit for bit
        got, want = row["state"], base[it]["state"]
        bit_equal(torch, (got.params, got.opt_state["mu"], got.opt_state["nu"], got.key),
                  (want.params, want.opt_state["mu"], want.opt_state["nu"], want.key),
                  f"PPO {name} iteration {it}")
        bit_equal(torch, row["traj"], base[it]["traj"], f"PPO {name} rollout {it}")
        if m != base[it]["metrics"]:
          raise AssertionError(f"PPO {name} iteration {it}: {m} against "
                               f"{base[it]['metrics']}")
        entry["bit_for_bit"] = True
        extra = "; trajectory, parameters, Adam moments, key and metrics bit for bit"
      elif name != "unsharded":
        flips, checked = flips_and_outputs(base[it]["traj"], row["traj"])
        entry["flips"] = flips
        entry["metric_max_rel"] = metrics_close(m, base[it]["metrics"], f"PPO {name} {it}")
        if flips > SHARD_PPO_FLIPS:
          raise AssertionError(f"PPO {name} iteration {it}: {flips:.5f} of the "
                               f"actions differ (bound {SHARD_PPO_FLIPS})")
        extra = (f"; {100 * flips:.4f}% of {PPO_STEPS * n} actions differ from the "
                 f"unsharded rollout (bound {100 * SHARD_PPO_FLIPS:g}%), pool outputs "
                 f"equal at the {checked} (step, lane) fields where the lane's actions "
                 f"agreed; metrics within {entry['metric_max_rel']:.3g} relative")
      res.append(entry)
      log(f"PPO Sokoban-v0 {name}, {n} envs, iteration {it}: {entry['iter_ms']:.1f} ms "
          f"(rollout {entry['rollout_ms']:.1f}, update {entry['update_ms']:.1f}); "
          f"pg_loss {m['pg_loss']:.6f} v_loss {m['v_loss']:.6f} entropy "
          f"{m['entropy']:.6f} mean_reward {m['mean_reward']:.6f}{extra} [{card}]")
    out[name] = res
  return out


def sharded_captured(torch, envpool_torch, card) -> dict:
  """The sharded paths captured against eager, on both meshes of
  ``shard_meshes``: ``ShardedEnvPool.rollout`` of Sokoban-v0 at
  SOKOBAN_ENVS envs over SHARD_ROLLOUT_STEPS steps (a policy of threefry
  draws, its key in the carry) through its ``graph.CapturedScan`` against
  the same steps through ``xla()`` one by one, every field and the final
  state bit for bit; ``ShardedPPOTrainStep`` at ``examples/ppo_sokoban.py``'s
  width (``SokobanCNN()``, 1024 envs, SHARD_CAPTURE_STEPS steps), one
  iteration captured
  (rollout and update) against the same iteration with both run eagerly,
  parameters, Adam state, key, handle and metrics bit for bit, on both
  meshes and on a (2, 2) env x model mesh of cuda:0. env-steps/s of each
  (captured: a second iteration, its graphs replayed)."""
  from envpool_torch.core import prng
  from envpool_torch.models import SokobanCNN
  from envpool_torch.parallel import Mesh, ShardedEnvPool
  from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init

  n = SOKOBAN_ENVS
  spec = envpool_torch.make_spec("Sokoban-v0", num_envs=n, seed=SEED, **SOKOBAN_KW)
  cfg = PPOConfig(num_steps=SHARD_CAPTURE_STEPS, lr=PPO_LR)
  ppo_spec = envpool_torch.make_spec("Sokoban-v0", num_envs=1024, seed=SEED, **SOKOBAN_KW)
  out = {}

  def policy(key, states):
    key, sub = prng.split(key, 2)
    return key, prng.randint(sub, (n,), -1, 4)

  for name, mesh in shard_meshes(torch).items():
    pool = ShardedEnvPool(spec, mesh)
    key0 = prng.prng_key(SEED + 44, SHARD_DEVICE)
    handle, recv, send, _ = pool.xla()
    sync(torch, SHARD_DEVICE)
    t0 = time.perf_counter()
    key, rows = key0, []
    for _ in range(SHARD_ROLLOUT_STEPS):
      _, states = recv(handle)
      key, action = policy(key, states)
      handle = send(handle, action)
      rows.append(tuple(states))
    sync(torch, SHARD_DEVICE)
    eager_s = time.perf_counter() - t0
    want = tuple(torch.stack(r) for r in zip(*rows))
    del rows
    (got_handle, got_key), traj = pool.rollout(policy, key0, SHARD_ROLLOUT_STEPS)
    bit_equal(torch, traj, want, f"sharded rollout on {name}")
    bit_equal(torch, (got_handle.pool, got_key), (handle.pool, key),
              f"sharded rollout's final state on {name}")
    del traj, want
    sync(torch, SHARD_DEVICE)
    t0 = time.perf_counter()
    pool.rollout(policy, key0, SHARD_ROLLOUT_STEPS)
    sync(torch, SHARD_DEVICE)
    captured_s = time.perf_counter() - t0
    scan = pool._rollout_scan[1]
    out[name] = {"rollout_eager_sps": SHARD_ROLLOUT_STEPS * n / eager_s,
                 "rollout_captured_sps": SHARD_ROLLOUT_STEPS * n / captured_s,
                 "rollout_nodes": scan.nodes, "rollout_capture_s": scan.capture_s}
    log(f"sharding on {name}: Sokoban-v0 rollout ({n} envs x {SHARD_ROLLOUT_STEPS} "
        f"steps) captured bit for bit against eager, "
        f"{out[name]['rollout_eager_sps']:.1f} -> {out[name]['rollout_captured_sps']:.1f} "
        f"env-steps/s ({scan.nodes} nodes) [{card}]")
    del pool, scan
    torch.cuda.empty_cache()
  trainers, kept = dict(shard_meshes(torch)), {}
  trainers["(2, 2) env x model of cuda:0"] = Mesh(
    np.array([SHARD_DEVICE] * 4, object).reshape(2, 2), ("env", "model"))
  for name, mesh in trainers.items():
    # the trainer: captured against eager, from one state
    model_axis = "model" if "model" in mesh.axis_names else None
    res = out.setdefault(name, {})
    pool = ShardedEnvPool(ppo_spec, mesh)
    net = SokobanCNN()
    state0, tx = ppo_init(pool, net, cfg, seed=SEED)
    ends = {}
    for mode in ("eager", "captured"):
      step = make_ppo_train_step(pool, net, cfg, tx, mesh=mesh, model_axis=model_axis)
      run = step.eager if mode == "eager" else step
      state, secs = state0, []
      # the captured run's second iteration, timed alone, replays its graphs
      for it in range(1 if mode == "eager" else 2):
        sync(torch, SHARD_DEVICE)
        t0 = time.perf_counter()
        state, metrics = run(state)
        sync(torch, SHARD_DEVICE)
        secs.append(time.perf_counter() - t0)
        if it == 0:
          ends[mode] = (state, {k: float(v) for k, v in metrics.items()})
      res[f"ppo_{mode}_sps"] = 1024 * SHARD_CAPTURE_STEPS / secs[-1]
      res[f"ppo_{mode}_iter_ms"] = [1e3 * x for x in secs]
    ppo_state_equal(torch, ends["captured"][0], ends["eager"][0],
                    f"sharded trainer on {name}")
    if ends["captured"][1] != ends["eager"][1]:
      raise AssertionError(f"sharded trainer on {name}: metrics {ends['captured'][1]} "
                           f"against {ends['eager'][1]}")
    res.update(ppo_update_nodes=step._update.nodes, ppo_rollout_nodes=step._scan.nodes,
               metrics=ends["captured"][1])
    kept[name] = ends["captured"]
    log(f"sharding on {name}: PPO (1024 envs, {SHARD_CAPTURE_STEPS} steps, one "
        f"iteration) captured against eager, parameters, Adam "
        f"state, key, handle and metrics bit for bit, {res['ppo_eager_sps']:.1f} -> "
        f"{res['ppo_captured_sps']:.1f} env-steps/s per iteration; metrics "
        f"{res['metrics']} [{card}]")
    del pool, step, state, state0, ends
    torch.cuda.empty_cache()
  # on one card every mesh runs the unsharded iteration: the model axis's
  # ends equal the env mesh's bit for bit
  env_mesh = f"{SHARDS} shards of cuda:0"
  (got, got_m), (want, want_m) = kept[name], kept[env_mesh]
  bit_equal(torch, (got.params, got.opt_state["mu"], got.opt_state["nu"], got.key),
            (want.params, want.opt_state["mu"], want.opt_state["nu"], want.key),
            f"sharded trainer on {name} against {env_mesh}")
  if got_m != want_m:
    raise AssertionError(f"sharded trainer on {name}: metrics {got_m} against {want_m}")
  log(f"sharding: on {name} the captured iteration's parameters, Adam state, "
      f"key and metrics equal the {env_mesh} one's bit for bit [{card}]")
  return out


def checkpoint_and_trace(torch, envpool_torch, pool, scratch, card) -> dict:
  """A file checkpoint of the 4-shard Sokoban pool replays 5 steps bit for
  bit; ``trace`` of 2 steps writes a Chrome trace that lists CUDA kernels."""
  from envpool_torch.utils import load_pool_state, save_pool_state, trace

  path = os.path.join(scratch, "sharded_sokoban")
  save_pool_state(pool, path)
  acts = sokoban_actions(SEED + 43, 5, SOKOBAN_ENVS)
  want = [pool.step(a) for a in acts]
  load_pool_state(pool, path)
  for t, a in enumerate(acts):
    same_outputs(pool.step(a), want[t], f"checkpoint replay step {t}")
  size = os.path.getsize(path + ".npz")
  log(f"checkpoint: {SHARDS}-shard Sokoban-v0 at {SOKOBAN_ENVS} envs, "
      f"{size} B file, 5 steps replayed bit for bit")
  log_dir = os.path.join(scratch, "trace")
  with trace(log_dir) as prof:
    for a in acts[:2]:
      pool.step(a)
  from torch.autograd import DeviceType

  kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
  files = sorted(os.listdir(log_dir))
  with open(os.path.join(log_dir, files[-1])) as f:
    events = json.load(f)["traceEvents"]
  in_file = sum(1 for e in events if e.get("cat") == "kernel")
  if not kernels or not in_file:
    raise AssertionError(f"trace: {len(kernels)} CUDA kernels in the profile, "
                         f"{in_file} kernel events in {files[-1]}")
  log(f"trace: {files[-1]} lists {in_file} CUDA kernel events ({len(kernels)} "
      f"kinds) of 2 steps of the {SHARDS}-shard pool [{card}]")
  return {"checkpoint_bytes": size, "trace_kernel_events": in_file}


# --------------------------------------------------------------- phase 16

# the host tier's cell: the Atari wrapper stack at the JAX package's
# defaults (gray, 84x84, stack 4, frame_skip 4, noop_max 30; the registry's
# cap of 27000) over a scripted emulator, since the card's machine has no
# ale_py and no ROM; num_threads = the host's cores. 48 steps end every
# lane's game at least once: its third life goes at act 110, step 36 at
# the latest after 30 noops (200 steps until phase 17's run outgrew the
# time limit)
HOST_ENVS = 256
HOST_STEPS = 48
HOST_ASYNC_BATCH = 64
# the xla() loop with the actions on the host (24 steps until the captured
# checks came) and the captured scan
HOST_OVERLAP_STEPS = 12
HOST_ACTIONS = 4  # the scripted emulator's minimal action set
GIL_QUEUE_MS = 50  # device work queued ahead of a host function
GIL_REPLAYS = 4096  # replays of a graph with a host node, past the launch queue
HOST_PPO_ENVS, HOST_PPO_STEPS = 32, 4  # PPO over the host pool, captured vs eager
HOST_CHILD_TIMEOUT = 420  # phase 16's child (~100 s on an H100 host)


class ScriptedALE:
  """An emulator with ``tests/test_atari_stack.py``'s ``FakeALE`` rules:
  210x160 screens holding the frame counter, 3 lives (one lost every 37
  acts), game over at ``end_at`` acts or with no life left, reward = the
  action's value."""

  def __init__(self, end_at=1000):
    self.t = 0
    self.end_at = end_at
    self._lives = 3

  def getMinimalActionSet(self):
    return [0, 1, 3, 4]

  def getLegalActionSet(self):
    return list(range(18))

  def act(self, a):
    self.t += 1
    if self.t % 37 == 36:
      self._lives -= 1
    return float(a)

  def game_over(self):
    return self.t >= self.end_at or self._lives <= 0

  def lives(self):
    return self._lives

  def reset_game(self):
    self.t = 0
    self._lives = 3

  def getScreenGrayscale(self, buf):
    buf[:] = self.t % 256

  def getScreenRGB(self, buf):
    buf[:] = self.t % 256


def scripted_atari_pool(atari, device, **kw):
  """The port's Atari gymnasium pool over ``ScriptedALE`` (the caller has
  set ``atari_env._make_ale``)."""
  config = dict(num_envs=HOST_ENVS, seed=SEED, max_episode_steps=27000,
                num_threads=os.cpu_count())
  config.update(kw)
  spec = atari.AtariEnvSpec(atari.AtariEnvSpec.gen_config(**config))
  return atari.AtariGymnasiumEnvPool(spec, device)


def host_sync_loop(pool, acts):
  """Reset + a step per action row through the user's ``step`` path
  (``send``, then ``recv``'s ``_recv`` and conversion), keeping each raw
  output list. Returns (outputs, reset s, steps s)."""
  t0 = time.perf_counter()
  pool._reset(pool.all_env_ids)
  outs = [pool._recv()]
  pool._to(outs[0], True, True)
  t1 = time.perf_counter()
  for act in acts:
    pool.send(act)
    outs.append(pool._recv())
    pool._to(outs[-1], False, True)
  return outs, t1 - t0, time.perf_counter() - t1


def host_async_rate(pool, rounds, draw) -> float:
  """env-steps/s of ``rounds`` recv/send rounds of an async pool from its
  ``async_reset``; ``draw(n)`` gives the actions of ``n`` envs."""
  t0 = time.perf_counter()
  pool.async_reset()
  for _ in range(rounds):
    obs, rew, term, trunc, info = pool.recv()
    ids = info["env_id"]
    pool.send(draw(len(ids)), ids)
  return rounds * pool.config["batch_size"] / (time.perf_counter() - t0)


def host_xla_loop(torch, pool, acts):
  """``pool.reset()`` through the host API, then one eager ``xla()`` step per
  action (card tensors or numpy): each send returns before its host step
  runs (a host function on the stream), and the device is synchronised at
  the end. Returns (card outputs per step, loop s, per-step ms for a send
  to return, the copies' (start, end, bytes), per-step ms of the host step
  itself, timed where the host function runs it)."""
  pool.reset()
  handle, _, _, step = pool.xla()
  inner, host_step_ms = pool._host_step, []

  def timed(action, ids):
    t0 = time.perf_counter()
    cols = inner(action, ids)
    host_step_ms.append(1e3 * (time.perf_counter() - t0))
    return cols

  pool._host_step = timed
  outs, send_ms, events = [], [], []
  try:
    t0 = time.perf_counter()
    for act in acts:
      ts = time.perf_counter()
      handle, out = step(handle, act)
      send_ms.append(1e3 * (time.perf_counter() - ts))
      events.append(pool.last_copy)
      outs.append(out)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
  finally:
    del pool._host_step
  return outs, secs, send_ms, events, host_step_ms


def host_scan(torch, pool, acts):
  """``graph.CapturedScan`` over the ``xla()`` step (``acts`` on the card,
  row ``t`` taken through a device counter): ``pool.reset()``, then one
  call that captures (its warm-up queues no host step) and replays
  ``len(acts)`` steps, under ``set_sync_debug_mode("warn")``: its one
  synchronizing call is the wait after the replays, before the host
  steps' errors are raised (a graph with host nodes makes it), and the
  capture and replays make none. Returns (outputs ``[T, ...]`` per field,
  s of the call, the scan)."""
  import warnings

  from envpool_torch.core import graph

  pool.reset()
  handle, recv, send, _ = pool.xla()

  def body(carry):
    h, t = carry
    h = send(h, acts.index_select(0, t)[0])
    return (h, t + 1), recv(h)[1]

  sc = graph.CapturedScan(body, len(acts))
  t = torch.zeros(1, dtype=torch.int64, device="cuda")
  torch.cuda.synchronize()
  # only the sync warnings, each recorded: an "always" filter for every
  # warning would slow the host step's threads (catching is process-wide)
  with warnings.catch_warnings(record=True) as caught:
    warnings.filterwarnings("always", message="called a synchronizing CUDA operation")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      t0 = time.perf_counter()
      (final, _), outs = sc((handle, t))
    finally:
      torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  secs = time.perf_counter() - t0
  syncs = [str(w.message) for w in caught
           if "called a synchronizing CUDA operation" in str(w.message)]
  if len(syncs) != 1:
    raise AssertionError(f"captured host scan: {len(syncs)} synchronizing calls "
                         f"(the wait after the replays is the one expected): {syncs}")
  if int(final[0]) != len(acts):
    raise AssertionError(f"captured host scan: {int(final[0])} sends counted")
  return outs, secs, sc


def same_scan_as_host(torch, outs, want, keys, tag) -> None:
  """A captured scan's ``[T, ...]`` outputs equal the host API's, bit for
  bit."""
  same_as_host(torch, [[o[t] for o in outs] for t in range(len(want))], want, keys, tag)


def same_as_host(torch, outs, want, keys, tag) -> None:
  """Card outputs equal to the host API's, field by field, bit for bit."""
  for t, (got, ref) in enumerate(zip(outs, want)):
    for k, g, w in zip(keys, got, ref):
      if g.device != torch.device("cuda", 0):
        raise AssertionError(f"{tag} step {t} {k} on {g.device}")
      g = g.cpu().numpy()
      if g.dtype != w.dtype or not np.array_equal(g, w):
        raise AssertionError(f"{tag} step {t} {k}: differs from the host API")


def check_atari_stack(outs, keys) -> dict:
  """The wrapper stack's rules on every lane (``tests/
  test_atari_stack.py``, ``test_torch_atari_stack.py``): every lane lost a
  life and ended a game; after a game over a FIRST step with reward 0 and
  elapsed_step 0; LAST exactly at done; otherwise elapsed_step counts
  steps; a life loss alone ends nothing (episodic_life is off)."""
  col = {k: np.stack([o[keys.index(k)] for o in outs]) for k in (
    "done", "step_type", "elapsed_step", "reward", "info:lives",
    "info:terminated",
  )}
  after_done, game_over = col["done"][:-1], col["info:terminated"][:-1] == 1
  nxt = slice(1, None)
  rules = {
    "every lane lost a life": (col["info:lives"] < 3).any(0).all(),
    "every lane ended a game": game_over.any(0).all(),
    "done only at game over": np.array_equal(after_done, game_over),
    "FIRST after done": (col["step_type"][nxt][after_done] == 0).all(),
    "reward 0 after done": (col["reward"][nxt][after_done] == 0).all(),
    "elapsed 0 after done": (col["elapsed_step"][nxt][after_done] == 0).all(),
    "LAST exactly at done": np.array_equal(col["step_type"] == 2, col["done"]),
    "elapsed counts steps": np.array_equal(
      col["elapsed_step"][nxt][~after_done],
      col["elapsed_step"][:-1][~after_done] + 1),
    "obs shape": outs[0][keys.index("obs")].shape == (HOST_ENVS, 4, 84, 84),
  }
  broken = [k for k, ok in rules.items() if not ok]
  if broken:
    raise AssertionError(f"Atari wrapper stack: {broken}")
  return {"games_ended": int(game_over.sum()), "lives_lost_steps":
          int((np.diff(col["info:lives"], axis=0) < 0).sum())}


def host_registry(torch, envpool_torch, card) -> dict:
  """Every id is listed without mujoco or ale_py; making a MuJoCo host id
  needs mujoco (an ImportError that names it), and where it is installed 8
  envs x 20 steps of each land on the card through ``xla()``."""
  import importlib

  from envpool_torch.core.host_pool import HostEnvPool

  ids = envpool_torch.list_all_envs()
  host = []
  for task_id in ids:
    path, cls = envpool_torch.registration.registry.envpools[task_id]["gymnasium"]
    if issubclass(getattr(importlib.import_module(path), cls), HostEnvPool):
      host.append(task_id)
  try:
    import mujoco  # noqa: F401
    have_mujoco = True
  except ImportError:
    have_mujoco = False
  if len(ids) < 135 or len(host) < 59:
    raise AssertionError(f"registry: {len(ids)} ids, {len(host)} host ids")
  made = {}
  for task_id, n_act in (("Hopper-v4", 3), ("CheetahRun-v1", 6)):
    if not have_mujoco:
      try:
        envpool_torch.make_gymnasium(task_id, num_envs=8, seed=SEED)
      except ImportError as e:
        if "mujoco" not in str(e):
          raise AssertionError(f"{task_id}: {e!r} does not name mujoco")
        made[task_id] = f"ImportError: {e}"
        continue
      raise AssertionError(f"{task_id} was built without mujoco")
    pool = envpool_torch.make_gymnasium(task_id, num_envs=8, seed=SEED)
    handle, _, _, step = pool.xla()
    for _ in range(20):
      handle, out = step(handle, torch.zeros((8, n_act), device="cuda"))
      if any(o.device != torch.device("cuda", 0) for o in out):
        raise AssertionError(f"{task_id}: an xla() output is not on cuda:0")
    made[task_id] = "8 envs x 20 xla() steps on cuda:0"
  log(f"registry: {len(ids)} ids listed ({len(host)} of the host tier), "
      f"mujoco {'present' if have_mujoco else 'absent'}: " +
      "; ".join(f"{t} {r}" for t, r in made.items()) + f" [{card}]")
  return {"ids": len(ids), "host_ids": len(host), "mujoco": have_mujoco,
          "made": made}


def gil_checks(torch, card) -> dict:
  """A host function takes the GIL on CUDA's callback thread, so a call that
  waits for the stream while it holds the GIL never returns once a host
  function is queued before it. Each call below waits behind one (queued
  behind GIL_QUEUE_MS of device work, so it is still pending when the call
  starts) and must return, the host function having run; a call that kept
  the GIL would hang, and the child's timeout fails the script. Then
  GIL_REPLAYS replays of a graph holding a host node, more than the
  launch queue holds, so that ``replay`` itself blocks. Returns ms per
  call."""
  from envpool_torch.core import graph

  dev = torch.device("cuda", 0)
  ran = []
  callback = graph.HOST_FN(lambda data: ran.append(data))
  x = torch.zeros(1, device=dev)
  stream = torch.cuda.current_stream(dev)
  ev = torch.cuda.Event()
  calls = {
    "Tensor.item": lambda: x.item(),
    "Tensor.cpu": lambda: x.cpu(),
    "Event.synchronize": lambda: (ev.record(stream), ev.synchronize()),
    "Stream.synchronize": lambda: stream.synchronize(),
    "torch.cuda.synchronize": lambda: torch.cuda.synchronize(dev),
  }
  res = {}
  for i, (name, call) in enumerate(calls.items()):
    log(f"GIL check: {name} behind a queued host function")
    queue_ahead(torch, GIL_QUEUE_MS)
    graph.launch_host_func(callback, i + 1, dev)
    x.add_(1)
    t0 = time.perf_counter()
    call()
    res[name] = 1e3 * (time.perf_counter() - t0)
    if ran[-1:] != [i + 1]:
      raise AssertionError(f"GIL check {name}: returned before its host function ran")
  g = torch.cuda.CUDAGraph()
  side = torch.cuda.Stream(dev)
  side.wait_stream(stream)
  with torch.cuda.stream(side):
    x.add_(1)
  stream.wait_stream(side)
  with torch.cuda.graph(g, stream=side):
    x.add_(1)
    graph.launch_host_func(callback, 0, dev)
  ran.clear()
  log(f"GIL check: {GIL_REPLAYS} replays of a graph with a host node")
  t0 = time.perf_counter()
  for _ in range(GIL_REPLAYS):
    g.replay()
  res["CUDAGraph.replay"] = 1e3 * (time.perf_counter() - t0) / GIL_REPLAYS
  torch.cuda.synchronize()
  if len(ran) != GIL_REPLAYS:
    raise AssertionError(f"GIL check: {len(ran)} of {GIL_REPLAYS} host nodes ran")
  del g
  log("GIL checks: each call returned with its host function run (it waits "
      "without the GIL): " + ", ".join(f"{k} {v:.2f} ms" for k, v in res.items()) +
      f" (replay: per replay, {GIL_REPLAYS} back to back) [{card}]")
  return res


def host_api_waits(torch, atari, acts, want, keys) -> dict:
  """An eager ``xla()`` send returns before its host step runs; a host-API
  call right after it must wait for that step (it synchronises the device
  first) and see the pool it left: a send queued behind GIL_QUEUE_MS of
  device work, then ``step`` through the host API, whose output must be
  the step loop's next one."""
  pool = scripted_atari_pool(atari, "cuda")
  pool.reset()
  handle, _, _, step = pool.xla()
  queue_ahead(torch, GIL_QUEUE_MS)
  handle, out = step(handle, torch.from_numpy(acts[0]).to("cuda"))
  pending = not pool.last_copy[1].query()
  obs, rew, term, trunc, info = pool.step(acts[1])
  same_as_host(torch, [out], want[1:2], keys, "the send before the host-API call")
  if not np.array_equal(obs, want[2][keys.index("obs")]) or not np.array_equal(
      rew, want[2][keys.index("reward")]):
    raise AssertionError("a host-API step after an eager send ran before it")
  return {"send_pending_at_host_call": pending}


def host_ppo(torch, envpool_torch, atari, card) -> dict:
  """One PPO iteration over the scripted Atari stack (HOST_PPO_ENVS envs,
  the full-width ``AtariCNN``, ``PPOConfig(num_steps=HOST_PPO_STEPS)``):
  captured (the rollout's host steps as host nodes, the update) on one pool
  against the same iteration run eagerly on a twin pool of the same seed,
  from one state: parameters, Adam state, key, handle and metrics bit for
  bit."""
  from envpool_torch.models import AtariCNN
  from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init

  cfg = PPOConfig(num_steps=HOST_PPO_STEPS)
  net = AtariCNN(num_actions=HOST_ACTIONS)
  ends, res = {}, {}
  state0 = tx = None
  for mode in ("eager", "captured"):
    pool = scripted_atari_pool(atari, "cuda", num_envs=HOST_PPO_ENVS)
    if state0 is None:
      state0, tx = ppo_init(pool, net, cfg, seed=SEED)
    step = make_ppo_train_step(pool, net, cfg, tx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = (step.eager if mode == "eager" else step)(state0)
    torch.cuda.synchronize()
    res[f"{mode}_s"] = time.perf_counter() - t0
    ends[mode] = (state, {k: float(v) for k, v in metrics.items()})
    if mode == "captured":
      res.update(rollout_nodes=step._scan.nodes, rollout_host_nodes=step._scan.host_nodes,
                 update_nodes=step._update.nodes)
    del pool, step
  ppo_state_equal(torch, ends["captured"][0], ends["eager"][0], "PPO over the host pool")
  if ends["captured"][1] != ends["eager"][1]:
    raise AssertionError(f"PPO over the host pool: metrics {ends['captured'][1]} "
                         f"against {ends['eager'][1]}")
  if not all(np.isfinite(v) for v in ends["captured"][1].values()):
    raise AssertionError(f"PPO over the host pool: {ends['captured'][1]}")
  res["metrics"] = ends["captured"][1]
  log(f"PPO over the scripted Atari stack ({HOST_PPO_ENVS} envs, AtariCNN, "
      f"{HOST_PPO_STEPS} steps): one iteration captured (rollout graph "
      f"{res['rollout_nodes']} nodes, {res['rollout_host_nodes']} of them host "
      f"nodes; update graph {res['update_nodes']} nodes, capture included "
      f"{res['captured_s']:.2f} s) equal to the eager iteration "
      f"({res['eager_s']:.2f} s) bit for bit [{card}]")
  return res


def host_scan_error(torch, atari, card) -> dict:
  """A captured scan over the ``xla()`` step whose host step fails: the
  call raises after its replays (the graph waits for its stream and
  raises the host function's error), the host steps queued behind the
  failed one do not step the pool, and once raised the graph replays
  again."""
  from envpool_torch.core import graph

  steps = 4
  pool = scripted_atari_pool(atari, "cuda", num_envs=8)
  pool.reset()
  handle, recv, send, _ = pool.xla()
  acts = torch.zeros(8, dtype=torch.int32, device="cuda")

  def body(h):
    h = send(h, acts)
    return h, recv(h)[1][0]

  sc = graph.CapturedScan(body, steps)
  sc(handle)
  calls = []

  def fail(action, ids):
    calls.append(len(calls))
    raise ValueError("a scripted host step failure")

  pool._host_step = fail
  try:
    sc(handle)
  except RuntimeError as e:
    if not isinstance(e.__cause__, ValueError):
      raise AssertionError(f"captured host scan raised {e!r} from {e.__cause__!r}")
  else:
    raise AssertionError("a captured scan whose host step failed did not raise")
  finally:
    del pool._host_step
  if len(calls) != 1:
    raise AssertionError(f"the pool was stepped {len(calls)} times in the failed replays")
  (final, ys) = sc(handle)
  torch.cuda.synchronize()
  if not bool(torch.isfinite(ys.float()).all()):
    raise AssertionError("captured host scan after the failure: non-finite obs")
  log(f"host tier: a captured scan ({steps} steps, {sc.host_nodes} host node) "
      f"whose host step failed raised after its replays, the {steps - 1} host "
      f"steps queued behind it did not step the pool, and the graph replayed "
      f"again once raised [{card}]")
  return {"steps": steps, "failed_calls": len(calls), "raised": True}


def host_tier(torch, envpool_torch, card) -> dict:
  """Phase 16: the host tier's bridge to the card over the Atari stack."""
  from envpool_torch.envs import atari
  from envpool_torch.envs.atari import atari_env

  make_ale = atari_env._make_ale
  atari_env._make_ale = lambda task, seed, rap: ScriptedALE()
  try:
    gil = gil_checks(torch, card)
    rng = np.random.default_rng(SEED + 60)
    acts = rng.integers(0, HOST_ACTIONS, (HOST_STEPS, HOST_ENVS)).astype(np.int32)
    # 1. sync: reset + HOST_STEPS steps through step, the twin of loop 3
    pool = scripted_atari_pool(atari, "cuda")
    keys = pool.spec._state_keys
    want, reset_s, sync_s = host_sync_loop(pool, acts)
    del pool
    stack = check_atari_stack(want, keys)
    # 2. async: batch HOST_ASYNC_BATCH of HOST_ENVS
    pool = scripted_atari_pool(atari, "cuda", batch_size=HOST_ASYNC_BATCH)
    async_sps = host_async_rate(
      pool, HOST_STEPS,
      lambda n: rng.integers(0, HOST_ACTIONS, n).astype(np.int32))
    del pool
    # 3. the eager xla() loop on cuda:0 with the actions on the card, its
    # sends under set_sync_debug_mode("error")
    card_acts = torch.from_numpy(acts).to("cuda")
    pool = scripted_atari_pool(atari, "cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
      outs, xla_s, send_ms, events, host_step_ms = host_xla_loop(torch, pool, card_acts)
    finally:
      torch.cuda.set_sync_debug_mode(0)
    n_bytes = events[-1][2]
    copy_ms = [s.elapsed_time(e) for s, e, _ in events]
    same_as_host(torch, outs, want[1:], keys, "xla() with card actions")
    del outs, pool
    # 4. the xla() loop with the actions on the host (copied to the card
    # first, which waits for the stream)
    pool = scripted_atari_pool(atari, "cuda")
    outs, xla_host_s, send_ms_h, events_h, _ = host_xla_loop(
      torch, pool, acts[:HOST_OVERLAP_STEPS])
    copy_ms_h = [s.elapsed_time(e) for s, e, _ in events_h]
    same_as_host(torch, outs, want[1:], keys, "xla() with host actions")
    del outs, pool
    # 5. graph.scan over the xla() step: captured, host nodes replayed
    pool = scripted_atari_pool(atari, "cuda")
    outs, scan_s, sc = host_scan(torch, pool, card_acts[:HOST_OVERLAP_STEPS])
    same_scan_as_host(torch, outs, want[1:HOST_OVERLAP_STEPS + 1], keys,
                      "captured xla() scan")
    scan = {"steps": HOST_OVERLAP_STEPS, "sps": HOST_OVERLAP_STEPS * HOST_ENVS / scan_s,
            "capture_s": sc.capture_s,
            "instantiate_s": sc.instantiate_s, "nodes": sc.nodes,
            "host_nodes": sc.host_nodes}
    del outs, pool, sc
    scan_error = host_scan_error(torch, atari, card)
    waits = host_api_waits(torch, atari, acts, want, keys)
    ppo = host_ppo(torch, envpool_torch, atari, card)
    registry = host_registry(torch, envpool_torch, card)
  finally:
    atari_env._make_ale = make_ale
    atari_env._action_set_size.cache_clear()
  steps = HOST_STEPS * HOST_ENVS
  step_ms = 1e3 * xla_s / HOST_STEPS
  res = {
    "envs": HOST_ENVS, "steps": HOST_STEPS, "threads": os.cpu_count(), "gil": gil,
    "sync_sps": steps / sync_s, "sync_host_ms_per_step": 1e3 * sync_s / HOST_STEPS,
    "reset_s": reset_s, "async_sps": async_sps,
    "xla_sps": steps / xla_s, "xla_ms_per_step": step_ms,
    "send_ms_mean": float(np.mean(send_ms)),
    "host_step_ms_mean": float(np.mean(host_step_ms)),
    "stream_ms_per_step_beyond_host_step": step_ms - float(np.mean(host_step_ms)),
    "bytes_per_step": n_bytes,
    "copy_ms_mean": float(np.mean(copy_ms)), "copy_ms_max": float(np.max(copy_ms)),
    "copy_gbps": n_bytes / np.mean(copy_ms) / 1e6,
    "xla_host_actions_sps": HOST_OVERLAP_STEPS * HOST_ENVS / xla_host_s,
    "xla_host_actions_send_ms": float(np.mean(send_ms_h)),
    "copy_ms_mean_host_actions": float(np.mean(copy_ms_h)),
    "captured": scan, "captured_host_step_error": scan_error,
    "host_api_after_send": waits, "ppo": ppo,
    **stack, "registry": registry,
  }
  log(f"host tier (Atari stack over a scripted emulator, {HOST_ENVS} envs, "
      f"{os.cpu_count()} threads): step {res['sync_sps']:.1f} env-steps/s "
      f"({res['sync_host_ms_per_step']:.2f} host ms per step, reset "
      f"{reset_s:.2f} s); async batch {HOST_ASYNC_BATCH} {async_sps:.1f} "
      f"env-steps/s; xla() on cuda:0 eager {res['xla_sps']:.1f} env-steps/s "
      f"({step_ms:.2f} ms per step, a send returns in {res['send_ms_mean']:.3f} ms, "
      f"the host step {res['host_step_ms_mean']:.2f} ms); captured by graph.scan "
      f"{scan['sps']:.1f} env-steps/s ({scan['nodes']} nodes, {scan['host_nodes']} "
      f"host nodes; capture {scan['capture_s']:.3f} s) [{card}]")
  log(f"host-to-card copy per step: {n_bytes} B (obs {HOST_ENVS * 4 * 84 * 84} B), "
      f"{res['copy_ms_mean']:.4f} ms mean / {res['copy_ms_max']:.4f} max by CUDA "
      f"events ({res['copy_gbps']:.2f} GB/s); a step takes "
      f"{res['stream_ms_per_step_beyond_host_step']:.3f} ms of stream time past "
      f"its host step (the copies in and out and the launch gaps, which the "
      f"next host step now waits for in stream order); with host actions "
      f"{res['xla_host_actions_sps']:.1f} env-steps/s, a send returns in "
      f"{res['xla_host_actions_send_ms']:.2f} ms [{card}]")
  log(f"host tier checks: every output of both eager xla() loops ({HOST_STEPS} "
      f"and {HOST_OVERLAP_STEPS} steps) and of the captured scan "
      f"({HOST_OVERLAP_STEPS} steps) equal to the "
      f"host API's, every field bit for bit, on cuda:0; eager sends under "
      f"set_sync_debug_mode('error'); a host-API step after a pending send "
      f"(pending: {waits['send_pending_at_host_call']}) waited for it; "
      f"{stack['games_ended']} games ended, every lane lost a life and ended "
      f"a game, the override rules held")
  return res


def host_tier_child(path: str) -> int:
  """Phase 16 in a process of its own, under the parent's timeout: a host
  function that never runs (a GIL deadlock) fails the script instead of
  hanging it; the results written to ``path`` (JSON)."""
  import torch

  if not torch.cuda.is_available():
    raise RuntimeError("phase 16 needs a CUDA device")
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  import envpool_torch

  res = host_tier(torch, envpool_torch, card_line())
  with open(path, "w") as f:
    json.dump(res, f)
  return 0


def run_host_tier(card, scratch: str) -> dict:
  """Phase 16's child process, stopped at HOST_CHILD_TIMEOUT s."""
  path = os.path.join(scratch, "host_tier.json")
  if os.path.exists(path):
    os.remove(path)
  proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--host-tier", path],
                        timeout=HOST_CHILD_TIMEOUT)
  if proc.returncode != 0:
    raise AssertionError(f"phase 16's child exited {proc.returncode}")
  with open(path) as f:
    return json.load(f)


# --------------------------------------------------------------- phase 17

# the last host families over scripted wheels (the card's machine has
# neither procgen nor vizdoom, and nothing may be installed there): a child
# process (--wheel-families) puts the scripted modules in place before it
# imports envpool_torch, so the registry lists their ids and the pools come
# from make_gymnasium as a user's would. 256 envs on as many threads as the
# host has cores. procgen: BigfishHard-v0 (64x64x3, channel-first), reset +
# PROCGEN_STEPS steps through step, an async pool (batch 64) for as many
# rounds, the xla() loop on cuda:0 for as many steps. ViZDoom at the JAX package's
# defaults (84x84, stack 4, frame_skip 4; 3-channel 160x120 screens), both
# action modes, the same loops cut in depth to VIZDOOM_STEPS, which end
# every episode twice (at steps 15 and 31): an env-step costs the port's
# area resize of three 160x120 channels (the JAX package's numpy einsum),
# about 5 times a procgen env-step on the host
WHEEL_ENVS = 256
WHEEL_ASYNC_BATCH = 64
WHEEL_SCAN_STEPS = 25  # procgen's steps through graph.CapturedScan
PROCGEN_ID = "BigfishHard-v0"
PROCGEN_STEPS = 100  # an episode every 9 acts (200 until the captured checks came)
VIZDOOM_ID = "VizdoomCustom-v1"
VIZDOOM_STEPS = 32
DOOM_BUTTONS = ("MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT", "ATTACK")
DOOM_VARS = ("HEALTH", "KILLCOUNT", "FRAGCOUNT", "DEATHCOUNT", "HITCOUNT",
             "DAMAGECOUNT", "ARMOR")
# the port's examples, each in a child process on the card: the PPO scripts
# at their defaults for 2 iterations, xla_step as it is. async_loop steps
# Ant-v4, which needs mujoco: the card's machine has none, so only the CPU
# test runs it (tests/test_torch_examples.py)
EXAMPLES = (
  ("ppo_sokoban", ("--iterations", "2"), 2),
  ("ppo_mujoco", ("--iterations", "2"), 2),
  ("xla_step", (), 1),
  ("cleanrl_ppo", ("--iterations", "1", "--num-steps", "32"), 1),
  ("sb3_example", (), 1),
  ("tianshou_example", (), 1),
  ("acme_example", (), 4),
)
# an example that needs a module the card's machine may lack (the port's dm
# dialect imports dm_env); without it the example is not run, and says so
EXAMPLE_NEEDS = {"acme_example": "dm_env"}


class ScriptedProcgenGame:
  """A gym3 game with ``tests/test_procgen_stack.py``'s ``FakeProcgenGame``
  rules: the act counter painted into the 64x64x3 screen (the level seed
  in one pixel), an episode every 9 acts, reward = the action, the level
  seed advancing by 100 at each episode's end."""

  def __init__(self, num=1, env_name="bigfish", rand_seed=0, **kwargs):
    assert num == 1
    self.t = 0
    self.level_seed = rand_seed
    self.prev_level_seed = -1
    self.prev_complete = 0
    self.last_rew = 0.0
    self.first = True

  def observe(self):
    frame = np.full((64, 64, 3), self.t % 256, np.uint8)
    frame[0, 0, 0] = self.level_seed % 256
    return (np.asarray([self.last_rew], np.float32), {"rgb": frame[None]},
            np.asarray([self.first], bool))

  def act(self, action):
    self.t += 1
    self.last_rew = float(np.asarray(action).ravel()[0])
    self.first = self.t % 9 == 0
    if self.first:
      self.prev_level_seed = self.level_seed
      self.prev_complete = 1
      self.level_seed += 100

  def get_info(self):
    return [{"prev_level_seed": self.prev_level_seed,
             "prev_level_complete": self.prev_complete,
             "level_seed": self.level_seed}]


class _DoomState:
  def __init__(self, buf):
    self.screen_buffer = buf


class _DoomButton:
  def __init__(self, name):
    self.name = name


class ScriptedDoomGame:
  """A DoomGame with ``tests/test_vizdoom_stack.py``'s ``FakeDoomGame``
  rules: 3-channel 160x120 screens holding the tic counter, four buttons,
  HEALTH 100 - 2 per tic, KILLCOUNT one per 5 tics, dead from tic 40, the
  episode over at tic 60."""

  def __init__(self):
    self.tic = 0

  def _configure(self, *args):
    pass

  load_config = set_doom_scenario_path = set_doom_game_path = _configure
  set_doom_map = add_game_args = set_window_visible = _configure
  set_mode = set_seed = init = _configure

  def get_screen_channels(self):
    return 3

  def get_available_buttons(self):
    return [_DoomButton(b) for b in DOOM_BUTTONS]

  def new_episode(self, path=None):
    self.tic = 0

  def get_state(self):
    return _DoomState(np.full((3, 120, 160), self.tic % 256, np.uint8))

  def make_action(self, buttons, skip):
    self.tic += skip

  def is_episode_finished(self):
    return self.tic >= 60

  def is_player_dead(self):
    return 40 <= self.tic < 60

  def get_game_variable(self, gv):
    if gv == "HEALTH":
      return 100.0 - 2.0 * self.tic
    if gv == "KILLCOUNT":
      return float(self.tic // 5)
    return 0.0


def install_scripted_wheels() -> None:
  """Scripted ``procgen`` and ``vizdoom`` modules in ``sys.modules`` (no
  bundled scenario: ViZDoom registers only ``VizdoomCustom-v1``)."""
  import types

  procgen = types.ModuleType("procgen")
  procgen.ProcgenGym3Env = ScriptedProcgenGame
  vizdoom = types.ModuleType("vizdoom")
  vizdoom.DoomGame = ScriptedDoomGame
  vizdoom.Mode = types.SimpleNamespace(PLAYER=0)
  # a game variable is its own name, which get_game_variable reads
  vizdoom.GameVariable = types.SimpleNamespace(**{v: v for v in DOOM_VARS})
  vizdoom.scenarios_path = ""
  sys.modules["procgen"], sys.modules["vizdoom"] = procgen, vizdoom


def spy_sends(pool) -> list:
  """Record (dtype, shape) of every action array ``_send`` hands to the
  workers."""
  seen, send = [], pool._send

  def spy(action_list):
    a = np.asarray(dict(zip(pool._action_keys, action_list))["action"])
    seen.append((a.dtype, a.shape))
    return send(action_list)

  pool._send = spy
  return seen


def check_host_episodes(outs, keys, tag) -> int:
  """The pool's common fields over a host family's run: every lane ended
  an episode; after a done step a FIRST step with reward 0 and
  elapsed_step 0; LAST exactly at done; otherwise elapsed_step counts
  steps; every reward finite. Returns the episodes ended."""
  col = {k: np.stack([o[keys.index(k)] for o in outs])
         for k in ("done", "step_type", "elapsed_step", "reward")}
  after, nxt = col["done"][:-1], slice(1, None)
  rules = {
    "every lane ended an episode": after.any(0).all(),
    "FIRST after done": (col["step_type"][nxt][after] == 0).all(),
    "reward 0 after done": (col["reward"][nxt][after] == 0).all(),
    "elapsed 0 after done": (col["elapsed_step"][nxt][after] == 0).all(),
    "LAST exactly at done": np.array_equal(col["step_type"] == 2, col["done"]),
    "elapsed counts steps": np.array_equal(
      col["elapsed_step"][nxt][~after], col["elapsed_step"][:-1][~after] + 1),
    "rewards finite": np.isfinite(col["reward"]).all(),
  }
  broken = [k for k, ok in rules.items() if not ok]
  if broken:
    raise AssertionError(f"{tag}: {broken}")
  return int(after.sum())


def wheel_cell(torch, envpool_torch, task_id, card_acts, draw, tag, card,
               captured=False, **kw):
  """One host family over its scripted wheel at ``WHEEL_ENVS`` envs: reset
  + a step per row of ``card_acts`` (read back to the host) through
  ``step``; an async pool (batch ``WHEEL_ASYNC_BATCH``) for as many rounds,
  its actions from ``draw``; the eager ``xla()`` loop on cuda:0 with the
  actions on the card and, with ``captured``, ``graph.CapturedScan`` over
  the same step (host nodes), every output bit for bit against the
  ``step`` loop's. The actions reach the workers in the spec's dtype and
  shape on every path."""

  def make(**extra):
    return envpool_torch.make_gymnasium(
      task_id, num_envs=WHEEL_ENVS, seed=SEED,
      num_threads=os.cpu_count(), **kw, **extra)

  acts = card_acts.cpu().numpy()
  steps = len(acts)
  pool = make()
  spec = pool.spec.action_array_spec["action"]
  want_act = (spec.dtype, (WHEEL_ENVS, *spec.static_shape))
  keys = pool.spec._state_keys
  seen = spy_sends(pool)
  want, reset_s, sync_s = host_sync_loop(pool, acts)
  del pool
  episodes = check_host_episodes(want, keys, tag)
  pool = make(batch_size=WHEEL_ASYNC_BATCH)
  async_sps = host_async_rate(pool, steps, draw)
  del pool
  pool = make()
  seen_xla = spy_sends(pool)
  outs, xla_s, send_ms, events, host_step_ms = host_xla_loop(torch, pool, card_acts)
  same_as_host(torch, outs, want[1:], keys, f"{tag} xla()")
  seen_scan, scan = [want_act] * WHEEL_SCAN_STEPS, None
  if captured:
    pool = make()
    seen_scan = spy_sends(pool)
    souts, scan_s, sc = host_scan(torch, pool, card_acts[:WHEEL_SCAN_STEPS])
    same_scan_as_host(torch, souts, want[1:WHEEL_SCAN_STEPS + 1], keys,
                      f"{tag} captured xla() scan")
    scan = {"steps": WHEEL_SCAN_STEPS, "sps": WHEEL_SCAN_STEPS * WHEEL_ENVS / scan_s,
            "capture_s": sc.capture_s,
            "nodes": sc.nodes, "host_nodes": sc.host_nodes}
    del souts, sc
  if seen != [want_act] * steps or seen_xla != [want_act] * steps or (
      seen_scan != [want_act] * WHEEL_SCAN_STEPS):
    raise AssertionError(f"{tag}: actions reached the workers as {set(seen)} / "
                         f"{set(seen_xla)} / {set(seen_scan)}, not {want_act}")
  out_dtypes = {k: str(o.dtype) for k, o in zip(keys, outs[0])}
  del outs, pool
  n_bytes = events[-1][2]
  copy_ms = [s.elapsed_time(e) for s, e, _ in events]
  obs_bytes = int(np.prod(want[0][keys.index("obs")].shape))
  step_ms = 1e3 * xla_s / steps
  res = {
    "task_id": task_id, **{k: str(v) for k, v in kw.items()},
    "envs": WHEEL_ENVS, "steps": steps, "threads": os.cpu_count(),
    "action": f"{want_act[0]} {list(want_act[1])}", "episodes": episodes,
    "sync_sps": steps * WHEEL_ENVS / sync_s,
    "sync_host_ms_per_step": 1e3 * sync_s / steps, "reset_s": reset_s,
    "async_sps": async_sps, "xla_sps": steps * WHEEL_ENVS / xla_s,
    "xla_ms_per_step": step_ms, "send_ms_mean": float(np.mean(send_ms)),
    "host_step_ms_mean": float(np.mean(host_step_ms)),
    "stream_ms_per_step_beyond_host_step": step_ms - float(np.mean(host_step_ms)),
    "bytes_per_step": n_bytes, "obs_bytes_per_step": obs_bytes,
    "copy_ms_mean": float(np.mean(copy_ms)), "copy_ms_max": float(np.max(copy_ms)),
    "copy_gbps": n_bytes / np.mean(copy_ms) / 1e6,
    "out_dtypes": out_dtypes, "captured": scan,
  }
  scan_text = "" if scan is None else (
    f"; captured by graph.scan {scan['sps']:.1f} env-steps/s ({scan['nodes']} "
    f"nodes, {scan['host_nodes']} host nodes), bit for bit")
  log(f"{tag} ({WHEEL_ENVS} envs, {os.cpu_count()} threads, {steps} steps, "
      f"actions {res['action']}): step {res['sync_sps']:.1f} env-steps/s "
      f"({res['sync_host_ms_per_step']:.2f} host ms per step, reset "
      f"{reset_s:.3f} s); async batch {WHEEL_ASYNC_BATCH} {async_sps:.1f} "
      f"env-steps/s; xla() on cuda:0 {res['xla_sps']:.1f} env-steps/s "
      f"({step_ms:.2f} ms per step, the host step {res['host_step_ms_mean']:.2f} "
      f"ms){scan_text} [{card}]")
  log(f"{tag} host-to-card copy per step: {n_bytes} B (obs {obs_bytes} B), "
      f"{res['copy_ms_mean']:.4f} ms mean / {res['copy_ms_max']:.4f} max by "
      f"CUDA events ({res['copy_gbps']:.2f} GB/s); "
      f"{res['stream_ms_per_step_beyond_host_step']:.3f} ms of stream time per "
      f"step past the host step; every xla() output on cuda:0 equal to the "
      f"host API's, bit for bit; {episodes} episodes ended, the override "
      f"rules held [{card}]")
  return res


def wheel_families(path: str) -> int:
  """Phase 17's host families, in a process of their own (the scripted
  wheels must be in place before envpool_torch is imported); the results
  written to ``path`` (JSON)."""
  install_scripted_wheels()
  import torch

  if not torch.cuda.is_available():
    raise RuntimeError("phase 17 needs a CUDA device")
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  import envpool_torch
  from envpool_torch.envs.vizdoom import vizdoom_env
  from envpool_torch.envs.vizdoom.action_set import build_action_set

  card = card_line()
  ids = envpool_torch.list_all_envs()
  procgen_ids = [t for t in ids if envpool_torch.registration.registry.specs[t][0]
                 == "envpool_torch.envs.procgen"]
  if len(procgen_ids) != 42 or VIZDOOM_ID not in ids:
    raise AssertionError(f"registry: {len(procgen_ids)} procgen ids, "
                         f"{VIZDOOM_ID} {'in' if VIZDOOM_ID in ids else 'missing'}")
  gen = torch.Generator(device="cuda")
  gen.manual_seed(SEED + 70)
  rng = np.random.default_rng(SEED + 71)
  res = {"ids": len(ids), "procgen_ids": len(procgen_ids)}
  res["procgen"] = wheel_cell(
    torch, envpool_torch, PROCGEN_ID,
    torch.randint(0, 15, (PROCGEN_STEPS, WHEEL_ENVS), device="cuda",
                  generator=gen, dtype=torch.int32),
    lambda n: rng.integers(0, 15, n).astype(np.int32), "procgen " + PROCGEN_ID, card,
    captured=True)
  buttons = len(DOOM_BUTTONS)
  res["vizdoom_buttons"] = wheel_cell(
    torch, envpool_torch, VIZDOOM_ID,
    2 * torch.rand((VIZDOOM_STEPS, WHEEL_ENVS, buttons), device="cuda",
                   generator=gen, dtype=torch.float64) - 1,
    lambda n: rng.uniform(-1, 1, (n, buttons)), f"ViZDoom {VIZDOOM_ID} buttons", card)
  n_combined = len(build_action_set(DOOM_BUTTONS))
  res["vizdoom_combined"] = wheel_cell(
    torch, envpool_torch, VIZDOOM_ID,
    torch.randint(0, n_combined, (VIZDOOM_STEPS, WHEEL_ENVS), device="cuda",
                  generator=gen, dtype=torch.int32),
    lambda n: rng.integers(0, n_combined, n).astype(np.int32),
    f"ViZDoom {VIZDOOM_ID} combined ({n_combined} actions)", card,
    use_combined_action=True)
  vizdoom_env._screen_channels.cache_clear()
  vizdoom_env._available_buttons.cache_clear()
  with open(path, "w") as f:
    json.dump(res, f)
  return 0


def run_examples(card, scratch: str) -> dict:
  """Every example of ``EXAMPLES`` in a child process on the card, all at
  once (each one's seconds are its process's wall time beside the others;
  its output goes to files under ``scratch``): exit 0, the expected lines,
  every number in them finite."""
  import importlib.util
  import re

  root = os.path.dirname(os.path.abspath(__file__))
  missing = {name: mod for name, mod in EXAMPLE_NEEDS.items()
             if importlib.util.find_spec(mod) is None}
  for name, mod in missing.items():
    log(f"example {name} not run: {mod} is not installed on this machine [{card}]")
  examples = [e for e in EXAMPLES if e[0] not in missing]
  number = re.compile(r"[-+]?(?:nan|inf|\d[\d,]*\.?\d*(?:e[-+]?\d+)?)")
  files = {name: [os.path.join(scratch, f"example_{name}.{s}") for s in ("out", "err")]
           for name, _, _ in examples}
  t0 = time.perf_counter()
  procs = {}
  try:
    for name, args, _ in examples:
      with open(files[name][0], "w") as out, open(files[name][1], "w") as err:
        procs[name] = subprocess.Popen(
          [sys.executable, "-m", f"envpool_torch.examples.{name}", *args],
          cwd=root, stdout=out, stderr=err)
    ended = {}
    while len(ended) < len(procs):
      if time.perf_counter() - t0 > 600:
        raise AssertionError(f"examples still running after 600 s: "
                             f"{sorted(set(procs) - set(ended))}")
      for name, proc in procs.items():
        if name not in ended and proc.poll() is not None:
          ended[name] = time.perf_counter() - t0
      time.sleep(0.05)
  finally:
    for proc in procs.values():
      if proc.poll() is None:
        proc.kill()
        proc.wait()
  res = {name: {"not_run": f"{mod} is not installed"} for name, mod in missing.items()}
  for name, args, n_lines in examples:
    returncode, seconds = procs[name].returncode, ended[name]
    with open(files[name][0]) as f:
      lines = f.read().strip().splitlines()
    with open(files[name][1]) as f:
      stderr = f.read()
    for line in lines:
      log(f"  {name}: {line}")
    if returncode != 0:
      raise AssertionError(f"example {name} exited {returncode}: {stderr[-4000:]}")
    values = [float(v.replace(",", "")) for line in lines
              for v in number.findall(line.split(":", 1)[-1])]
    if len(lines) != n_lines or not values or not np.isfinite(values).all():
      raise AssertionError(f"example {name}: {lines}")
    log(f"example {name} {' '.join(args)}: {seconds:.1f} s, exit 0, "
        f"{len(values)} numbers all finite [{card}]")
    res[name] = {"args": list(args), "seconds": seconds, "lines": lines}
  return res


def last_host_families(torch, card, scratch: str) -> dict:
  """Phase 17: procgen and ViZDoom over scripted wheels (a child process),
  then the examples."""
  path = os.path.join(scratch, "wheel_families.json")
  if os.path.exists(path):
    os.remove(path)
  t0 = time.perf_counter()
  proc = subprocess.run(
    [sys.executable, os.path.abspath(__file__), "--wheel-families", path],
    timeout=900)
  if proc.returncode != 0:
    raise AssertionError(f"phase 17's child exited {proc.returncode}")
  with open(path) as f:
    res = json.load(f)
  res["families_s"] = time.perf_counter() - t0
  res["examples"] = run_examples(card, scratch)
  return res

# --------------------------------------------------------------- phase 18

# id -> (envs, steps, make kwargs): the compiled rollout of each device
# family at its chip_smoke width. CheetahJaxRun-v1 and PusherJax-v4 get a cap
# of 2 steps so that every lane resets twice inside the captured rollout of
# 6 steps (a cap of 4 and 10 steps until the host bridge's checks came),
# through the IF node (Pusher's reset through its WHILE node);
# BipedalWalkerHardcore-v3 runs 25 steps (50) and HumanoidCMUJaxRun-v1 2 (3)
CAPTURED = {
  "CartPole-v1": (8192, 200, {}),
  "Sokoban-v0": (SOKOBAN_ENVS, 100, SOKOBAN_KW),
  "CarRacing-v2": (N_ENVS, 50, {}),
  "Blackjack-v1": (SMALL_ENVS, 50, {}),
  "PongJaxDemo-v5": (PONG_ENVS, 50, {}),
  "LunarLander-v2": (BOX2D_ENVS, 50, {}),
  "BipedalWalkerHardcore-v3": (BOX2D_ENVS, 25, {}),
  "HalfCheetahJax-v4": (4096, 10, {}),
  "PusherJax-v4": (4096, 6, dict(max_episode_steps=2)),
  "CheetahJaxRun-v1": (4096, 6, dict(max_episode_steps=2)),
  "HumanoidCMUJaxRun-v1": (1024, 2, {}),
}
COND_NODES_PER_TIMING = 1024  # set-handle kernels (and skipped IF nodes) timed per replay
COND_WIDTHS = (1, SOKOBAN_ENVS)
COND_TURNS = 4  # timed runs of each node kind, in turns (replays vary by up to 2x)
COUNTED_ROUNDS = 198  # dmc cheetah's settle loop: 200 substeps, 2 outside the loop
# the most nodes that conditional bodies may run in a traced replay: the
# card's tracer faulted on a graph whose bodies ran 405k kernels in one
# launch, and not on 203k (tools/graph_cond_fault.py)
TRACE_BODY_NODES = 200_000


def captured_actions(envpool_torch, task_id: str, steps: int, n: int) -> np.ndarray:
  """The id's actions of phases 4-14: uniform in its action space."""
  seed = SEED + 50
  if task_id == "CarRacing-v2":
    rng = np.random.default_rng(seed)
    return np.stack([random_actions(rng, n) for _ in range(steps)])
  if task_id == "Sokoban-v0":
    return sokoban_actions(seed, steps, n)
  if task_id in BOX2D_IDS:
    return box2d_actions(task_id, seed, steps, n)
  spec = envpool_torch.make_spec(task_id).action_array_spec["action"]
  if np.issubdtype(spec.dtype, np.integer):
    return small_actions(seed, steps, n, int(spec.maximum) + 1)
  return mujoco_actions(envpool_torch, task_id, seed, steps, n)


def bit_equal(torch, got, want, tag: str) -> None:
  """Equal leaf by leaf through dicts and tuples, NaN equal to NaN."""
  from envpool_torch.core.graph import tree_map

  def eq(g, w):
    if g.shape != w.shape or g.dtype != w.dtype or not (
        torch.equal(g, w) or (g.is_floating_point() and bool(
          ((g == w) | (torch.isnan(g) & torch.isnan(w))).all()))):
      raise AssertionError(f"{tag}: captured differs from eager")

  tree_map(eq, got, want)


def one_hot(torch, n: int, i: int):
  pred = torch.zeros(n, dtype=torch.bool, device="cuda")
  pred[i] = True
  return pred


def cond_predicates(torch) -> dict:
  """The `any` form's cases: none, all, the last and 1% of 1 and of 16384
  lanes (the pool's widths); none, the first and the last of 15, 16, 17
  and 16383 lanes (the vector loads' head and tail); and ``pred[1:]`` of
  16385, a view one byte past a 16-byte boundary, with none, its first, a
  middle and its last lane set."""
  gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
  preds = {}
  for n in COND_WIDTHS:
    preds[f"none of {n}"] = torch.zeros(n, dtype=torch.bool, device="cuda")
    preds[f"all of {n}"] = torch.ones(n, dtype=torch.bool, device="cuda")
    preds[f"the last of {n}"] = one_hot(torch, n, n - 1)
    preds[f"1% of {n}"] = torch.rand(n, generator=gen, device="cuda") < 0.01
  for n in (15, 16, 17, 16383):
    preds[f"none of {n}"] = torch.zeros(n, dtype=torch.bool, device="cuda")
    preds[f"the first of {n}"] = one_hot(torch, n, 0)
    preds[f"the last of {n}"] = one_hot(torch, n, n - 1)
  base = torch.zeros(16385, dtype=torch.bool, device="cuda")
  preds["none of pred[1:] of 16385"] = base[1:]
  for name, i in (("the first", 1), ("lane 8000", 8001), ("the last", 16384)):
    preds[f"{name} of pred[1:] of 16385"] = one_hot(torch, 16385, i)[1:]
  for name, pred in preds.items():
    if "pred[1:]" in name and pred.data_ptr() % 16 != 1:
      raise AssertionError(f"{name}: the view is aligned, {pred.data_ptr() % 16}")
  return preds


def counted_rounds(torch, graph, n: int) -> int:
  """The rounds a WHILE node runs under the counted form's plain version,
  from a counter at 0; the counter must end at 0 again."""
  counter = torch.zeros(1, dtype=torch.int32, device="cuda")
  more, rounds = bool(counter < n), 0
  while more:
    rounds += 1
    counter, more = graph.set_counted_plain(counter, n)
    more = bool(more)
  if int(counter) != 0:
    raise AssertionError(f"the plain counted form left its counter at {int(counter)}")
  return rounds


def check_counted(torch, graph) -> int:
  """``fori_loop``'s counted form against its plain version: for n in 1, 2,
  3 and 198, a loop at the top of the step (behind memory the step wrote
  and freed), one in each of 3 rounds of a WHILE body, one in a taken IF
  body and one in a skipped one, each adding 1 per round; two replays per
  call, two calls. Returns the largest error against the counts that the
  plain version gives."""
  on = torch.ones(1, dtype=torch.bool, device="cuda")
  off = torch.zeros(1, dtype=torch.bool, device="cuda")
  err = 0
  for n in (1, 2, 3, COUNTED_ROUNDS):
    def add_n(v, n=n):
      return graph.fori_loop(n, lambda d: d + 1, v)

    def body(x, add_n=add_n):
      # freed blocks written by the step: the graph may place its own
      # allocations there, so a loop's counter must not come from it
      a, b = torch.full_like(x, 1 << 20), torch.full_like(x, 1 << 20)
      del a, b
      top = add_n(x)
      nested, _ = graph.while_loop(lambda c: c[1] < 3,
                                   lambda c: (add_n(c[0]), c[1] + 1), (x, x))
      taken = graph.cond(on, add_n, lambda v: v, x)
      skipped = graph.cond(off, add_n, lambda v: v, x)
      return x, torch.cat([top, nested, taken, skipped])

    rounds = counted_rounds(torch, graph, n)
    want = torch.tensor([[rounds, 3 * rounds, rounds, 0]] * 2, dtype=torch.int32,
                        device="cuda")
    sc = graph.CapturedScan(body, 2)
    for _ in range(2):
      _, ys = sc(torch.zeros(1, dtype=torch.int32, device="cuda"))
      err = max(err, int((ys - want).abs().max()))
  return err


def us_or_not(ms) -> str:
  return "not measured (no trace record)" if ms is None else f"{1e3 * ms:.3f} us"


def check_pooled_streams(torch, graph) -> int:
  """A scan whose step holds an IF node with a counted loop in its body,
  captured 33 times: each ``CapturedScan`` captures on a side stream from
  ``torch.cuda.Stream()``, which hands out PyTorch's 32 pooled streams in
  turn. Body streams taken from that pool became a later capture's side
  stream, and beginning a body on them failed. Returns the captures."""
  pred = torch.ones(1, dtype=torch.bool, device="cuda")

  def body(x):
    y = graph.cond(pred, lambda v: graph.fori_loop(2, lambda u: u + 1, v + 1),
                   lambda v: v, x)
    return y, y

  x = torch.zeros(1, dtype=torch.int32, device="cuda")
  captures = 33
  for _ in range(captures):
    x, _ = graph.CapturedScan(body, 1)(x)
  if int(x) != 3 * captures:
    raise AssertionError(f"pooled streams: {int(x)} != {3 * captures}")
  return captures


def node_graph(torch, graph, per_node, count: int):
  """A CUDA graph of ``count`` calls of ``per_node(g)``, captured with the
  port's conditional nodes enabled; returns (graph, its capture record)."""
  g = torch.cuda.CUDAGraph()
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with graph._capture_into(g, side) as cap:
    for _ in range(count):
      per_node(g)
  torch.cuda.synchronize()
  return g, cap


def time_nodes(torch, graph, per_node, count: int, kernels=()) -> dict:
  """One replay of ``count`` nodes: ms per node by CUDA events over 20
  replays (a replay outlasts its host overhead, so no queue); with
  ``kernels``, then one replay traced with CUDA activity only: device us
  per node, the replay's launches and, for each name in ``kernels``, its
  launches and device us per launch."""
  g, cap = node_graph(torch, graph, per_node, count)
  res = {"ms": time_cuda(torch, g.replay, reps=20, queue=False) / count}
  if kernels:
    busy_us, rows = profile_call(torch, g.replay)
    res.update(device_us=busy_us / count, launches=int(sum(r[2] for r in rows)),
               launches_by_name={r[0][:60]: int(r[2]) for r in rows})
    for name in kernels:
      hits = [r for r in rows if name in r[0]]
      launches = sum(r[2] for r in hits)
      res[name] = {"launches": launches,
                   "us": sum(r[1] for r in hits) / launches if launches else None}
  g.reset()
  cap.release()
  return res


def check_set_conditional(torch, card) -> dict:
  """Both forms of the set kernel against their plain versions, through IF
  and WHILE nodes (``cond_predicates``, ``check_counted``); then, in turns
  at 1 and 16384 lanes, COND_TURNS replays of COND_NODES_PER_TIMING nodes
  each:
  (a) the `any` kernel and its skipped IF node, and ``graph.cond``'s node
  (the operands' clone in front of both); (b) PyTorch's own IF node
  over ``pred.any()``, the library yardstick, where the card's PyTorch has
  ``CUDAGraph.begin_capture_to_if_node``; (c) an empty kernel in front of
  the same skipped node, the floor of any one-launch design; and (d) an
  empty-bodied loop of 198 rounds with its counter carried through
  ``while_loop`` (four launches a round) and in the counted form (one)."""
  from envpool_torch.core import graph

  preds = cond_predicates(torch)
  err = 0
  for name, pred in preds.items():
    def body(x, pred=pred):
      y = graph.cond(pred, lambda v: v + 1, lambda v: v, x)
      z = graph.while_loop(lambda c: pred & (c < 3), lambda c: c + 1,
                           torch.zeros_like(x))
      return x, (y, z)
    sc = graph.CapturedScan(body, 1)
    _, (y, z) = sc(torch.zeros(1, dtype=torch.int32, device="cuda"))
    want = graph.set_conditional_plain(pred).to(torch.int32)
    err = max(err, int((y[0, 0] - want).abs()), int((z[0, 0] - 3 * want).abs()))
  if err:
    raise AssertionError(f"set_conditional disagrees with pred.any() by {err}")
  counted_err = check_counted(torch, graph)
  if counted_err:
    raise AssertionError(f"the counted form disagrees with its plain version by "
                         f"{counted_err}")
  pooled = check_pooled_streams(torch, graph)
  log(f"set_conditional (csrc/graph_cond.cu): the `any` form equals pred.any() "
      f"on {len(preds)} predicates ({', '.join(preds)}) through IF and WHILE "
      f"nodes; the counted form equals its plain version in fori_loops of 1, 2, "
      f"3 and {COUNTED_ROUNDS} rounds at the top, in 3 rounds of a WHILE body "
      f"and in taken and skipped IF bodies, two replays of two calls; nested "
      f"bodies captured on each of {pooled} pooled streams in turn")

  has_lib = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
  if not has_lib:
    log(f"library yardstick: torch {torch.__version__}'s CUDAGraph has no "
        f"begin_capture_to_if_node: library_ms null")
  x = torch.zeros(1, dtype=torch.int32, device="cuda")
  names = ("set_any_kernel", "set_counted_kernel", "empty_kernel")
  widths = {}
  for n in COND_WIDTHS:
    pred = torch.zeros(n, dtype=torch.bool, device="cuda")

    def port_node(_g, pred=pred):
      with graph._conditional_body(graph._IF, graph._ANY, pred, pred.numel()):
        x.add_(1)

    def floor_node(_g, pred=pred):
      with graph._conditional_body(graph._IF, graph._EMPTY, pred, pred.numel()):
        x.add_(1)

    def cond_node(_g, pred=pred):
      graph.cond(pred, lambda v: v + 1, lambda v: v, x)

    def lib_node(g, pred=pred):
      g.begin_capture_to_if_node(pred.any())
      x.add_(1)
      g.end_capture_to_conditional_node()

    r = {}
    for turn in ("a", "b", "c", "cond") * COND_TURNS:
      if turn == "b" and not has_lib:
        continue
      per_node = {"a": port_node, "b": lib_node, "c": floor_node,
                  "cond": cond_node}[turn]
      # the first run of (a) and of (b) is also traced
      traced = names if turn not in r and turn in ("a", "b") else ()
      r.setdefault(turn, []).append(
        time_nodes(torch, graph, per_node, COND_NODES_PER_TIMING, traced))
    traced_a = r["a"][0]
    pick = {k: min(v, key=lambda t: t["ms"]) for k, v in r.items()}
    plain_ms = time_cuda(torch, lambda: graph.set_conditional_plain(pred), reps=200)
    res = {
      "node_ms": pick["a"]["ms"], "node_runs": [t["ms"] for t in r["a"]],
      "kernel_ms": (None if traced_a["set_any_kernel"]["us"] is None
                    else 1e-3 * traced_a["set_any_kernel"]["us"]),
      "trace": {k: v for k, v in traced_a.items() if k != "ms"},
      "floor_ms": pick["c"]["ms"], "floor_runs": [t["ms"] for t in r["c"]],
      "library_ms": pick["b"]["ms"] if has_lib else None,
      "library_runs": [t["ms"] for t in r.get("b", [])],
      "library_device_us": r["b"][0]["device_us"] if has_lib else None,
      "ms": pick["cond"]["ms"], "ms_runs": [t["ms"] for t in r["cond"]],
      "plain_ms": plain_ms,
      "bound_ms": 1e3 * n / HBM_BYTES_PER_S, "bound_by": "bytes",
    }
    widths[n] = res
    lib = (f"{1e3 * res['library_ms']:.3f} us (runs "
           f"{', '.join(f'{1e3 * t:.3f}' for t in res['library_runs'])}; device "
           f"{res['library_device_us']:.3f} us per node)") if has_lib else "null"
    log(f"set_conditional at {n} lanes, {COND_NODES_PER_TIMING} skipped IF nodes "
        f"per replay: (a) kernel + node {1e3 * res['node_ms']:.3f} us (runs "
        f"{', '.join(f'{1e3 * t:.3f}' for t in res['node_runs'])}), the kernel "
        f"alone {us_or_not(res['kernel_ms'])} (traced); graph.cond's node "
        f"(clone + kernel + node) {1e3 * res['ms']:.3f} us (runs "
        f"{', '.join(f'{1e3 * t:.3f}' for t in res['ms_runs'])}); (b) PyTorch's IF "
        f"node over pred.any() {lib}; (c) empty kernel + node "
        f"{1e3 * res['floor_ms']:.3f} us (runs "
        f"{', '.join(f'{1e3 * t:.3f}' for t in res['floor_runs'])}); pred.any() "
        f"{1e3 * plain_ms:.3f} us; bound {1e3 * res['bound_ms']:.6f} us (bytes) "
        f"[{card}]")

  # (d) fori_loop: an empty body, 198 rounds
  def carried(_g):
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    graph.while_loop(lambda c: c[1] < COUNTED_ROUNDS, lambda c: (c[0], c[1] + 1),
                     (x, count))

  def counted(_g):
    graph.fori_loop(COUNTED_ROUNDS, lambda c: c, x)

  loops = {}
  for turn in ("carried", "counted") * COND_TURNS:
    t = time_nodes(torch, graph, {"carried": carried, "counted": counted}[turn],
                   1, () if turn in loops else names)
    t["round_ms"] = t["ms"] / COUNTED_ROUNDS
    loops.setdefault(turn, []).append(t)
  # the traced first run, with the best time and every run's time per round
  loops = {k: v[0] | {"round_ms": min(t["round_ms"] for t in v),
                      "round_runs": [t["round_ms"] for t in v]}
           for k, v in loops.items()}
  counter = torch.zeros(1, dtype=torch.int32, device="cuda")
  counted_plain_ms = time_cuda(
    torch, lambda: graph.set_counted_plain(counter, COUNTED_ROUNDS), reps=200)
  c = loops["counted"]
  log(f"fori_loop of {COUNTED_ROUNDS} empty rounds: the counter carried "
      f"through while_loop {1e3 * loops['carried']['round_ms']:.3f} us per round "
      f"(runs {', '.join(f'{1e3 * v:.3f}' for v in loops['carried']['round_runs'])}; "
      f"{loops['carried']['launches']} launches per replay), the counted "
      f"form {1e3 * c['round_ms']:.3f} us (runs "
      f"{', '.join(f'{1e3 * v:.3f}' for v in c['round_runs'])}; "
      f"{c['launches']} launches per replay, {c['set_counted_kernel']['launches']:.0f} "
      f"of them the counted kernel at "
      f"{us_or_not(c['set_counted_kernel']['us'] and 1e-3 * c['set_counted_kernel']['us'])} "
      f"each); its plain version {1e3 * counted_plain_ms:.3f} us [{card}]")
  return {
    "cases": len(preds), "max_abs_err": err, "counted_max_abs_err": counted_err,
    "pooled_stream_captures": pooled,
    "widths": widths, "n": SOKOBAN_ENVS, "library": has_lib,
    "loops": loops, "counted_plain_ms": counted_plain_ms,
    "counted_bound_ms": 1e3 * 8 / HBM_BYTES_PER_S,
  }


def trace_replay(torch, sc):
  """One replay of a captured step, traced with CUDA activity only, from
  the state its buffers hold: (launches, device-busy us as the union of
  the launches' intervals, the span us from the first launch's start to the
  last one's end, launches by name, device us by name). The fill that
  resets the step counter before the replay is left out."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    sc.replay(1)
    torch.cuda.synchronize()
  events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)[1:]
  if not events:  # the profiler recorded nothing: not measured
    return None, None, None, None, None
  busy, start, end = 0.0, None, None
  for e in events:
    if end is None or e.time_range.start > end:
      busy += 0.0 if end is None else end - start
      start, end = e.time_range.start, e.time_range.end
    else:
      end = max(end, e.time_range.end)
  busy += end - start
  span = max(e.time_range.end for e in events) - events[0].time_range.start
  names, us = {}, {}
  for e in events:
    names[e.name] = names.get(e.name, 0) + 1
    us[e.name] = us.get(e.name, 0.0) + e.time_range.end - e.time_range.start
  return len(events), busy, span, names, us


def trace_text(launches, busy_us, step_us, trace_s) -> str:
  if busy_us is None:
    return (f"{step_us:.1f} us untraced; the trace recorded no launch (not "
            f"measured)")
  return (f"{launches} launches, device busy {busy_us:.1f} us (traced in "
          f"{trace_s:.1f} s) of {step_us:.1f} us untraced (idle "
          f"{100 * (1 - busy_us / step_us):.1f}%)")


@contextlib.contextmanager
def captured_structure(graph):
  """While a step is captured: each conditional node with the nodes it sits
  in and its body's node count, ``[path, kind, form, n, body_nodes]``, and
  the bytes of each captured ``graph.cond``'s operands, which it clones in
  front of its node, ``(path, bytes)``. A path lists the enclosing nodes'
  ``(kind, form, n)``."""
  nodes, clones, stack = [], [], []
  begin, cond = graph._conditional_body, graph.cond

  @contextlib.contextmanager
  def recorded_body(kind, form, arg, n):
    node = [tuple(stack), kind, form, n, None]
    nodes.append(node)
    stack.append((kind, form, n))
    try:
      with begin(kind, form, arg, n) as handle:
        yield handle
    finally:
      stack.pop()
    node[4] = graph._active.body_nodes[-1]

  def recorded_cond(pred, true_fn, false_fn, operands):
    if graph._capturing(pred):
      clones.append((tuple(stack), sum(t.nbytes for t in graph._leaves(operands))))
    return cond(pred, true_fn, false_fn, operands)

  graph._conditional_body, graph.cond = recorded_body, recorded_cond
  try:
    yield nodes, clones
  finally:
    graph._conditional_body, graph.cond = begin, cond


def runs_per_replay(graph, path, if_taken: bool):
  """How often a replay runs what sits at ``path``: 0 under a skipped IF
  node, ``n`` per counted loop around it; None where a WHILE node with a
  data-dependent predicate, or an IF node below the top, decides it (the
  step's one top-level IF node is the pool's reset, taken or not)."""
  if path and path[0][0] == graph._IF and not if_taken:
    return 0
  runs = 1
  for depth, (kind, form, n) in enumerate(path):
    if kind == graph._IF and depth == 0:
      continue
    if kind == graph._WHILE and form == graph._COUNTED:
      runs *= n
    else:
      return None
  return runs


def set_launches_per_replay(graph, nodes, if_taken: bool) -> dict:
  """The set kernel's launches in one replay, by form, from the captured
  structure: one in front of every node that runs, and one at the end of
  every round of a WHILE body (a counted loop's ``n`` rounds, the `any`
  form's rounds unknown: None). Where a count is unknown, ``why`` says so."""
  out = {graph._ANY: 0, graph._COUNTED: 0}
  why = None
  for path, kind, form, n, _ in nodes:
    runs = runs_per_replay(graph, path, if_taken)
    if kind == graph._WHILE and runs != 0:
      rounds = n if form == graph._COUNTED else None
      runs = None if runs is None or rounds is None else runs * (1 + rounds)
    if runs is None:
      out[form] = None
      why = "a data-dependent while_loop runs in this replay"
    elif out[form] is not None:
      out[form] += runs
  return {"any": out[graph._ANY], "counted": out[graph._COUNTED], "unknown": why}


def body_nodes_per_replay(graph, nodes, if_taken: bool):
  """The nodes that conditional bodies run in one replay, each body's
  count times its runs (None where a data-dependent loop decides)."""
  total = 0
  for path, kind, form, n, count in nodes:
    runs = runs_per_replay(graph, path + ((kind, form, n),), if_taken)
    if runs is None:
      return None
    total += runs * count
  return total


def captured_cell(torch, envpool_torch, task_id: str, card, general=False) -> dict:
  """One id's rollout eagerly and captured; see phase 18 in the docstring.
  ``general``: the pool's general path, its family's fused advance off."""
  from envpool_torch.core import graph
  from envpool_torch.envs.box2d import sampler

  n, steps, kw = CAPTURED[task_id]
  env = envpool_torch.make_gymnasium(task_id, num_envs=n, seed=SEED, device="cuda", **kw)
  if general:
    env._fused = None
  env.reset()
  handle, _, send, _ = env.xla()
  acts = torch.from_numpy(captured_actions(envpool_torch, task_id, steps, n)).cuda()

  def body(carry):
    h, t = carry
    h = send(h, acts.index_select(0, t)[0])
    return (h, t + 1), h.out

  t0 = torch.zeros(1, dtype=torch.int64, device="cuda")
  torch.cuda.synchronize()
  t_e = time.perf_counter()
  carry, outs = (handle, t0), []
  for _ in range(steps):
    carry, y = body(carry)
    outs.append(y)
  torch.cuda.synchronize()
  eager_s = time.perf_counter() - t_e
  want = tuple(torch.stack(col) for col in zip(*outs))
  del outs
  torch.cuda.reset_peak_memory_stats()
  base = torch.cuda.memory_allocated()
  renders = sampler.fused_background.launches
  sc = graph.CapturedScan(body, steps)
  torch.cuda.set_sync_debug_mode("error")
  try:
    t_c = time.perf_counter()
    with captured_structure(graph) as (nodes, clones):
      (got_h, _), got = sc((handle, t0))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t_c
    t_r = time.perf_counter()
    (got_h2, _), got2 = sc((handle, t0))
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t_r
  finally:
    torch.cuda.set_sync_debug_mode(0)
  peak_gb = (torch.cuda.max_memory_allocated() - base) / 2**30
  bit_equal(torch, got, want, f"{task_id} outputs")
  bit_equal(torch, got_h.pool, carry[0].pool, f"{task_id} final pool state")
  bit_equal(torch, got2, got, f"{task_id} second replay")
  keys = env._state_keys
  first = got[keys.index("step_type")] == 0
  resets = int(first[1:].sum())
  # the replay timed and traced below is the second step's: its IF node
  # (the pool's reset) runs its body where a lane starts anew there
  if_taken = bool(first[1].any())
  sets = set_launches_per_replay(graph, nodes, if_taken)
  in_bodies = body_nodes_per_replay(graph, nodes, if_taken)
  clone_runs = [(runs_per_replay(graph, path, if_taken), b) for path, b in clones]
  clone_bytes = (None if any(r is None for r, _ in clone_runs)
                 else sum(r * b for r, b in clone_runs))
  if task_id in ("CheetahJaxRun-v1", "PusherJax-v4") and resets < 2 * n:
    raise AssertionError(f"{task_id}: {resets} lanes reset inside the captured rollout")
  del got2
  # the second step's replay, from the same state twice: timed alone by
  # CUDA events, then traced (the profiler takes ~0.1 ms per kernel it
  # records, and stretches the replay's span: its kernels' sum is kept)
  ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
  sc((handle, t0), 1)
  ev[0].record()
  sc.replay(1)
  ev[1].record()
  torch.cuda.synchronize()
  step_us = 1e3 * ev[0].elapsed_time(ev[1])
  sc((handle, t0), 1)
  t_t = time.perf_counter()
  traced = in_bodies is not None and in_bodies <= TRACE_BODY_NODES
  if traced:
    launches, busy_us, _, rows, rows_us = trace_replay(torch, sc)
    if busy_us is None:  # the tracer recorded nothing: once more
      sc((handle, t0), 1)
      launches, busy_us, _, rows, rows_us = trace_replay(torch, sc)
  else:  # the tracer faults on such a replay: not traced
    launches = busy_us = rows = rows_us = None
  trace_s = time.perf_counter() - t_t
  replay_text = (trace_text(launches, busy_us, step_us, trace_s) if traced else
                 f"{step_us:.1f} us untraced, not traced: its conditional "
                 f"bodies run {in_bodies} nodes")
  res = {
    "envs": n, "steps": steps, "eager_sps": n * steps / eager_s,
    "captured_sps": n * steps / replay_s, "first_call_s": first_s,
    "capture_s": sc.capture_s, "instantiate_s": sc.instantiate_s,
    "nodes": sc.nodes, "conditional_nodes": sc.conditional_nodes,
    "peak_gb": peak_gb, "launches_per_step": launches,
    "busy_us_per_step": busy_us,
    "idle": None if busy_us is None else 1 - busy_us / step_us,
    "lanes_reset": resets,
    "sampler_launches": sampler.fused_background.launches - renders,
    "trace_s": trace_s, "cond_clone_bytes": clone_bytes,
    "reset_in_step_2": if_taken,
    "set_any_per_step": sets["any"], "set_counted_per_step": sets["counted"],
    "set_per_step_unknown": sets["unknown"],
    # as the trace recorded them, which may miss kernels of WHILE bodies
    "traced_set_any": None if rows is None else sum(
      c for name, c in rows.items() if "set_any_kernel" in name),
    "traced_set_counted": None if rows is None else sum(
      c for name, c in rows.items() if "set_counted_kernel" in name),
    "while_rounds_in_step": any(kind == graph._WHILE
                                and runs_per_replay(graph, path, if_taken) != 0
                                for path, kind, _, _, _ in nodes),
    "body_nodes_in_step": in_bodies,
  }
  bg = [c for name, c in (rows or {}).items() if "car_racing_background" in name]
  if bg:
    res["sampler_per_step"] = bg[0]
  sok_text = ""
  if task_id == "Sokoban-v0" and rows_us is not None:
    # the step kernel's own share of the replay, in every mode traced
    res["sokoban_kernel_us"] = sum(us for name, us in rows_us.items()
                                   if "sokoban_kernel" in name)
    sok_text = (f", of it csrc/sokoban_step.cu {res['sokoban_kernel_us']:.1f} us "
                f"and the rest {busy_us - res['sokoban_kernel_us']:.1f}")
  log(f"{task_id}{' (general path)' if general else ''} captured: {n} envs x "
      f"{steps} steps, every output field and "
      f"the final state bit for bit against the eager xla() loop; eager "
      f"{res['eager_sps']:.1f} env-steps/s, captured {res['captured_sps']:.1f} "
      f"(x{res['captured_sps'] / res['eager_sps']:.2f}); capture "
      f"{sc.capture_s:.3f} s, instantiate {sc.instantiate_s:.3f} s, first call "
      f"{first_s:.3f} s; {sc.nodes} nodes ({sc.conditional_nodes} conditional); "
      f"peak {peak_gb:.3f} GiB over the eager outputs; the second step's "
      f"replay alone: {replay_text}{sok_text}"
      f"{' (the trace may miss kernels of WHILE bodies)' if res['while_rounds_in_step'] else ''}; "
      f"set kernels in it, by the captured structure (reset branch "
      f"{'taken' if if_taken else 'skipped'}): {res['set_any_per_step']} `any`, "
      f"{res['set_counted_per_step']} counted"
      f"{'' if sets['unknown'] is None else ' (None: ' + sets['unknown'] + ')'}"
      f" (the trace recorded {res['traced_set_any']} and "
      f"{res['traced_set_counted']}); "
      f"cond's operand clones copy {clone_bytes} B per step; {resets} lane "
      f"resets after step 1 [{card}]")
  return res


def captured_masked(torch, envpool_torch, card) -> dict:
  """The masked entry points with a device ``env_id``, captured:
  CartPole-v1 at 8192 envs, 20 steps, each a ``send`` to every other lane
  and a forced reset of every fourth lane (``_advance_ids(..., reset=True)``,
  the host API's partial reset), bit for bit against the same calls run
  eagerly."""
  from envpool_torch.core import graph

  n, steps = 8192, 20
  env = envpool_torch.make_gymnasium("CartPole-v1", num_envs=n, seed=SEED, device="cuda")
  env.reset()
  handle, _, send, _ = env.xla()
  half = torch.arange(0, n, 2, device="cuda")
  quarter = torch.arange(0, n, 4, device="cuda")
  acts = torch.from_numpy(small_actions(SEED + 52, steps, n // 2, 2)).cuda()
  # the carry keeps its shapes: its out holds the masked batch from here on
  handle = send(handle, acts[0], env_id=half)

  def body(carry):
    h, t = carry
    h = send(h, acts.index_select(0, t)[0], env_id=half)
    pool, outs = env._advance_ids(h.pool, None, quarter, True)
    return (h._replace(pool=pool), t + 1), (h.out, tuple(outs))

  def run(steps_done):
    carry, rows = (handle, torch.zeros(1, dtype=torch.int64, device="cuda")), []
    for _ in range(steps_done):
      carry, y = body(carry)
      rows.append(y)
    return carry, rows

  from envpool_torch.core.graph import tree_map
  carry, rows = run(steps)
  want = tree_map(lambda *r: torch.stack(r), *rows)
  sc = graph.CapturedScan(body, steps)
  torch.cuda.set_sync_debug_mode("error")
  try:
    (got_h, _), got = sc((handle, torch.zeros(1, dtype=torch.int64, device="cuda")))
  finally:
    torch.cuda.set_sync_debug_mode(0)
  bit_equal(torch, got, want, "masked send and reset outputs")
  bit_equal(torch, got_h.pool, carry[0].pool, "masked send and reset final state")
  log(f"CartPole-v1 masked entry points captured: {n} envs x {steps} steps of "
      f"send(env_id=every other lane) and a forced reset of every fourth lane, "
      f"device env_id, bit for bit against the eager calls; {sc.nodes} nodes "
      f"[{card}]")
  return {"envs": n, "steps": steps, "nodes": sc.nodes}


def captured_ppo(torch, envpool_torch, card) -> dict:
  """PPO's rollout on Sokoban-v0 at examples/ppo_sokoban.py's width
  (``SokobanCNN()``, 1024 envs, 32 steps): ``rollout`` (captured) against
  the same steps run eagerly, bit for bit in the trajectory, the handle, the
  key and the bootstrap value."""
  from envpool_torch.core.graph import tree_map
  from envpool_torch.models import SokobanCNN
  from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init

  n = N_ENVS
  pool = envpool_torch.make_gymnasium(
    "Sokoban-v0", num_envs=n, seed=SEED, device="cuda", **SOKOBAN_KW
  )
  net = SokobanCNN()
  cfg = PPOConfig(num_steps=PPO_STEPS, lr=PPO_LR)
  state, tx = ppo_init(pool, net, cfg, seed=SEED)
  step = make_ppo_train_step(pool, net, cfg, tx)
  # the eager steps first: they also make the family's constants, which a
  # first step makes on the device once, outside the sync check
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  with torch.no_grad():
    step._params = {k: v.clone() for k, v in state.params.items()}
    carry, rows = (state.handle, state.key), []
    for _ in range(cfg.num_steps):
      carry, row = step._rollout_step(carry)
      rows.append(row)
    _, states = step._recv(carry[0])
    _, want_value = step._apply(state.params, states[step._obs])
  torch.cuda.synchronize()
  eager_s = time.perf_counter() - t0
  torch.cuda.reset_peak_memory_stats()
  base = torch.cuda.memory_allocated()
  torch.cuda.set_sync_debug_mode("error")
  try:
    t0 = time.perf_counter()
    handle, key, traj, last_value = step.rollout(state)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step.rollout(state)
    torch.cuda.synchronize()
    captured_s = time.perf_counter() - t0
  finally:
    torch.cuda.set_sync_debug_mode(0)
  peak_gb = (torch.cuda.max_memory_allocated() - base) / 2**30
  want = tree_map(lambda *r: torch.stack(r), *rows)
  bit_equal(torch, traj, want, "PPO rollout trajectory")
  bit_equal(torch, (handle.pool, key, last_value), (carry[0].pool, carry[1], want_value),
            "PPO rollout handle, key and value")
  sc = step._scan
  res = {"envs": n, "steps": cfg.num_steps, "eager_sps": n * cfg.num_steps / eager_s,
         "captured_sps": n * cfg.num_steps / captured_s, "first_call_s": first_s,
         "capture_s": sc.capture_s, "instantiate_s": sc.instantiate_s,
         "nodes": sc.nodes, "peak_gb": peak_gb}
  log(f"PPO Sokoban-v0 rollout captured: {n} envs x {cfg.num_steps} steps "
      f"(SokobanCNN full width, bf16), trajectory, handle, key and value bit "
      f"for bit against the eager steps; eager {res['eager_sps']:.1f} "
      f"env-steps/s, captured {res['captured_sps']:.1f} "
      f"(x{res['captured_sps'] / res['eager_sps']:.2f}); capture "
      f"{sc.capture_s:.3f} s, instantiate {sc.instantiate_s:.3f} s; "
      f"{sc.nodes} nodes; peak {peak_gb:.3f} GiB [{card}]")
  return res


def graph_cond_child(path: str) -> int:
  """Phase 18's kernel checks and timings (``check_set_conditional``), in a
  process of its own: its traces then run in a fresh profiler, which the
  card's CUPTI needs to record a replay of conditional nodes in full after
  the script's earlier traces; the results written to ``path`` (JSON)."""
  import torch

  if not torch.cuda.is_available():
    raise RuntimeError("phase 18's child needs a CUDA device")
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  res = check_set_conditional(torch, card_line())
  res["widths"] = {str(n): r for n, r in res["widths"].items()}
  with open(path, "w") as f:
    json.dump(res, f)
  return 0


def captured_rollouts(torch, envpool_torch, card) -> dict:
  from envpool_torch.core import graph
  from envpool_torch.envs.box2d import sampler

  scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke")
  os.makedirs(scratch, exist_ok=True)
  path = os.path.join(scratch, "graph_cond.json")
  if os.path.exists(path):
    os.remove(path)
  t0 = time.perf_counter()
  proc = subprocess.run(
    [sys.executable, os.path.abspath(__file__), "--graph-cond", path], timeout=600)
  if proc.returncode != 0:
    raise AssertionError(f"phase 18's kernel child exited {proc.returncode}")
  with open(path) as f:
    res = {"set_conditional": json.load(f)}
  log(f"set_conditional checks and timings (a child process): "
      f"{time.perf_counter() - t0:.1f} s")
  # the phase's main path: every count from 0
  from envpool_torch.core import prng
  from envpool_torch.envs.sokoban.sokoban import SokobanEnv

  graph.set_conditional.launches = graph.set_counted.launches = 0
  sampler.fused_background.launches = 0
  prng.threefry_kernel.launches = SokobanEnv.kernel_launches = 0
  SokobanEnv.advance_launches = 0
  for task_id in CAPTURED:
    t0 = time.perf_counter()
    res[task_id] = captured_cell(torch, envpool_torch, task_id, card)
    res[task_id]["seconds"] = time.perf_counter() - t0
    log(f"  {task_id}: {res[task_id]['seconds']:.1f} s")
    torch.cuda.empty_cache()
  # the fused advance leaves Sokoban's step graph no conditional node; the
  # same cell over the general path (graph.cond and the step kernel, the
  # path before the advance was fused) stands beside it
  sok = res["Sokoban-v0"]
  if sok["conditional_nodes"] != 0 or sok["set_any_per_step"] != 0:
    raise AssertionError(f"Sokoban-v0's captured step has conditional nodes: {sok}")
  t0 = time.perf_counter()
  res["Sokoban-v0 general path"] = captured_cell(torch, envpool_torch, "Sokoban-v0",
                                                 card, general=True)
  log(f"  Sokoban-v0 general path: {time.perf_counter() - t0:.1f} s")
  torch.cuda.empty_cache()
  res["masked"] = captured_masked(torch, envpool_torch, card)
  res["ppo_sokoban"] = captured_ppo(torch, envpool_torch, card)
  res["launches"] = {"set_conditional": graph.set_conditional.launches,
                     "set_conditional_counted": graph.set_counted.launches,
                     "car_racing_sampler": sampler.fused_background.launches,
                     "threefry": prng.threefry_kernel.launches,
                     "sokoban_step": SokobanEnv.kernel_launches,
                     "sokoban_advance": SokobanEnv.advance_launches}
  if not all(res["launches"].values()):
    raise AssertionError(f"phase 18 launched a kernel no time: {res['launches']}")
  return res


def main(argv) -> int:
  if argv[:1] == ["--cpu-reference"]:  # phases 12, 13 and 14's children
    return cpu_reference(argv[1], argv[2])
  if argv[:1] == ["--wheel-families"]:  # phase 17's child
    return wheel_families(argv[1])
  if argv[:1] == ["--host-tier"]:  # phase 16's child
    return host_tier_child(argv[1])
  if argv[:1] == ["--graph-cond"]:  # phase 18's kernel child
    return graph_cond_child(argv[1])

  import torch

  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 1
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  import envpool_torch
  from envpool_torch import _build
  from envpool_torch.envs.box2d import sampler
  from envpool_torch.envs.toy_text.blackjack import MAX_DEALER_DRAWS

  device = "cuda"
  t_start = time.perf_counter()
  scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
  os.makedirs(scratch, exist_ok=True)
  log.t0, log.timeline = t_start, open(os.path.join(scratch, "timeline.log"), "w")
  # 1. the card
  card = card_line()
  log(card)
  kind = torch.cuda.get_device_name(0)
  log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

  # 2. build
  build_s = _build.build()
  log(f"build: {build_s:.2f} s")
  for name, text in _build.build_log.items():
    for line in text.splitlines():
      if "registers" in line or "spill" in line or "error" in line:
        log(f"  {name}: {line.strip()}")

  # 3. kernel vs plain
  kres = check_background(torch, envpool_torch, device, card)
  t3 = time.perf_counter()
  tf_res = check_threefry(torch, device, card)
  step_res = check_sokoban_step(torch, envpool_torch, device, card)
  adv_res = check_sokoban_advance(torch, envpool_torch, device, card)
  log(f"threefry, sokoban_step and sokoban_advance checks: "
      f"{time.perf_counter() - t3:.1f} s")

  # 4. main path
  env, last_action, sps, launches, _ = run_sync(
    torch, envpool_torch, sampler, device, MAIN_STEPS, SEED + 1
  )
  log(f"main path: {N_ENVS} envs, reset + {MAIN_STEPS} steps, "
      f"{sps:.1f} env-steps/s via make_gymnasium step (host copies), "
      f"sampler launches {launches} [{card}]")
  _, _, sps64, launches64, resets = run_sync(
    torch, envpool_torch, sampler, device, 150, SEED + 4, max_episode_steps=64
  )
  assert resets.min() >= 2, f"a lane auto-reset {resets.min()} times"
  log(f"auto-reset pool: max_episode_steps=64, 150 steps, every lane reset "
      f">= {resets.min()} times, {sps64:.1f} env-steps/s, launches {launches64}")
  launches_async = run_async(envpool_torch, sampler, device)
  log(f"async pool: batch 256 of {N_ENVS}, 20 recv/send, launches {launches_async}")
  sps_xla, launches_xla = run_functional(torch, env, sampler)
  log(f"xla() loop: 100 steps + commit, {sps_xla:.1f} env-steps/s on the device "
      f"(no host copies of outputs), launches {launches_xla} [{card}]")

  rng = np.random.default_rng(SEED + 5)
  busy_us, rows = profile_steps(torch, env, torch.from_numpy(
    np.stack([random_actions(rng, N_ENVS) for _ in range(11)])
  ).to(device))
  log_profile(f"CarRacing-v2 xla() step of {N_ENVS} envs", busy_us, rows,
              1e6 * N_ENVS / sps_xla, card)
  for name, us, count in rows:
    if "car_racing_background" in name:
      log(f"  background kernel: {us:.1f} us/step, {count:.1f} launches/step")

  # 5. card vs CPU port
  cmp = card_vs_cpu(envpool_torch, env, last_action)
  log(f"card vs cpu port, one step of {N_ENVS} envs: obs equal "
      f"{cmp['obs_equal']:.6f}, reward max err {cmp['reward_max_err']:.3g}, "
      f"pos max err {cmp['pos_max_err']:.3g}, integer fields exact")

  # 6. Sokoban-v0, the headline workload: the main path of the advance
  # kernel, every count from 0
  t6 = time.perf_counter()
  from envpool_torch.core import graph, prng
  from envpool_torch.envs.sokoban.sokoban import SokobanEnv

  prng.threefry_kernel.launches = SokobanEnv.kernel_launches = 0
  SokobanEnv.advance_launches = graph.set_conditional.launches = 0
  env, sps, sps_xla, dones, bound = sokoban_headline(torch, envpool_torch, device)
  main_launches = {"threefry": prng.threefry_kernel.launches,
                   "sokoban_step": SokobanEnv.kernel_launches,
                   "sokoban_advance": SokobanEnv.advance_launches,
                   "set_conditional": graph.set_conditional.launches}
  # one advance kernel per advance: the reset, then every step of the step
  # loop and of the xla() loop; threefry only at the pool's init (fold_in
  # and split), the key split is in the advance; no step or reset mode and
  # no set kernel (no graph.cond)
  want_steps = 1 + 2 * SOKOBAN_STEPS
  log(f"Sokoban-v0 kernel launches in reset + {2 * SOKOBAN_STEPS} steps: "
      f"sokoban_advance {main_launches['sokoban_advance']} (expected {want_steps}), "
      f"threefry {main_launches['threefry']} (expected 2: the pool's init fold_in "
      f"and split), sokoban_step in step or reset mode "
      f"{main_launches['sokoban_step']} and set_conditional "
      f"{main_launches['set_conditional']} (expected 0)")
  if main_launches != {"threefry": 2, "sokoban_step": 0, "sokoban_advance": want_steps,
                       "set_conditional": 0}:
    raise AssertionError(f"Sokoban-v0 main path launches {main_launches}")
  log(f"Sokoban-v0: {SOKOBAN_ENVS} envs, reset + {SOKOBAN_STEPS} steps of "
      f"actions in [-1, 3]: every lane auto-reset ({int(dones.min())} to "
      f"{int(dones.max())} terminal steps per lane), NaN rewards exactly at "
      f"the noops; {sps:.1f} env-steps/s via make_gymnasium step (host "
      f"copies), {sps_xla:.1f} env-steps/s in a {SOKOBAN_STEPS}-step xla() "
      f"loop [{card}]")
  busy_us, rows = profile_steps(torch, env, torch.from_numpy(
    sokoban_actions(SEED + 12, 11, SOKOBAN_ENVS)
  ).to(device))
  log_profile(f"Sokoban-v0 xla() step of {SOKOBAN_ENVS} envs", busy_us, rows,
              1e6 * SOKOBAN_ENVS / sps_xla, card)
  sokoban_trace = {"busy_us": busy_us, "launches": sum(r[2] for r in rows),
                   "kernels": {k: (us, count) for k, us, count in rows
                               if "threefry" in k or "sokoban" in k}}
  for kname, (us, count) in sokoban_trace["kernels"].items():
    log(f"  {kname[:60]}: {us:.2f} us/step, {count:.1f} launches/step")
  byte_ms, op_ms, n_bytes = bound
  log(f"Sokoban-v0 pool step bound: "
      f"{1e3 * max(byte_ms, op_ms):.2f} us per step of {SOKOBAN_ENVS} envs "
      f"({n_bytes} B, {'bytes' if byte_ms >= op_ms else 'operations'}; "
      f"operations {1e3 * op_ms:.2f} us) against {busy_us:.1f} us of eager "
      f"device kernels in {sokoban_trace['launches']:.0f} launches")
  del env
  env, episodes, sps_seq = sokoban_sequential(torch, envpool_torch, device)
  log(f"Sokoban-v0 sequential mode: 1024 envs, 200 steps, {episodes} "
      f"episodes, level_idx and level_file_idx on the stream at every step; "
      f"{sps_seq:.1f} env-steps/s via step [{card}]")
  busy_us, rows = profile_steps(torch, env, torch.from_numpy(
    sokoban_actions(SEED + 13, 11, 1024)
  ).to(device))
  log_profile("Sokoban-v0 sequential-mode xla() step of 1024 envs", busy_us,
              rows, 1e6 * 1024 / sps_seq, card)
  del env
  for mode, r in sokoban_card_vs_cpu(envpool_torch, device).items():
    log(f"Sokoban-v0 card vs cpu port, {mode} mode, 256 envs: all {r['fields']} "
        f"output fields of reset + {r['steps']} steps bit-exact "
        f"({r['nan_rewards']} NaN rewards, {r['terminals']} terminal steps), "
        f"final state equal")
  log(f"Sokoban phases: {time.perf_counter() - t6:.1f} s")

  # 7. CartPole-v1
  cp = cartpole_card_vs_cpu(torch, envpool_torch, device)
  log(f"CartPole-v1 card vs cpu port, 8192 envs, 100 steps from shared "
      f"states: obs max err {cp['obs_max_err']:.3g}, rewards and integer "
      f"fields exact, {cp['auto_resets']} auto-resets; step loop "
      f"{cp['step_sps']:.1f} env-steps/s [{card}]")

  # 8. PPO
  t8 = time.perf_counter()
  ppo = {n: ppo_sokoban(torch, envpool_torch, device, n, iters, card)
         for n, iters in ((1024, 3), (SOKOBAN_ENVS, 2))}
  log(json.dumps({"ppo": {str(n): {k: v for k, v in r.items() if k != "traced"}
                          for n, r in ppo.items()}}))
  cmp = ppo_card_vs_cpu(torch, envpool_torch, device)
  log(f"PPO card vs cpu port, Sokoban-v0 64 envs 7x7, one iteration in float32 "
      f"(TF32 off): equal actions {cmp['equal_actions']:.6f}, parameters "
      f"differ by at most {cmp['param_max_diff']:.3g} (the update moved them "
      f"by up to {cmp['param_max_move']:.3g}), metrics by {cmp['metric_max_rel']:.3g} "
      f"relative")
  # the tolerance: actions differ only at near-ties of the logits, and a
  # parameter whose Adam step changed sign would differ by 2 lr = 5e-4
  if cmp["equal_actions"] < 0.99 or cmp["param_max_diff"] > 1e-4:
    raise AssertionError(f"PPO card vs cpu port: {cmp}")
  t_cp = time.perf_counter()
  rewards = ppo_learns_cartpole(torch, envpool_torch, device)
  log(f"PPO learns CartPole-v1 on the card in {time.perf_counter() - t_cp:.1f} s "
      f"(tests/test_learning.py config, ppo_init seed {CARTPOLE_PPO_SEED}): "
      f"mean_reward {rewards[0]:.4f} at "
      f"iteration 0, best of 5+ {max(rewards[5:]):.4f} > 0.985; "
      f"{[round(r, 4) for r in rewards]}")
  log(f"PPO phases: {time.perf_counter() - t8:.1f} s")

  # 9. the small device families: Pong, MiniGrid, toy text
  t9 = time.perf_counter()
  small = {"PongJaxDemo-v5": small_family(
    torch, envpool_torch, device, "PongJaxDemo-v5", PONG_ENVS, PONG_STEPS, 6,
    pong_check, card)}
  for task_id, steps in MINIGRID.items():
    small[task_id] = small_family(torch, envpool_torch, device, task_id, SMALL_ENVS,
                                  steps, 7, minigrid_check(task_id), card)
  for task_id, (n_act, _) in TOY_TEXT.items():
    small[task_id] = small_family(torch, envpool_torch, device, task_id, SMALL_ENVS,
                                  TOY_TEXT_STEPS, n_act, toy_text_check(task_id), card,
                                  xla=False)
  log(f"toy text launches per step at {SMALL_ENVS} envs: " + ", ".join(
    f"{t} {small[t]['launches']:.0f}" for t in TOY_TEXT
  ) + f"; of them Blackjack-v1 (the dealer's key chain of "
      f"{MAX_DEALER_DRAWS} splits and its draws) {small['Blackjack-v1']['launches']:.0f}")
  t9c = time.perf_counter()
  for task_id, r in small_card_vs_cpu(envpool_torch, device).items():
    obs = (f", obs to the resize rule ({r['pixels_off']} pixels off by 1)"
           if task_id.startswith("Pong") else "")
    log(f"{task_id} card vs cpu port, 256 envs, {r['outputs']} outputs: "
        f"{r['fields']} output fields bit-exact{obs}; {r['episodes']} episodes "
        f"ended ({100 * r['lanes_ended']:.0f}% of lanes); final state equal")
  log(f"small families: {time.perf_counter() - t9:.1f} s (card vs cpu "
      f"{time.perf_counter() - t9c:.1f} s)")
  log(json.dumps({"small_families": small}))

  # 10. the Box2D family: LunarLander and BipedalWalker, each id
  t10 = time.perf_counter()
  box2d = {t: box2d_family(torch, envpool_torch, device, t, card) for t in BOX2D_IDS}
  for task_id in BOX2D_IDS:
    box2d[task_id]["blocks"] = box2d_blocks(torch, envpool_torch, device, task_id, card)
  t10c = time.perf_counter()
  for task_id in BOX2D_IDS:
    r = box2d_card_vs_cpu(torch, envpool_torch, device, task_id)
    box2d[task_id]["card_vs_cpu"] = r
    log(f"{task_id} card vs cpu port, {r['lanes']} envs, reset + {r['steps']} "
        f"steps: {r['parted']} lanes parted (at most "
        f"{BOX2D_CMP[task_id][1]:.0%} allowed), the others within "
        f"{r['max_rel_err_unparted']:.3g} relative (limit {BOX2D_TOL:g}) with "
        f"integer, bool, contact and lidar fields equal; the reset terrain "
        f"of {r['terrain_lanes_equal']} lanes bit for bit")
  log(f"Box2D: {time.perf_counter() - t10:.1f} s (card vs cpu "
      f"{time.perf_counter() - t10c:.1f} s)")
  log(json.dumps({"box2d": box2d}))

  # 11. the on-device MuJoCo family (contact-free): Reacher,
  # InvertedPendulum, InvertedDoublePendulum, Swimmer
  t11 = time.perf_counter()
  mj = {t: mujoco_family(torch, envpool_torch, device, t, card) for t in MUJOCO_IDS}
  t11c = time.perf_counter()
  for task_id in MUJOCO_IDS:
    mj[task_id].update(mujoco_checks(torch, envpool_torch, device, task_id))
  log(f"MuJoCo: {time.perf_counter() - t11:.1f} s (card vs cpu "
      f"{time.perf_counter() - t11c:.1f} s)")
  log(json.dumps({"mujoco": mj}))

  # 12. the contact device MuJoCo ids: HalfCheetah, Hopper, Walker2d, Ant,
  # Humanoid, HumanoidStandup
  t12 = time.perf_counter()
  # 13. the dm_control device tier: CheetahJaxRun-v1 and HumanoidJaxRun-v1
  # 14. the rest of the device tier: Pusher, manipulator, humanoid_CMU; then
  # the comparisons of phases 12, 13 and 14 together (two CPU children)
  contact, dmc, last = contact_phase(torch, envpool_torch, device, card, scratch)
  log(f"MuJoCo contact, dm_control and phase 14: {time.perf_counter() - t12:.1f} s")
  log(json.dumps({"mujoco_contact": contact}))
  log(json.dumps({"dmc": dmc}))
  log(json.dumps({"device_tier_rest": last}))

  # 15. sharding on the card: CarRacing and Sokoban sharded bit for bit,
  # PPO on the env and (2, 2) meshes, checkpoint and trace, the dry run
  t15 = time.perf_counter()
  from envpool_torch.parallel.dryrun import dryrun_multichip

  shard = {"car_racing": car_racing_sharded(torch, envpool_torch, sampler, card)}
  shard["sokoban"], sharded_pool = sokoban_sharded(torch, envpool_torch, card)
  shard["ppo"] = ppo_sharded(torch, envpool_torch, card)
  shard["captured"] = sharded_captured(torch, envpool_torch, card)
  shard.update(checkpoint_and_trace(torch, envpool_torch, sharded_pool, scratch, card))
  del sharded_pool
  t_dry = time.perf_counter()
  dryrun_multichip(8)
  log(f"dryrun_multichip(8) on the card: a (4, 2) env x model mesh of cuda:0, "
      f"one PPO iteration, finite pg_loss, {time.perf_counter() - t_dry:.1f} s")
  log(f"sharding phase: {time.perf_counter() - t15:.1f} s")
  log(json.dumps({"sharding": shard}))

  # 16. the host tier: the Atari stack over a scripted emulator through
  # step, an async pool and xla() on cuda:0; the registry without mujoco
  t16 = time.perf_counter()
  host = run_host_tier(card, scratch)
  log(f"host tier phase: {time.perf_counter() - t16:.1f} s")
  log(json.dumps({"host_tier": host}))

  # 17. the last host families: procgen and ViZDoom (both action modes)
  # over scripted wheels through step, an async pool and xla() on cuda:0;
  # the examples in child processes
  t17 = time.perf_counter()
  wheels = last_host_families(torch, card, scratch)
  log(f"last host families and examples phase: {time.perf_counter() - t17:.1f} s")
  log(json.dumps({"last_host_families": wheels}))

  # 18. captured rollouts: xla() and the PPO rollout as CUDA graphs
  t18 = time.perf_counter()
  captured = captured_rollouts(torch, envpool_torch, card)
  log(f"captured rollouts phase: {time.perf_counter() - t18:.1f} s")
  log(json.dumps({"captured": captured}))

  log(f"total {time.perf_counter() - t_start:.1f} s")
  # 19. results
  main_case = kres["cases"]["real_fine"]
  kernel = {
    "name": "car_racing_sampler",
    "route": "cuda",
    "source": "envpool_torch/csrc/car_racing_sampler.cu",
    "replaces": "envpool_tpu/envs/box2d/car_racing.py:532",
    "launches": launches,
    "max_abs_err": kres["max_abs_err"],
    "ms": main_case["ms"],
    "plain_ms": main_case["plain_ms"],
    "bound_ms": main_case["bound_ms"],
    "bound_by": main_case["bound_by"],
    "library_ms": None,
    "unit": "one render, one launch, N=1024, per-env fine/coarse; "
            "top-level times: the main path's all-fine inputs, L2 warm",
    "ms_cold": main_case["ms_cold"],
    "cases": kres["cases"],
    "sharded": {name: r["per_render"] for name, r in shard["car_racing"].items()},
    "shard_case": kres["shard"],
  }
  cond = captured["set_conditional"]
  wide, lane = cond["widths"][str(cond["n"])], cond["widths"]["1"]
  replaces = ("none: the device side of jax.lax.cond at "
              "envpool_tpu/core/pool.py:210 and of jax.lax.while_loop at "
              "envpool_tpu/envs/mujoco/device_tasks.py:982")
  # set kernels per replayed step (the second), from the captured structure
  per_step = {t: (r["set_any_per_step"], r["set_counted_per_step"])
              for t, r in captured.items() if isinstance(r, dict) and "set_any_per_step" in r}
  cond_kernel = {
    "name": "set_conditional",
    "route": "cuda",
    "source": "envpool_torch/csrc/graph_cond.cu",
    "replaces": replaces,
    "launches": captured["launches"]["set_conditional"],
    "max_abs_err": cond["max_abs_err"],
    "ms": wide["ms"],
    "plain_ms": wide["plain_ms"],
    "bound_ms": wide["bound_ms"],
    "bound_by": wide["bound_by"],
    "library_ms": wide["library_ms"],
    "library": ("PyTorch's CUDAGraph.begin_capture_to_if_node over pred.any(), "
                "per skipped IF node" if cond["library"] else
                f"null: torch {torch.__version__}'s CUDAGraph has no "
                f"begin_capture_to_if_node"),
    "node_ms": wide["node_ms"], "kernel_ms": wide["kernel_ms"],
    "floor_ms": wide["floor_ms"],
    "at_1_lane": {k: v for k, v in lane.items() if k != "trace"},
    "per_replayed_step": {t: v[0] for t, v in per_step.items()},
    "unit": f"the `any` form: graph.cond's node, {cond['n']} lanes (the "
            f"operands' clone, one launch and its skipped IF node; node_ms: "
            f"the launch and the node alone; kernel_ms: the kernel alone, "
            f"traced; floor_ms: an empty kernel and the node); launches: those "
            f"recorded into phase 18's graphs; per_replayed_step: the second "
            f"step's replay of each id, from the captured structure (null: a "
            f"data-dependent while_loop ran)",
  }
  loops = cond["loops"]
  counted_kernel = {
    "name": "set_conditional_counted",
    "route": "cuda",
    "source": "envpool_torch/csrc/graph_cond.cu",
    "replaces": replaces + "; the counter of fori_loop(0, n, ...) with a static n",
    "launches": captured["launches"]["set_conditional_counted"],
    "max_abs_err": cond["counted_max_abs_err"],
    "ms": loops["counted"]["round_ms"],
    "plain_ms": cond["counted_plain_ms"],
    "bound_ms": cond["counted_bound_ms"],
    "bound_by": "bytes",
    "library_ms": None,
    "library": "null: PyTorch has no WHILE node and no one call that advances "
               "a counter and sets a handle",
    "kernel_ms": (None if loops["counted"]["set_counted_kernel"]["us"] is None
                  else 1e-3 * loops["counted"]["set_counted_kernel"]["us"]),
    "carried_round_ms": loops["carried"]["round_ms"],
    "per_replayed_step": {t: v[1] for t, v in per_step.items()},
    "unit": f"one round of an empty-bodied fori_loop of {COUNTED_ROUNDS} rounds "
            f"(one launch and the WHILE node's next round); launches: those "
            f"recorded into phase 18's graphs; per_replayed_step: as for "
            f"set_conditional",
  }
  tf_main = tf_res["cases"]["split"]
  threefry_kernel = {
    "name": "threefry",
    "route": "cuda",
    "source": "envpool_torch/csrc/threefry.cu",
    "replaces": "none: jax's threefry_2x32, which XLA fuses on the TPU, reached "
                "through envpool_tpu/core/pool.py:67 (_split_keys) and every "
                "family's draws",
    "launches": main_launches["threefry"],
    "max_abs_err": tf_res["max_abs_err"],
    "ms": tf_main["ms"],
    "plain_ms": tf_main["plain_ms"],
    "bound_ms": tf_main["bound_ms"],
    "bound_by": tf_main["bound_by"],
    "library_ms": None,
    "library": "null: no single PyTorch call computes threefry-2x32",
    "ms_cold": tf_main["ms_cold"],
    "empty_ms": tf_main["empty_ms"],
    "cases": tf_res["cases"],
    "unit": f"the pool's split of {SOKOBAN_ENVS} keys (a strided view), one "
            f"launch; empty_ms: an empty kernel of the same grid; launches: "
            f"phase 6's Sokoban-v0 run (reset + {2 * SOKOBAN_STEPS} steps), "
            f"the pool's init alone: on that path the split runs in the "
            f"advance kernel",
  }
  st_main = step_res["cases"]["random_step"]
  step_kernel = {
    "name": "sokoban_step",
    "route": "cuda",
    "source": "envpool_torch/csrc/sokoban_step.cu",
    "replaces": "none: the XLA fusion of SokobanEnv.step and reset "
                "(envpool_tpu/envs/sokoban/sokoban.py:289, :240, :173, :394) "
                "under envpool_tpu/core/pool.py:215",
    "launches": main_launches["sokoban_step"],
    "phase18_launches": captured["launches"]["sokoban_step"],
    "max_abs_err": step_res["max_abs_err"],
    "ms": st_main["ms"],
    "plain_ms": st_main["plain_ms"],
    "bound_ms": st_main["bound_ms"],
    "bound_by": st_main["bound_by"],
    "library_ms": None,
    "library": "null: no single PyTorch call computes a Sokoban step",
    "ms_cold": st_main["ms_cold"],
    "cases": step_res["cases"],
    "main_path_trace": sokoban_trace,
    "unit": f"one SokobanEnv.step of {SOKOBAN_ENVS} envs in random mode from "
            f"a mid-episode state, one launch; launches: step and reset mode "
            f"in phase 6's Sokoban-v0 run (reset + {2 * SOKOBAN_STEPS} steps), "
            f"none since the pool's advance is fused (sokoban_advance counts "
            f"that path); phase18_launches: those recorded into phase 18's "
            f"graphs, its general-path cell",
  }
  adv_main = adv_res["cases"]["random_full"]
  advance_kernel = {
    "name": "sokoban_advance",
    "route": "cuda",
    "source": "envpool_torch/csrc/sokoban_step.cu",
    "replaces": "none: the XLA fusion of the pool's advance "
                "(envpool_tpu/core/pool.py:173, its env-resets branch :215 and "
                "_merge_resets :181) over SokobanEnv.step and reset "
                "(envpool_tpu/envs/sokoban/sokoban.py:289, :240, :173, :394)",
    "launches": main_launches["sokoban_advance"],
    "max_abs_err": adv_res["max_abs_err"],
    "ms": adv_main["ms"],
    "plain_ms": adv_main["plain_ms"],
    "bound_ms": adv_main["bound_ms"],
    "bound_by": adv_main["bound_by"],
    "library_ms": None,
    "library": "null: no single PyTorch call computes a pool's Sokoban advance",
    "ms_cold": adv_main["ms_cold"],
    "host_us": adv_main["host_us"],
    "cases": adv_res["cases"],
    "unit": f"one full advance of a {SOKOBAN_ENVS}-env Sokoban-v0 pool in random "
            f"mode, {ADVANCE_DONE_SHARE:.0%} of the lanes carrying done, one "
            f"launch (mode 2 of the step kernel); plain: the pool's general "
            f"path over step_plain/reset_plain; launches: phase 6's Sokoban-v0 "
            f"run (reset + {2 * SOKOBAN_STEPS} steps)",
  }
  log(json.dumps({"kernels": [kernel, cond_kernel, counted_kernel, threefry_kernel,
                              step_kernel, advance_kernel]}))
  log(json.dumps({
    "ok": True,
    "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
  }))
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
