// The fused Sokoban step, reset and pool advance for Hopper (sm_90a): one
// launch per SokobanEnv.step, SokobanEnv.reset or TorchEnvPool advance of a
// Sokoban pool (envs/sokoban/sokoban.py, core/pool.py).
//
// Replaces no Pallas kernel: on the TPU, XLA fuses the pool's advance
// (envpool_tpu/core/pool.py:173-319: the key split, the env-resets branch
// :215-241 with its lax.cond over _merge_resets :181-213, the epilogue and
// the mask :270-276) and SokobanEnv.step / reset of
// envpool_tpu/envs/sokoban/sokoban.py (step :289, _fresh_episode :240,
// _load_level :173, _sample_cap :228, _render :394) into a few kernels. The
// port's plain versions (sokoban.py's step_plain / reset_plain under
// TorchEnvPool's general path) are ~450 launches of their own plus the
// threefry calls. Per env the kernel computes what they compute, bit for bit:
//
//   step     the action clamped to [0, 3], < 0 a noop; the three cells p0,
//            p0 + d, p0 + 2d read (out of bounds reads as WALL); the push
//            and move rules; the three writes, each made only in bounds and
//            when the agent moves; unmatched, steps (a noop does not count),
//            the float32 reward (step + box * (-d_unmatched)) + finished,
//            NaN on a noop, done, trunc, and elapsed_step, the finishing
//            episode's counter;
//   fresh    on done (every lane in reset mode) the next episode: the level
//            from the [n_levels, D, D] bank (sequential mode: the int32
//            cursor's floor mod, the cursor advanced by num_envs with int32
//            wrap; random mode: the file and the level drawn with randint of
//            threefry.cuh), the player at the first PLAYER or
//            PLAYER_ON_TARGET cell (0 if none), the BOX count, steps 0, the
//            cap drawn from the threefry stream (bits % span, with int32
//            wraps; the constant hi when lo >= hi);
//   render   the [3, D, D] palette image of the world after the step;
//   advance  (mode 2, the pool's advance) the lane's key split into the
//            carried key and the step's key (split2 of threefry.cuh), then
//            need_reset ? fresh : step, where need_reset is the carried done
//            flag or a forced reset, and the pool's epilogue: reward,
//            elapsed_step, done and trunc zeroed on a reset lane, step_type
//            (0 where elapsed_step is 0, else 2 where done, else 1),
//            discount = !done, the carried done flag 0. With a mask, a lane
//            outside it keeps its state, key, elapsed and done flag (its
//            other outputs are the pool's to discard). elapsed_step is the
//            pool's carried elapsed too, so the two may be one tensor.
//
// The eager code draws every lane's fresh episode and selects by done; here
// only the lanes that need one draw it. The results are the same, since
// each draw depends only on the lane's key and cursor. The same holds for
// the pool's reset select: a reset lane and a step lane that finishes draw
// from the same (cursor, key), so one body serves both.
//
// What bounds it: bytes. Per env it reads its state (D*D + 32 bytes), its
// action, key and done flag, a bank row on a fresh episode, and writes the
// world, the obs (3 D*D) and ~60 bytes of scalars: about 620 bytes at D =
// 10 in a full advance, 10.2 MB at 16,384 envs, 3.0 us at 3.35 TB/s; the
// threefry work (2 blocks per lane for the split, 13 more per fresh lane in
// random mode, 2 in sequential) is well under that at the card's integer
// rate. Tensor cores do nothing here: there is no product.
//
// What the design does about it. The first version (one thread per env,
// 128 envs to a block) ran 128 blocks of 128 threads at 16,384 envs (one
// wave, 4 warps an SM) and moved every byte of a world by one-byte loads,
// each warp walking its envs in turn: latency, 7-9% of the bound. Now:
//   - 32 envs per block and 256 threads (8 warps): 512 blocks at 16,384
//     envs, about 31 resident warps an SM, all in one wave (at most 64
//     registers a thread, __launch_bounds__ below). A block's tile is 32
//     worlds (3.2 KB at D = 10, 32 KB at D = 32), so no block needs more
//     than the default 48 KB of shared memory and a larger tile would only
//     cut the blocks in flight (16, 32 or 64 envs to 64-512 threads were
//     no faster on the card; tools/sokoban_step_ablation.py builds them);
//   - lane t (warp 0) loads its scalars as coalesced rows first, then every
//     thread moves the block's worlds, one contiguous run of 32 D*D bytes,
//     into shared memory with 16-byte loads (one each at D = 10; bytes where
//     the run is not 16-byte aligned), so both are in flight together. At
//     3.2 KB a block, one 16-byte access per thread is one round trip: a
//     TMA bulk copy would save those few instructions and no latency;
//   - the step's three cells are read from shared memory, the writes made
//     there; only lanes that need a fresh episode hash their draws, one
//     thread per env (eight threads hashing one env's draws in parallel
//     issue more instructions and were no faster on the card);
//   - a fresh lane's bank row (4-byte aligned: D*D is a multiple of 4 at D
//     = 10) is copied by the 8 threads of its group, every load issued
//     before any is used, and scanned in the same registers (the player by
//     byte compares, the boxes by popcounts), the group's results combined
//     by shuffles;
//   - the worlds go back, and the obs run (32 * 3 D*D contiguous bytes) is
//     rendered and written, as 16-byte stores: four tile bytes become four
//     palette bytes of one channel in one byte permute (D*D a multiple of
//     4; else one byte at a time).
// Where the rest goes (H100, 16,384 envs: a random step ~8.9 us against
// the 2.84 us bound, chip_smoke.py phase 3; tools/sokoban_step_ablation.py
// splits it by cutting stages): the launch floor of this grid, the
// scalars' round trip, the rules, and on a block with a fresh lane the
// draws and two more dependent round trips (the file tables, then the bank
// row), then the world and obs stores. Every block is in the same phase at
// once (one wave), so the stores do not overlap the loads. Writing the
// envs without a fresh episode before the fresh rows arrive, and the file
// tables kept in shared memory, were no faster on the card.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

// The kernel's arguments; mirrored by envs/sokoban/sokoban.py::_StepArgs.
struct SokobanArgs {
  // the state in: world [n, D, D] uint8, player [n, 2] int32, [n] int32
  const uint8_t* world;
  const int32_t* player;
  const int32_t* unmatched;
  const int32_t* steps;
  const int32_t* cap;
  const int32_t* cursor;
  const int32_t* file_idx;
  const int32_t* level_idx;
  const int32_t* action;  // [n] int32; unused in reset mode
  // lane e's key: keys[e * key_stride], keys[e * key_stride + key_col]; the
  // step's key in step and reset mode, the pool's carried key in advance mode
  const int64_t* keys;
  long long key_stride;
  long long key_col;
  // the bank: levels [n_levels, D, D] uint8, its [n_levels] int32 tables,
  // file_start [n_files] int64, file_len [n_files] int32
  const uint8_t* levels;
  const int32_t* bank_file_idx;
  const int32_t* bank_level_idx;
  const int64_t* file_start;
  const int32_t* file_len;
  int n_files;
  int n;
  int dim;
  int sequential;
  int n_eff;      // sequential mode: the levels the cursor walks
  int num_envs;   // sequential mode: the cursor's advance per episode
  unsigned cap_lo;    // min_episode_steps as uint32
  unsigned cap_span;  // (hi - lo + 1) mod 2^32; 0: the constant cap_hi
  int cap_hi;
  float reward_step;
  float reward_box;
  float reward_finished;
  // the outputs: the state, the obs [n, 3, D, D] uint8, reward, done, trunc
  // (unused in reset mode) and elapsed_step
  uint8_t* world_out;
  int32_t* player_out;
  int32_t* unmatched_out;
  int32_t* steps_out;
  int32_t* cap_out;
  int32_t* cursor_out;
  int32_t* file_idx_out;
  int32_t* level_idx_out;
  uint8_t* obs;
  float* reward;
  bool* done;
  bool* trunc;
  int32_t* elapsed;
  // advance mode only: the pool's carried elapsed [n] int32 and done [n]
  // bool, the mask [n] bool (null: every lane), and the outputs: the
  // carried key [n, 2] int64 (contiguous), step_type [n] int32, discount
  // [n] float32 and the carried done flag [n] bool
  const int32_t* elapsed_in;
  const bool* done_in;
  const bool* mask;
  int64_t* rng_out;
  int32_t* step_type;
  float* discount;
  bool* done_carry;
  int force_reset;
};

namespace {

// tile codes (level_loader.py) and the tiny-world palette (sokoban.py)
constexpr uint8_t WALL = 0, EMPTY = 1, TARGET = 2, BOX_ON_TARGET = 3, BOX = 4,
                  PLAYER = 5, PLAYER_ON_TARGET = 6;
constexpr int kTiles = 7;
constexpr int kStep = 0, kReset = 1, kAdvance = 2;
// (row, col) deltas by clamped action: the reference's kChangeCoordinates.
// A table and not a chain of selects on the clamped action: with the chain,
// nvcc 12.9 for sm_90a took `ac == 3` from the predicate output of the
// clamp's VIMNMX.RELU, which the card set for every action <= 3, so actions
// 0 and 1 moved diagonally and actions > 3 not at all.
__constant__ int8_t kDelta[8] = {-1, 0, 1, 0, 0, -1, 0, 1};
__constant__ uint8_t kPalette[kTiles * 3] = {
    0, 0, 0,  243, 248, 238,  254, 126, 125,  254, 95, 56,
    142, 121, 56,  160, 212, 56,  219, 212, 56,
};

constexpr int kEnvs = 32;      // envs per block
constexpr int kThreads = 256;  // threads per block: 8 per env in the group phases
constexpr int kGroup = kThreads / kEnvs;

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ bool is_target(uint8_t v) {
  return v == BOX_ON_TARGET || v == TARGET || v == PLAYER_ON_TARGET;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the flat bank row of a fresh episode, and its cursor and cap
__device__ __forceinline__ long long fresh_episode(const SokobanArgs& a,
                                                   threefry::Key key,
                                                   int32_t cursor,
                                                   int32_t* cursor2,
                                                   int32_t* cap) {
  // _fresh_episode's split: the level's key and the cap's
  long long flat;
  if (a.sequential) {
    int32_t r = cursor % a.n_eff;  // a floor mod, as torch.remainder
    flat = r < 0 ? r + a.n_eff : r;
    *cursor2 = add_wrap(cursor, a.num_envs);
  } else {
    const threefry::Key klvl = threefry::split2(key, 0u);
    const int32_t f = threefry::randint(threefry::split2(klvl, 0u), 0, a.n_files);
    const int32_t len = a.file_len[f];
    const int32_t l = threefry::randint(threefry::split2(klvl, 1u), 0, 1 << 30);
    int32_t r = len > 0 ? l % len : 0;
    if (r < 0) r += len;
    flat = a.file_start[f] + r;
    *cursor2 = cursor;
  }
  if (a.cap_span == 0u) {
    *cap = a.cap_hi;
  } else {
    const uint32_t bits = threefry::bits(threefry::split2(key, 1u));
    *cap = static_cast<int32_t>(a.cap_lo + bits % a.cap_span);
  }
  return flat;
}

// obs byte o of the block's run ([env][channel][cell]) from its world tile
__device__ __forceinline__ uint8_t render_byte(const uint8_t* tile,
                                               const uint8_t* pal, int dd,
                                               int o) {
  const int e = o / (3 * dd);
  const int r = o - e * 3 * dd;
  const int ch = r / dd;
  const uint8_t v = tile[e * dd + (r - ch * dd)];
  return v < kTiles ? pal[3 * v + ch] : 0;
}

// four tile bytes -> their four palette bytes of channel ch. The palette
// by channel as byte-permute tables: byte v of {hi, lo} is kPalette's value
// for tile v, byte 7 (and every code clamped to 7) is 0.
__device__ __forceinline__ uint32_t render_word(uint32_t w, int ch) {
  const uint32_t m = __vminu4(w, 0x07070707u);
  const uint32_t sel = (m & 0x7u) | ((m >> 4) & 0x70u) | ((m >> 8) & 0x700u) |
                       ((m >> 12) & 0x7000u);
  const uint32_t lo = ch == 0 ? 0xFEFEF300u : (ch == 1 ? 0x5F7EF800u : 0x387DEE00u);
  const uint32_t hi = ch == 0 ? 0x00DBA08Eu : (ch == 1 ? 0x00D4D479u : 0x00383838u);
  return __byte_perm(lo, hi, sel);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 4)
sokoban_kernel(const SokobanArgs a) {
  extern __shared__ __align__(16) uint8_t tile[];  // kEnvs worlds, D*D each
  __shared__ long long fresh_row[kEnvs];  // a fresh lane's bank row, else -1
  __shared__ uint8_t palette[kTiles * 3];
  const int dim = a.dim, dd = dim * dim;
  const long long base = static_cast<long long>(blockIdx.x) * kEnvs;
  const int ne = static_cast<int>(min(static_cast<long long>(kEnvs), a.n - base));
  const int t = threadIdx.x;
  if (t < kTiles * 3) palette[t] = kPalette[t];

  // 1. lane t's scalars as coalesced rows, issued before the worlds' loads
  const bool lane = t < ne;
  const long long e = base + t;
  int32_t act = 0, r0 = 0, c0 = 0, unmatched = 0, steps = 0, cap = 0,
          cursor = 0, fidx = 0, lidx = 0, elapsed0 = 0;
  int64_t kw0 = 0, kw1 = 0;
  bool done0 = false, in_mask = true;
  if (lane) {
    const int64_t* k = a.keys + e * a.key_stride;
    kw0 = k[0];
    kw1 = k[a.key_col];
    cursor = a.cursor[e];
    if (kMode != kReset) {
      act = a.action[e];
      r0 = a.player[2 * e];
      c0 = a.player[2 * e + 1];
      unmatched = a.unmatched[e];
      steps = a.steps[e];
      cap = a.cap[e];
      fidx = a.file_idx[e];
      lidx = a.level_idx[e];
    }
    if (kMode == kAdvance) {
      elapsed0 = a.elapsed_in[e];
      done0 = a.done_in[e];
      if (a.mask != nullptr) in_mask = a.mask[e];
    }
  }

  // 2. the block's worlds into shared memory, one contiguous run, unless
  // every lane of the launch is fresh
  const bool need_world =
      kMode == kStep || (kMode == kAdvance && (!a.force_reset || a.mask != nullptr));
  const int run = ne * dd;
  if (need_world) {
    const uint8_t* src = a.world + base * dd;
    int done_bytes = 0;
    if (aligned16(a.world)) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(tile);
      for (int q = t; q < run / 16; q += kThreads) d4[q] = __ldg(s4 + q);
      done_bytes = run / 16 * 16;
    }
    for (int c = done_bytes + t; c < run; c += kThreads) tile[c] = __ldg(src + c);
  }
  __syncthreads();

  // 3. lane t (warp 0): the step's rules in its tile, the fresh episode's
  // draws, the lane's outputs but a fresh episode's player and box count
  long long row = -1;
  int32_t fidx2 = fidx, lidx2 = lidx;
  if (lane) {
    const threefry::Key key{threefry::word(kw0), threefry::word(kw1)};
    const bool keep = kMode == kAdvance && !in_mask;
    const bool reset_lane =
        kMode == kReset || (kMode == kAdvance && !keep && (a.force_reset || done0));
    bool fresh = reset_lane, done = false, trunc = false;
    float reward = 0.0f;
    int32_t pr = r0, pc = c0, unmatched2 = unmatched, steps2 = steps;
    int32_t elapsed = kMode == kAdvance && keep ? elapsed0 : 0;
    if (!keep && !reset_lane) {
      uint8_t* w = tile + t * dd;
      const bool noop = act < 0;
      const int ac = act < 0 ? 0 : (act > 3 ? 3 : act);
      const int32_t dr = kDelta[2 * ac], dc = kDelta[2 * ac + 1];
      const int32_t r1 = add_wrap(r0, dr), c1 = add_wrap(c0, dc);
      const int32_t r2 = add_wrap(r0, 2 * dr), c2 = add_wrap(c0, 2 * dc);
      const bool in0 = r0 >= 0 && r0 < dim && c0 >= 0 && c0 < dim;
      const bool in1 = r1 >= 0 && r1 < dim && c1 >= 0 && c1 < dim;
      const bool in2 = r2 >= 0 && r2 < dim && c2 >= 0 && c2 < dim;
      const int f0 = r0 * dim + c0, f1 = r1 * dim + c1, f2 = r2 * dim + c2;
      const uint8_t a0 = in0 ? w[f0] : WALL;
      const uint8_t a1 = in1 ? w[f1] : WALL;
      const uint8_t a2 = in2 ? w[f2] : WALL;
      const bool box_moves = (a1 == BOX || a1 == BOX_ON_TARGET) && (a2 == EMPTY || a2 == TARGET);
      const bool agent_moves = a1 == EMPTY || a1 == TARGET || box_moves;
      const bool t0 = is_target(a0), t1 = is_target(a1), t2 = is_target(a2);
      const bool do_move = agent_moves && !noop;
      const int32_t d = (box_moves && do_move) ? int32_t(t1) - int32_t(t2) : 0;
      unmatched2 = add_wrap(unmatched, d);
      steps2 = add_wrap(steps, noop ? 0 : 1);
      const bool solved = unmatched2 == 0;
      // the JAX package's order: (step + box * (-d)) + finished
      reward = __fadd_rn(__fadd_rn(a.reward_step, __fmul_rn(a.reward_box, float(-d))),
                         solved ? a.reward_finished : 0.0f);
      if (noop) reward = __int_as_float(0x7fc00000);
      done = solved || steps2 >= cap;
      trunc = done && !solved;
      elapsed = steps2;
      fresh = done;
      if (!done && do_move) {
        if (in2) w[f2] = box_moves ? (t2 ? BOX_ON_TARGET : BOX) : a2;
        if (in1) w[f1] = t1 ? PLAYER_ON_TARGET : PLAYER;
        if (in0) w[f0] = t0 ? TARGET : EMPTY;
        pr = r1;
        pc = c1;
      }
    }
    int32_t cap2 = cap, cursor2 = cursor;
    if (fresh) {
      // advance mode: the step's key, sub of the pool's (carry, sub) split
      const threefry::Key sub = kMode == kAdvance ? threefry::split2(key, 1u) : key;
      row = fresh_episode(a, sub, cursor, &cursor2, &cap2);
      // in flight across the barriers; stored at the end
      fidx2 = a.bank_file_idx[row];
      lidx2 = a.bank_level_idx[row];
      steps2 = 0;
    } else {
      a.player_out[2 * e] = pr;
      a.player_out[2 * e + 1] = pc;
      a.unmatched_out[e] = unmatched2;
    }
    a.steps_out[e] = steps2;
    a.cap_out[e] = cap2;
    a.cursor_out[e] = cursor2;
    if (kMode != kReset) {
      // the pool's epilogue zeroes a reset lane's (all zero already)
      a.reward[e] = reward;
      a.done[e] = done;
      a.trunc[e] = trunc;
    }
    if (kMode == kAdvance) {
      a.step_type[e] = elapsed == 0 ? 0 : (done ? 2 : 1);
      a.discount[e] = done ? 0.0f : 1.0f;
      a.done_carry[e] = keep && done0;
      const threefry::Key carry = threefry::split2(key, 0u);
      a.rng_out[2 * e] = keep ? kw0 : static_cast<int64_t>(carry.a);
      a.rng_out[2 * e + 1] = keep ? kw1 : static_cast<int64_t>(carry.b);
    }
    a.elapsed[e] = elapsed;
  }
  if (t < kEnvs) fresh_row[t] = row;
  __syncthreads();

  // 4. the fresh lanes' bank rows, a group of 8 threads per env: copied
  // into the tile with every load issued before any is used, and scanned
  // for the player and the boxes on the way
  {
    const int g = t / kGroup, j = t % kGroup;
    const long long src_row = fresh_row[g];
    int first = INT_MAX, boxes = 0;
    if (src_row >= 0) {
      const uint8_t* src = a.levels + src_row * dd;
      uint8_t* dst = tile + g * dd;
      if ((dd & 3) == 0 && (reinterpret_cast<uintptr_t>(a.levels) & 3u) == 0) {
        const int units = dd >> 2;
        const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
        uint32_t* d32 = reinterpret_cast<uint32_t*>(dst);
        for (int u0 = j; u0 < units; u0 += 4 * kGroup) {
          uint32_t v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = u0 + k * kGroup;
            v[k] = u < units ? __ldg(s32 + u) : 0u;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = u0 + k * kGroup;
            if (u < units) {
              d32[u] = v[k];
              boxes += __popc(__vcmpeq4(v[k], 0x04040404u)) >> 3;
              const uint32_t pm =
                  __vcmpeq4(v[k], 0x05050505u) | __vcmpeq4(v[k], 0x06060606u);
              if (pm != 0u) first = min(first, 4 * u + ((__ffs(pm) - 1) >> 3));
            }
          }
        }
      } else {
        for (int c = j; c < dd; c += kGroup) {
          const uint8_t v = __ldg(src + c);
          dst[c] = v;
          boxes += v == BOX;
          if (v == PLAYER || v == PLAYER_ON_TARGET) first = min(first, c);
        }
      }
    }
    // the group's results; every lane of the warp takes part
#pragma unroll
    for (int o = 1; o < kGroup; o <<= 1) {
      first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
      boxes += __shfl_xor_sync(0xffffffffu, boxes, o);
    }
    if (src_row >= 0 && j == 0) {
      const long long ge = base + g;
      const int pos = first == INT_MAX ? 0 : first;
      a.player_out[2 * ge] = pos / dim;
      a.player_out[2 * ge + 1] = pos % dim;
      a.unmatched_out[ge] = boxes;
    }
  }
  __syncthreads();

  // 5. the worlds and their renders out as contiguous runs
  {
    uint8_t* wo = a.world_out + base * dd;
    int done_bytes = 0;
    if (aligned16(a.world_out)) {
      const uint4* s4 = reinterpret_cast<const uint4*>(tile);
      uint4* d4 = reinterpret_cast<uint4*>(wo);
      for (int q = t; q < run / 16; q += kThreads) d4[q] = s4[q];
      done_bytes = run / 16 * 16;
    }
    for (int c = done_bytes + t; c < run; c += kThreads) wo[c] = tile[c];

    uint8_t* o = a.obs + base * 3 * dd;
    const int n_obs = 3 * run;
    done_bytes = 0;
    if ((dd & 3) == 0 && aligned16(a.obs)) {
      // 16 obs bytes = 4 words, each four cells of one channel of one env
      const int dq = dd >> 2, dq3 = 3 * dq;
      const uint32_t* t32 = reinterpret_cast<const uint32_t*>(tile);
      uint4* o4 = reinterpret_cast<uint4*>(o);
      for (int q = t; q < n_obs / 16; q += kThreads) {
        const int w0 = 4 * q;
        int env = w0 / dq3;
        const int r = w0 - env * dq3;
        int ch = r / dq;
        int cw = r - ch * dq;
        uint32_t out[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          out[k] = render_word(t32[env * dq + cw], ch);
          if (++cw == dq) {
            cw = 0;
            if (++ch == 3) {
              ch = 0;
              ++env;
            }
          }
        }
        o4[q] = make_uint4(out[0], out[1], out[2], out[3]);
      }
      done_bytes = n_obs / 16 * 16;
    }
    for (int c = done_bytes + t; c < n_obs; c += kThreads) {
      o[c] = render_byte(tile, palette, dd, c);
    }
  }
  if (lane) {
    a.file_idx_out[e] = fidx2;
    a.level_idx_out[e] = lidx2;
  }
}

}  // namespace

// mode 0: SokobanEnv.step; 1: SokobanEnv.reset (every lane fresh, no
// action, reward, done or trunc); 2: the pool's advance. Returns the CUDA
// error of the launch (0 when n is 0).
extern "C" int sokoban_launch(const SokobanArgs* args, int mode, void* stream) {
  if (args->n <= 0) return 0;
  if (mode < kStep || mode > kAdvance || args->dim < 1 || args->dim > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kEnvs) * args->dim * args->dim;
  const int blocks = (args->n + kEnvs - 1) / kEnvs;
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == kStep) {
    sokoban_kernel<kStep><<<blocks, kThreads, smem, s>>>(*args);
  } else if (mode == kReset) {
    sokoban_kernel<kReset><<<blocks, kThreads, smem, s>>>(*args);
  } else {
    sokoban_kernel<kAdvance><<<blocks, kThreads, smem, s>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}
