// The fused Sokoban step and reset for Hopper (sm_90a): one launch per
// SokobanEnv.step or SokobanEnv.reset of envs/sokoban/sokoban.py.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses SokobanEnv.step and reset
// of envpool_tpu/envs/sokoban/sokoban.py (step :289, _fresh_episode :240,
// _load_level :173, _sample_cap :228, _render :394) into a few kernels under
// the pool's env_resets branch (envpool_tpu/core/pool.py:215-241). The port's
// plain version (sokoban.py's step_plain / reset_plain) is ~450 launches of
// its own plus the threefry calls, ~2,010 launches an eager step. Per env it
// computes what step_plain and reset_plain compute, bit for bit:
//
//   step   the action clamped to [0, 3], < 0 a noop; the three cells p0,
//          p0 + d, p0 + 2d read (out of bounds reads as WALL); the push and
//          move rules; the three writes, each made only in bounds and when
//          the agent moves; unmatched, steps (a noop does not count), the
//          float32 reward (step + box * (-d_unmatched)) + finished, NaN on
//          a noop, done, trunc, and elapsed_step, the finishing episode's
//          counter;
//   fresh  on done (every lane in reset mode) the next episode: the level
//          from the [n_levels, D, D] bank (sequential mode: the int32
//          cursor's floor mod, the cursor advanced by num_envs with int32
//          wrap; random mode: the file and the level drawn with randint of
//          threefry.cuh), the player at the first PLAYER or PLAYER_ON_TARGET
//          cell (0 if none), the BOX count, steps 0, the cap drawn from the
//          threefry stream (bits % span, with int32 wraps; the constant hi
//          when lo >= hi);
//   render the [3, D, D] palette image of the world after the step and reset.
//
// The eager code draws every lane's fresh episode and selects by done; here
// only the lanes that need one draw it. The results are the same, since
// each draw depends only on the lane's key and cursor.
//
// What bounds it: bytes. Per env it reads its state (D*D + 32 bytes), its
// action and key, a bank row on a fresh episode, and writes the world, the
// obs (3 D*D) and 30 bytes of scalars: about 560 bytes at D = 10, 9.2 MB at
// 16,384 envs, 2.7 us at 3.35 TB/s; a fresh lane hashes 13 threefry blocks
// in random mode (2 in sequential), ~1,600 32-bit operations. What the
// design does about it: one thread per env decides the step, draws the
// fresh episode and writes the per-env scalars (coalesced int32 rows); the
// block's worlds, 128 envs of D*D bytes each (12.8 KB at D = 10), are then
// staged in shared memory, a warp per env row: each world row or bank row
// is read as one contiguous run, the three writes are applied in shared
// memory, and the block writes its worlds and obs rows back as contiguous
// runs, so no thread walks a 100-byte world row or a 300-byte obs row alone.
// Only the 3 cell reads of the step and the player scan of a fresh world
// are per-thread (the scan from shared memory, conflict-free at odd D*D/4).
// Envs per block shrink for large D (at least a warp; D <= 32).

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
  // lane e's key: keys[e * key_stride], keys[e * key_stride + key_col]
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
};

namespace {

// tile codes (level_loader.py) and the tiny-world palette (sokoban.py)
constexpr uint8_t WALL = 0, EMPTY = 1, TARGET = 2, BOX_ON_TARGET = 3, BOX = 4,
                  PLAYER = 5, PLAYER_ON_TARGET = 6;
constexpr int kTiles = 7;
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

constexpr int kMaxThreads = 128;
constexpr int kSmemBudget = 48 * 1024;
// shared bytes per env besides its world: the source row, 3 writes, a flag
constexpr int kPerEnv = sizeof(void*) + 3 * sizeof(int) + 1;
constexpr int kNoWrite = -1;

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ bool is_target(uint8_t v) {
  return v == BOX_ON_TARGET || v == TARGET || v == PLAYER_ON_TARGET;
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

template <bool kReset>
__global__ void __launch_bounds__(kMaxThreads)
sokoban_kernel(const SokobanArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint8_t palette[kTiles * 3];
  const int envs = blockDim.x;
  const int dim = a.dim, dd = dim * dim;
  const uint8_t** src = reinterpret_cast<const uint8_t**>(smem);
  int* writes = reinterpret_cast<int*>(smem + envs * sizeof(void*));
  uint8_t* fresh = smem + envs * (sizeof(void*) + 3 * sizeof(int));
  uint8_t* tile = fresh + envs;
  const long long base = static_cast<long long>(blockIdx.x) * envs;
  const int ne = static_cast<int>(min(static_cast<long long>(envs), a.n - base));
  const int t = threadIdx.x;
  if (t < kTiles * 3) palette[t] = kPalette[t];

  // 1. one thread per env: the step's rules and the fresh episode's draws
  if (t < ne) {
    const long long e = base + t;
    bool is_fresh = kReset;
    int w0 = kNoWrite, w1 = kNoWrite, w2 = kNoWrite;
    if (!kReset) {
      const uint8_t* row = a.world + e * dd;
      const int32_t act = a.action[e];
      const bool noop = act < 0;
      const int ac = act < 0 ? 0 : (act > 3 ? 3 : act);
      const int32_t dr = kDelta[2 * ac], dc = kDelta[2 * ac + 1];
      const int32_t r0 = a.player[2 * e], c0 = a.player[2 * e + 1];
      const int32_t r1 = add_wrap(r0, dr), c1 = add_wrap(c0, dc);
      const int32_t r2 = add_wrap(r0, 2 * dr), c2 = add_wrap(c0, 2 * dc);
      const bool in0 = r0 >= 0 && r0 < dim && c0 >= 0 && c0 < dim;
      const bool in1 = r1 >= 0 && r1 < dim && c1 >= 0 && c1 < dim;
      const bool in2 = r2 >= 0 && r2 < dim && c2 >= 0 && c2 < dim;
      const int f0 = r0 * dim + c0, f1 = r1 * dim + c1, f2 = r2 * dim + c2;
      const uint8_t a0 = in0 ? row[f0] : WALL;
      const uint8_t a1 = in1 ? row[f1] : WALL;
      const uint8_t a2 = in2 ? row[f2] : WALL;
      const bool box_moves = (a1 == BOX || a1 == BOX_ON_TARGET) && (a2 == EMPTY || a2 == TARGET);
      const bool agent_moves = a1 == EMPTY || a1 == TARGET || box_moves;
      const bool t0 = is_target(a0), t1 = is_target(a1), t2 = is_target(a2);
      const bool do_move = agent_moves && !noop;
      const int32_t d = (box_moves && do_move) ? int32_t(t1) - int32_t(t2) : 0;
      const int32_t unmatched2 = add_wrap(a.unmatched[e], d);
      const int32_t steps2 = add_wrap(a.steps[e], noop ? 0 : 1);
      const bool solved = unmatched2 == 0;
      // the JAX package's order: (step + box * (-d)) + finished
      float reward = __fadd_rn(__fadd_rn(a.reward_step, __fmul_rn(a.reward_box, float(-d))),
                               solved ? a.reward_finished : 0.0f);
      if (noop) reward = __int_as_float(0x7fc00000);
      const bool done = solved || steps2 >= a.cap[e];
      a.reward[e] = reward;
      a.done[e] = done;
      a.trunc[e] = done && !solved;
      a.elapsed[e] = steps2;
      is_fresh = done;
      if (!done) {
        if (do_move) {
          if (in2) w2 = (f2 << 8) | (box_moves ? (t2 ? BOX_ON_TARGET : BOX) : a2);
          if (in1) w1 = (f1 << 8) | (t1 ? PLAYER_ON_TARGET : PLAYER);
          if (in0) w0 = (f0 << 8) | (t0 ? TARGET : EMPTY);
        }
        a.player_out[2 * e] = do_move ? r1 : r0;
        a.player_out[2 * e + 1] = do_move ? c1 : c0;
        a.unmatched_out[e] = unmatched2;
        a.steps_out[e] = steps2;
        a.cap_out[e] = a.cap[e];
        a.cursor_out[e] = a.cursor[e];
        a.file_idx_out[e] = a.file_idx[e];
        a.level_idx_out[e] = a.level_idx[e];
        src[t] = row;
      }
    }
    if (is_fresh) {
      const int64_t* k = a.keys + e * a.key_stride;
      const threefry::Key key{threefry::word(k[0]), threefry::word(k[a.key_col])};
      int32_t cursor2, cap;
      const long long flat = fresh_episode(a, key, a.cursor[e], &cursor2, &cap);
      a.steps_out[e] = 0;
      a.cap_out[e] = cap;
      a.cursor_out[e] = cursor2;
      a.file_idx_out[e] = a.bank_file_idx[flat];
      a.level_idx_out[e] = a.bank_level_idx[flat];
      if (kReset) a.elapsed[e] = 0;
      src[t] = a.levels + flat * dd;
    }
    writes[3 * t] = w2;
    writes[3 * t + 1] = w1;
    writes[3 * t + 2] = w0;
    fresh[t] = is_fresh;
  }
  __syncthreads();

  // 2. the block's worlds into shared memory, a warp per row
  const int warp = t >> 5, lane = t & 31, warps = envs >> 5;
  for (int i = warp; i < ne; i += warps) {
    const uint8_t* s = src[i];
    uint8_t* dst = tile + i * dd;
    for (int c = lane; c < dd; c += 32) dst[c] = __ldg(s + c);
  }
  __syncthreads();

  // 3. one thread per env: the step's writes, or the fresh world's scan
  if (t < ne) {
    uint8_t* w = tile + t * dd;
    if (fresh[t]) {
      int pos = -1;
      int32_t boxes = 0;
      for (int c = 0; c < dd; ++c) {
        const uint8_t v = w[c];
        if (pos < 0 && (v == PLAYER || v == PLAYER_ON_TARGET)) pos = c;
        boxes += v == BOX;
      }
      if (pos < 0) pos = 0;
      const long long e = base + t;
      a.player_out[2 * e] = pos / dim;
      a.player_out[2 * e + 1] = pos % dim;
      a.unmatched_out[e] = boxes;
    } else {
      for (int j = 0; j < 3; ++j) {
        const int wr = writes[3 * t + j];
        if (wr != kNoWrite) w[wr >> 8] = static_cast<uint8_t>(wr & 0xff);
      }
    }
  }
  __syncthreads();

  // 4. the worlds and their renders out, a warp per row
  for (int i = warp; i < ne; i += warps) {
    const uint8_t* w = tile + i * dd;
    uint8_t* wo = a.world_out + (base + i) * dd;
    uint8_t* o = a.obs + (base + i) * 3 * dd;
    for (int c = lane; c < dd; c += 32) {
      const uint8_t v = w[c];
      wo[c] = v;
      const bool known = v < kTiles;
      o[c] = known ? palette[3 * v] : 0;
      o[dd + c] = known ? palette[3 * v + 1] : 0;
      o[2 * dd + c] = known ? palette[3 * v + 2] : 0;
    }
  }
}

// Envs per block for a world of dim x dim: 128, fewer (in warps) where
// their worlds would pass 48 KB of shared memory.
int envs_per_block(int dim) {
  int envs = kMaxThreads;
  while (envs > 32 && envs * (dim * dim + kPerEnv) > kSmemBudget) envs -= 32;
  return envs;
}

}  // namespace

// reset != 0: every lane fresh (SokobanEnv.reset), no action, reward, done
// or trunc. Returns the CUDA error of the launch (0 when n is 0).
extern "C" int sokoban_launch(const SokobanArgs* args, int reset, void* stream) {
  if (args->n <= 0) return 0;
  const int envs = envs_per_block(args->dim);
  const size_t smem = static_cast<size_t>(envs) * (args->dim * args->dim + kPerEnv);
  const int blocks = (args->n + envs - 1) / envs;
  const auto s = static_cast<cudaStream_t>(stream);
  if (reset) {
    sokoban_kernel<true><<<blocks, envs, smem, s>>>(*args);
  } else {
    sokoban_kernel<false><<<blocks, envs, smem, s>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}
