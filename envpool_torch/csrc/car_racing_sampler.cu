// CarRacing background for Hopper (sm_90a): one launch per render.
//
// Replaces envpool_tpu/envs/box2d/car_racing.py::_fused_render_kernel (with
// its launcher _fused_sample_batched), launched there twice per render (the
// fine bank, S = 384, and the coarse bank, S = 256), and the per-env select
// and palette passes after it (_render_v2_impl, :827-835). That Pallas kernel
// DMAs an S x S window of the palette+1 track bank into VMEM, applies four
// circular shears (row by s1, column by s2, row by s3, column by s4) as
// barrel shifts, and picks rows[96] x cols[96] out of the result with one-hot
// matmuls: all because the TPU serializes gathers.
//
// The card gathers natively, so the same function is computed in closed
// form. Per env, the block reads use_fine[e] and takes that path's inputs
// only. Output pixel (i, j) starts at r = rows[i], c = cols[j] (black if
// either lies outside [0, S)), walks back through the shears, each step mod S
// and indexing with the value just updated:
//   r -= s4[c];  c -= s3[r];  r -= s2[c];  c -= s1[r];
// loads v = bank[8 * scal[e,0] + r, 128 * scal[e,1] + c] and writes
// palette[v] (black for v >= P) as 3 bytes of the [N, 96, 96, 3] image.
//
// Bound: bytes. Per env it reads the chosen path's four shift rows (4 S
// int32), rows and cols (2 x 96 int32), at most one bank byte per pixel, and
// writes 96 x 96 x 3 bytes; about ten integer operations per pixel. What the
// design does about it:
//  - no `%` in the pixel loop: the block reduces each shift mod S once while
//    staging it in shared memory (int16, 3 KB at S = 384), so each step is a
//    32-bit subtract and a conditional add of S, exact for any int32 shift;
//  - 2-D work mapping from loop indices (the 96 x 96 size is a compile-time
//    constant): a thread owns 4 neighbouring columns of a row, so it has 4
//    independent gather chains in flight, and writes their 12 bytes as three
//    32-bit stores; a block's 192 threads write 8 whole rows, contiguous;
//  - a thread's columns are fixed, so the first step's lookup (s4 at the
//    column) is made once per thread: three shared lookups per pixel;
//  - the palette (<= 256 entries, packed RGB) sits in shared memory, so the
//    index image, its int64 copy and the select never reach device memory;
//  - the bank (32 MiB fine + 2 MiB coarse at 8 tracks) stays in the 50 MB L2
//    and is read with one read-only byte load per pixel.
// On the main path's inputs it runs at about half of the byte bound; the
// staging before the barrier and the chain of shared lookups take most of
// the rest (PERF.md). Unrolling the row loop measured slower.

#include <cstdint>
#include <cuda_runtime.h>

// One path's inputs; mirrored by sampler.py::_Path.
struct Path {
  const uint8_t* bank;
  long long bank_rows;
  int bank_cols;
  int s;
  const int32_t* scal;
  const int32_t* s1;
  const int32_t* s2;
  const int32_t* s3;
  const int32_t* s4;
  const int32_t* rows;
  const int32_t* cols;
};

namespace {

constexpr int kH = 96;                            // output rows
constexpr int kW = 96;                            // output columns
constexpr int kPix = 4;                           // columns per thread
constexpr int kGroups = kW / kPix;                // threads across a row
constexpr int kRowsPerPass = 8;                   // rows per block pass
constexpr int kThreads = kGroups * kRowsPerPass;  // 192
constexpr int kMaxPalette = 256;

// x mod S; the main path's shifts lie in (-S, S) and skip the division
__device__ __forceinline__ int16_t mod_s(int32_t x, int s) {
  if (x >= -s && x < s) return static_cast<int16_t>(x < 0 ? x + s : x);
  const int m = x % s;
  return static_cast<int16_t>(m < 0 ? m + s : m);
}

// x - sh with x, sh in [0, S): back into [0, S)
__device__ __forceinline__ int step(int x, int sh, int s) {
  x -= sh;
  return x + (x < 0 ? s : 0);
}

__global__ void __launch_bounds__(kThreads) car_racing_background_kernel(
    const Path fine, const Path coarse, const bool* __restrict__ use_fine,
    const uint8_t* __restrict__ palette, int n_palette,
    uint8_t* __restrict__ out) {
  extern __shared__ int16_t shifts[];  // 4 rows of S: s1, s2, s3, s4 mod S
  __shared__ int32_t rows_s[kH];       // -1 outside the window
  __shared__ int32_t cols_s[kW];
  __shared__ uint32_t pal_s[kMaxPalette];

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const bool f = use_fine[e];
  const int s = f ? fine.s : coarse.s;
  const uint8_t* bank = f ? fine.bank : coarse.bank;
  const long long bank_rows = f ? fine.bank_rows : coarse.bank_rows;
  const int bank_cols = f ? fine.bank_cols : coarse.bank_cols;
  const int32_t* scal = (f ? fine.scal : coarse.scal) + 2 * e;
  const long long base = static_cast<long long>(e) * s;
  const int32_t* s1 = (f ? fine.s1 : coarse.s1) + base;
  const int32_t* s2 = (f ? fine.s2 : coarse.s2) + base;
  const int32_t* s3 = (f ? fine.s3 : coarse.s3) + base;
  const int32_t* s4 = (f ? fine.s4 : coarse.s4) + base;
  const int32_t* rows = (f ? fine.rows : coarse.rows) + e * kH;
  const int32_t* cols = (f ? fine.cols : coarse.cols) + e * kW;

  const long long r0 = 8LL * scal[0];
  const long long c0 = 128LL * scal[1];
  const bool window_ok =
      r0 >= 0 && r0 + s <= bank_rows && c0 >= 0 && c0 + s <= bank_cols;

  int16_t* sh1 = shifts;
  int16_t* sh2 = sh1 + s;
  int16_t* sh3 = sh2 + s;
  int16_t* sh4 = sh3 + s;
  for (int i = tid; i < s; i += kThreads) {
    sh1[i] = mod_s(s1[i], s);
    sh2[i] = mod_s(s2[i], s);
    sh3[i] = mod_s(s3[i], s);
    sh4[i] = mod_s(s4[i], s);
  }
  for (int i = tid; i < kH; i += kThreads) {
    const int r = rows[i];
    rows_s[i] = window_ok && r >= 0 && r < s ? r : -1;
  }
  for (int i = tid; i < kW; i += kThreads) {
    const int c = cols[i];
    cols_s[i] = c >= 0 && c < s ? c : -1;
  }
  for (int i = tid; i < kMaxPalette; i += kThreads) {
    pal_s[i] = i < n_palette ? palette[3 * i] | palette[3 * i + 1] << 8 |
                                   palette[3 * i + 2] << 16
                             : 0u;
  }
  __syncthreads();

  // a window outside the bank is never read: every row is outside then
  const uint8_t* win = window_ok ? bank + r0 * bank_cols + c0 : bank;
  const int g = tid % kGroups;
  const int j0 = g * kPix;
  int c_in[kPix], sh4_c[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    c_in[k] = cols_s[j0 + k];
    sh4_c[k] = sh4[max(c_in[k], 0)];
  }
  uint8_t* o = out + static_cast<long long>(e) * (kH * kW * 3) + j0 * 3;
#pragma unroll 1
  for (int i = tid / kGroups; i < kH; i += kRowsPerPass) {
    const int r_in = rows_s[i];
    uint32_t rgb[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const bool inside = (r_in | c_in[k]) >= 0;
      int r = step(max(r_in, 0), sh4_c[k], s);
      int c = step(max(c_in[k], 0), sh3[r], s);
      r = step(r, sh2[c], s);
      c = step(c, sh1[r], s);
      const uint8_t v = __ldg(win + (inside ? r * bank_cols + c : 0));
      rgb[k] = inside ? pal_s[v] : 0u;
    }
    uint32_t* o32 = reinterpret_cast<uint32_t*>(o + i * (kW * 3));
    o32[0] = rgb[0] | rgb[1] << 24;
    o32[1] = rgb[1] >> 8 | rgb[2] << 16;
    o32[2] = rgb[2] >> 16 | rgb[3] << 8;
  }
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; `fine` and
// `coarse` point to host structs; `stream` is a cudaStream_t. Writes the
// [n, 96, 96, 3] uint8 background to `out`. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int car_racing_background(const Path* fine, const Path* coarse,
                                     const void* use_fine, const void* palette,
                                     int n_palette, void* out, int n,
                                     void* stream) {
  if (n == 0) return 0;
  const int s_max = fine->s > coarse->s ? fine->s : coarse->s;
  const size_t smem = 4 * static_cast<size_t>(s_max) * sizeof(int16_t);
  car_racing_background_kernel<<<n, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      *fine, *coarse, static_cast<const bool*>(use_fine),
      static_cast<const uint8_t*>(palette), n_palette,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
