// CarRacing background sampler for Hopper (sm_90a).
//
// Replaces envpool_tpu/envs/box2d/car_racing.py::_fused_render_kernel (with
// its launcher _fused_sample_batched). That Pallas kernel DMAs an S x S
// window of the palette+1 track bank into VMEM, applies four circular shears
// (row by s1, column by s2, row by s3, column by s4) as barrel shifts, and
// picks rows[96] x cols[96] out of the result with one-hot matmuls.
//
// Here the same function is computed in closed form, one thread per output
// pixel. Output pixel (i, j) of env e starts at r = rows[i], c = cols[j]
// (0 if either lies outside [0, S)), walks back through the shears, each
// step mod S and indexing with the value just updated:
//   r -= s4[c];  c -= s3[r];  r -= s2[c];  c -= s1[r];
// and loads bank[8 * scal[e,0] + r, 128 * scal[e,1] + c].
//
// Bound: bytes. Per env it reads the four shift rows (4*S int32), rows and
// cols (2*96 int32), one bank byte per pixel, and writes 96*96 bytes; there is
// no arithmetic to speak of. The window copy and the one-hot matmuls existed
// only because the TPU serializes gathers; the card gathers natively, so the
// window is never copied: each block stages its env's shift rows in shared
// memory (6 KiB at S = 384) and each thread makes one load from the bank,
// which (32 MiB fine, 2 MiB coarse at 8 tracks) stays in the 50 MB L2.
//
// The output is the palette index + 1 as uint8, 0 meaning black: the same
// values as the Pallas kernel's exact-integer float32 output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap(long long x, int s) {
  long long m = x % s;
  return static_cast<int>(m < 0 ? m + s : m);
}

__global__ void __launch_bounds__(kThreads) car_racing_sample_kernel(
    const uint8_t* __restrict__ bank, long long bank_rows, int bank_cols,
    const int32_t* __restrict__ scal, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, const int32_t* __restrict__ s3,
    const int32_t* __restrict__ s4, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ cols, uint8_t* __restrict__ out, int s, int h,
    int w) {
  extern __shared__ int32_t smem[];
  int32_t* sh1 = smem;
  int32_t* sh2 = sh1 + s;
  int32_t* sh3 = sh2 + s;
  int32_t* sh4 = sh3 + s;
  int32_t* shr = sh4 + s;
  int32_t* shc = shr + h;

  const long long e = blockIdx.x;
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    sh1[i] = s1[e * s + i];
    sh2[i] = s2[e * s + i];
    sh3[i] = s3[e * s + i];
    sh4[i] = s4[e * s + i];
  }
  for (int i = threadIdx.x; i < h; i += blockDim.x) shr[i] = rows[e * h + i];
  for (int i = threadIdx.x; i < w; i += blockDim.x) shc[i] = cols[e * w + i];
  __syncthreads();

  const long long r0 = 8LL * scal[2 * e];
  const long long c0 = 128LL * scal[2 * e + 1];
  const bool window_ok =
      r0 >= 0 && r0 + s <= bank_rows && c0 >= 0 && c0 + s <= bank_cols;
  uint8_t* o = out + e * h * w;
  for (int p = threadIdx.x; p < h * w; p += blockDim.x) {
    int r = shr[p / w];
    int c = shc[p % w];
    uint8_t v = 0;
    if (window_ok && r >= 0 && r < s && c >= 0 && c < s) {
      r = wrap(static_cast<long long>(r) - sh4[c], s);
      c = wrap(static_cast<long long>(c) - sh3[r], s);
      r = wrap(static_cast<long long>(r) - sh2[c], s);
      c = wrap(static_cast<long long>(c) - sh1[r], s);
      v = bank[(r0 + r) * bank_cols + c0 + c];
    }
    o[p] = v;
  }
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success).
extern "C" int car_racing_sample(const void* bank, long long bank_rows,
                                 int bank_cols, const void* scal,
                                 const void* s1, const void* s2,
                                 const void* s3, const void* s4,
                                 const void* rows, const void* cols, void* out,
                                 int n, int s, int h, int w, void* stream) {
  if (n == 0) return 0;
  const size_t smem = (4 * static_cast<size_t>(s) + h + w) * sizeof(int32_t);
  car_racing_sample_kernel<<<n, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bank), bank_rows, bank_cols,
      static_cast<const int32_t*>(scal), static_cast<const int32_t*>(s1),
      static_cast<const int32_t*>(s2), static_cast<const int32_t*>(s3),
      static_cast<const int32_t*>(s4), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(cols), static_cast<uint8_t*>(out), s, h, w);
  return static_cast<int>(cudaGetLastError());
}
