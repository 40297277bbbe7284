// Threefry-2x32 for Hopper (sm_90a): one launch per split, random_bits or
// fold_in call of core/prng.py.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses jax's threefry_2x32 into
// the few kernels of each jitted step (reached through
// envpool_tpu/core/pool.py::_split_keys and every family's draws). The port's
// plain version (prng.py::threefry2x32) is about 180 elementwise int64 ops a
// call, each a launch in an eager or captured step: 1,554 of an eager
// Sokoban step's ~2,010 launches.
//
// One thread per output element g of n_keys x n_ctr: b = g / n_ctr is the
// key, i = g % n_ctr the counter index. The counter is (0, c + i), where c
// is data[b] (the fold_in form, n_ctr = 1), or the constant `base` (the iota
// form of split and random_bits, base 0). The output is the pair
// interleaved, out[2g], out[2g + 1] (split, fold_in: [..., n, 2]), or the
// xor of the two words, out[g] (random_bits), as int64 words holding uint32
// values, the port's key layout. Keys are read through two strides (the
// flattened batch's and the key word's), so a view such as both[:, 0] of
// the pool's split needs no copy; a broadcast key has batch stride 0.
//
// What bounds it. Per element, 20 rounds of add, rotate and xor and 5 key
// injections, about 120 32-bit operations (chip_smoke.py's THREEFRY_OPS),
// against 8-16 bytes written and 16 bytes of key read per key: at the
// widths of the main path (16,384 keys, 1-2 counters) the work is well
// under a microsecond of either, so the launch is the cost. The design
// keeps it to one launch per call: no copy of a strided key batch, no
// counter tensor, no separate xor or stack; the rotations are funnel
// shifts; the index math is 32-bit (a 64-bit division costs as much as the
// hash), so a call takes fewer than 2^31 outputs.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
threefry_kernel(const int64_t* __restrict__ keys, long long key_stride,
                long long key_col, const void* __restrict__ data,
                int data_bytes, long long data_stride, uint32_t base,
                uint32_t n_ctr, uint32_t total, int pair,
                int64_t* __restrict__ out) {
  const uint32_t g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  const uint32_t b = g / n_ctr;
  const uint32_t i = g - b * n_ctr;
  const int64_t* key = keys + b * key_stride;
  const threefry::Key k{threefry::word(key[0]), threefry::word(key[key_col])};
  uint32_t c = base;
  if (data != nullptr) {
    const long long at = b * data_stride;
    c = data_bytes == 8 ? threefry::word(static_cast<const int64_t*>(data)[at])
                        : static_cast<uint32_t>(static_cast<const int32_t*>(data)[at]);
  }
  const threefry::Key h = threefry::hash(k, 0u, c + i);
  if (pair) {
    out[2 * static_cast<long long>(g)] = static_cast<int64_t>(h.a);
    out[2 * static_cast<long long>(g) + 1] = static_cast<int64_t>(h.b);
  } else {
    out[g] = static_cast<int64_t>(h.a ^ h.b);
  }
}

// nothing: the launch floor of threefry_kernel's grid
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

}  // namespace

// keys: n_keys keys, word 0 of key b at keys[b * key_stride], word 1
// key_col past it. data: null (counter base + i), or one int32 (data_bytes
// 4) or int64 (8) word per key at data[b * data_stride] (n_ctr must be 1).
// out: n_keys * n_ctr < 2^31 pairs (pair != 0) or xors, contiguous.
// Returns the CUDA error of the launch (0 when there is nothing to do).
extern "C" int threefry_launch(const void* keys, long long n_keys,
                               long long key_stride, long long key_col,
                               const void* data, int data_bytes,
                               long long data_stride, long long base,
                               long long n_ctr, int pair, void* out,
                               void* stream) {
  const long long total = n_keys * n_ctr;
  if (total <= 0) return 0;
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  threefry_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), key_stride, key_col, data, data_bytes,
      data_stride, static_cast<uint32_t>(static_cast<unsigned long long>(base)),
      static_cast<uint32_t>(n_ctr), static_cast<uint32_t>(total), pair,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of the grid that threefry_launch gives `total` outputs,
// for measurement only (chip_smoke.py phase 3 times it beside threefry's
// kernel: the launch floor of any one-launch design). Returns the CUDA error.
extern "C" int threefry_empty_launch(long long total, void* stream) {
  if (total <= 0 || total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  empty_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
