// Threefry-2x32, jax's default key stream, as device functions (sm_90a).
//
// Shared by threefry.cu (one launch per split / random_bits / fold_in call)
// and sokoban_step.cu (the fused step draws its next episode in-kernel).
// Bit for bit the port's plain core/prng.py, which is jax 0.9.0's
// threefry_2x32 under jax_threefry_partitionable=True:
//
//   hash      20 rounds, rotations (13, 15, 26, 6) / (17, 29, 16, 24), the
//             key injected every 4 rounds (prng.py::threefry2x32);
//   split2    the two keys of split(key, 2): counters (0, 0) and (0, 1);
//   bits      random_bits(key, ()): the xor of the two words of counter
//             (0, 0);
//   randint   randint(key, (), lo, hi) for lo, hi in the int32 range: two
//             words from the halves of split(key), combined modulo the
//             span with jax's multiplier (prng.py::randint).
//
// All arithmetic is uint32 and wraps, as jax's uint32 lanes do: the port's
// `(a + b) & M32` on int64 words is plain uint32 addition here. Keys come in
// as int64 words holding uint32 values; the caller takes their low 32 bits
// (no sign extension can occur, the values are below 2^32).

#pragma once

#include <cstdint>

namespace threefry {

struct Key {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// four rounds with the given rotations: x0 += x1; x1 = rotl(x1, r) ^ x0
__device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1, int r0,
                                        int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// Threefry-2x32 of counter (x0, x1) under key k
__device__ __forceinline__ Key hash(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k.a ^ k.b ^ 0x1BD11BDAu;
  x0 += k.a; x1 += k.b;
  rounds4(x0, x1, 13, 15, 26, 6);  x0 += k.b; x1 += k2 + 1u;
  rounds4(x0, x1, 17, 29, 16, 24); x0 += k2;  x1 += k.a + 2u;
  rounds4(x0, x1, 13, 15, 26, 6);  x0 += k.a; x1 += k.b + 3u;
  rounds4(x0, x1, 17, 29, 16, 24); x0 += k.b; x1 += k2 + 4u;
  rounds4(x0, x1, 13, 15, 26, 6);  x0 += k2;  x1 += k.a + 5u;
  return {x0, x1};
}

// split(key, 2)[i]
__device__ __forceinline__ Key split2(Key k, uint32_t i) { return hash(k, 0u, i); }

// random_bits(key, ()) in 32 bits
__device__ __forceinline__ uint32_t bits(Key k) {
  const Key h = hash(k, 0u, 0u);
  return h.a ^ h.b;
}

// randint(key, (), lo, hi) as int32, for lo and hi in the int32 range
__device__ __forceinline__ int32_t randint(Key k, int32_t lo, int32_t hi) {
  const uint32_t higher = bits(split2(k, 0u));
  const uint32_t lower = bits(split2(k, 1u));
  const uint32_t span =
      hi > lo ? static_cast<uint32_t>(hi) - static_cast<uint32_t>(lo) : 1u;
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t offset = ((higher % span) * mult + lower % span) % span;
  return static_cast<int32_t>(static_cast<uint32_t>(lo) + offset);
}

// an int64 key word holding a uint32 value
__device__ __forceinline__ uint32_t word(int64_t w) {
  return static_cast<uint32_t>(static_cast<uint64_t>(w));
}

}  // namespace threefry
