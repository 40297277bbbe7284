// A host function in a CUDA stream, for the host tier's bridge (sm_90a).
//
// Replaces no Pallas kernel and holds no device code. It is the Hopper
// counterpart of jax.experimental.io_callback(..., ordered=True), through
// which the JAX package's HostEnvPool.xla() (envpool_tpu/core/host_pool.py)
// runs its host step inside a compiled loop. core/host_pool.py queues, on
// the caller's stream:
//
//   host_func_copy    the action and env_id from the card into page-locked
//                     memory (cudaMemcpyAsync);
//   host_func_launch  the host step, a Python function bound as a ctypes
//                     callback (cudaLaunchHostFunc);
//   host_func_copy    every output column from page-locked memory into
//                     fresh device tensors.
//
// Eagerly these are stream-ordered operations; while the stream is
// capturing they become two memcpy nodes around a host node of the CUDA
// graph, replayed in that order. The callback may make no CUDA call, and it
// takes the GIL on CUDA's callback thread, so no thread may wait for the
// stream while it holds the GIL.

#include <cstddef>
#include <cuda_runtime.h>

// the stream-ordered callback: fn(data) on CUDA's callback thread
extern "C" int host_func_launch(void* stream, void (*fn)(void*), void* data) {
  return static_cast<int>(cudaLaunchHostFunc(static_cast<cudaStream_t>(stream),
                                             fn, data));
}

// to_device 1: host -> device, 0: device -> host; the host side must be
// page-locked (a pageable copy cannot be captured)
extern "C" int host_func_copy(void* stream, void* dst, const void* src,
                              size_t bytes, int to_device) {
  if (bytes == 0) return 0;
  return static_cast<int>(cudaMemcpyAsync(
      dst, src, bytes,
      to_device ? cudaMemcpyHostToDevice : cudaMemcpyDeviceToHost,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* host_func_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
