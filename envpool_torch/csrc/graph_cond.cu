// Conditional CUDA-graph nodes for the port's captured rollouts (sm_90a).
//
// Replaces no Pallas kernel. It is the Hopper counterpart of the control flow
// that XLA compiles on the TPU: jax.lax.cond around the pool's reset branch
// (envpool_tpu/core/pool.py::_merge_resets), jax.lax.while_loop in Pusher's
// reset (envpool_tpu/envs/mujoco/device_tasks.py) and the counted loops of
// the MuJoCo engine. A captured CUDA graph cannot read a flag back to the
// host, so the branch becomes an IF or WHILE conditional node (CUDA >= 12.4)
// whose handle a kernel sets on the device. core/graph.py drives these
// functions while a stream is capturing:
//
//   graph_cond_begin  adds, at the capturing stream's frontier, the kernel
//                     that sets a new handle, then the conditional node after
//                     it, and starts capturing a second stream into the
//                     node's body graph;
//   graph_cond_set    the same kernel alone, captured at the end of a WHILE
//                     body, so that the node tests the new carry;
//   graph_cond_end    ends the body's capture;
//   graph_cond_stream makes a stream to capture bodies on;
//   graph_cond_nodes  counts a graph's nodes.
//
// The kernel comes in two forms:
//
//   any      sets the handle to whether any byte of a bool vector is set, so
//            the `any` that the JAX code computes before its cond is fused in;
//   counted  the round counter of fori_loop(0, n, ...) with a static n: it
//            advances an int32 counter on the device, sets the handle to
//            counter < n, and puts the counter back to 0 when the loop ends,
//            so the next run of the node starts at 0 with no fill before it.
//
// What bounds them. The work is tiny: the `any` form reads n bytes (16 KB at
// the pool's widest predicate, 4.9 ns at 3.35 TB/s), the counted form 4 bytes
// and writes 4. What a node costs is the launch, the node, and the latency of
// the loads, so every load of the `any` form is independent and issued before
// any reduction: the block has ceil(n / 16) threads (at least a warp, at most
// 1,024), so at n <= 16,384 each thread makes one 16-byte load, plus at most
// one byte of the unaligned head and one of the tail (a predicate may be a
// view at any offset); a warp vote and one __syncthreads_or reduce, and one
// thread sets the handle. Past 16,384 bytes the block strides over the vector
// with four 16-byte loads in flight per thread. One block is enough: the pool
// never passes more than its lane count, and several blocks would need a
// second pass or atomics, a further node on every replay. The counted form is
// one thread: one load, one store. A node without any set kernel is the floor
// that any one-launch design pays; `form` 2 captures an empty kernel in front
// of a node whose handle keeps its default 0, to time that floor.

#include <cstdint>
#include <cuda_runtime.h>

#if CUDART_VERSION >= 13000
#define GC_CAPTURE_INFO cudaStreamGetCaptureInfo
#define GC_ADD_NODE cudaGraphAddNode
#define GC_UPDATE_DEPS cudaStreamUpdateCaptureDependencies
#else
#define GC_CAPTURE_INFO cudaStreamGetCaptureInfo_v3
#define GC_ADD_NODE cudaGraphAddNode_v2
#define GC_UPDATE_DEPS cudaStreamUpdateCaptureDependencies_v2
#endif

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kFormAny = 0, kFormCounted = 1, kFormEmpty = 2;

__device__ __forceinline__ unsigned or_words(uint4 v) {
  return v.x | v.y | v.z | v.w;
}

__global__ void __launch_bounds__(kMaxThreads)
set_any_kernel(cudaGraphConditionalHandle handle, const uint8_t* pred, int n) {
  const int t = threadIdx.x;
  const int step = blockDim.x;
  // bytes before the first 16-byte boundary, whole vectors, bytes after
  const int head = min(n, static_cast<int>(
      (16 - (reinterpret_cast<uintptr_t>(pred) & 15)) & 15));
  const int nvec = (n - head) >> 4;
  const int tail = n - head - (nvec << 4);
  const uint4* vec = reinterpret_cast<const uint4*>(pred + head);
  const uint8_t* rest = pred + head + (nvec << 4);
  // the first round's loads are independent and all issued before any OR
  const uint4 v = t < nvec ? __ldg(vec + t) : make_uint4(0, 0, 0, 0);
  const unsigned a = t < head ? pred[t] : 0u;
  const unsigned b = t < tail ? rest[t] : 0u;
  unsigned any = or_words(v) | a | b;
  for (int i = t + step; i < nvec; i += 4 * step) {
    uint4 w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = i + k * step;
      w[k] = j < nvec ? __ldg(vec + j) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) any |= or_words(w[k]);
  }
  // blockDim.x is a multiple of 32, so every warp votes whole
  const int set = __syncthreads_or(__any_sync(0xffffffffu, any != 0));
  if (t == 0) cudaGraphSetConditional(handle, set ? 1u : 0u);
}

// advance 0 before the node (the counter is 0 there), 1 at a round's end
__global__ void set_counted_kernel(cudaGraphConditionalHandle handle,
                                   int* counter, int n, int advance) {
  const int c = *counter + advance;
  const bool more = c < n;
  *counter = more ? c : 0;
  cudaGraphSetConditional(handle, more ? 1u : 0u);
}

__global__ void empty_kernel() {}

int launch_set(cudaStream_t stream, cudaGraphConditionalHandle handle,
               int form, const void* arg, int n, int advance) {
  if (form == kFormAny) {
    // one 16-byte load per thread up to 16,384 bytes, at least one warp
    const int nvec = (n >> 4) + 1;
    const int threads = nvec >= kMaxThreads ? kMaxThreads : ((nvec + 31) & ~31);
    set_any_kernel<<<1, threads, 0, stream>>>(
        handle, static_cast<const uint8_t*>(arg), n);
  } else if (form == kFormCounted) {
    set_counted_kernel<<<1, 1, 0, stream>>>(
        handle, static_cast<int*>(const_cast<void*>(arg)), n, advance);
  } else if (form == kFormEmpty) {
    empty_kernel<<<1, 1, 0, stream>>>();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the call that failed last, for the caller's message
thread_local const char* gc_failed = "";

#define GC_CHECK(call)                              \
  do {                                              \
    cudaError_t err_ = (call);                      \
    if (err_ != cudaSuccess) {                      \
      gc_failed = #call;                            \
      return static_cast<int>(err_);                \
    }                                               \
  } while (0)

extern "C" const char* graph_cond_failed() { return gc_failed; }

// kind 0: IF (the body runs once when the handle is set); kind 1: WHILE (the
// body runs while the handle is set; it re-sets the handle with
// graph_cond_set). form 0: any(arg[0:n]) over bool bytes; form 1: the
// counted form over the int32 counter at arg, n >= 1 rounds (the counter
// must be 0 here); form 2: an empty kernel, the handle left at 0.
extern "C" int graph_cond_begin(void* stream, void* body_stream, int kind,
                                int form, const void* arg, int n,
                                unsigned long long* handle_out,
                                void** body_graph_out) {
  gc_failed = "";
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  const cudaGraphEdgeData* edges = nullptr;
  size_t n_deps = 0;
  GC_CHECK(GC_CAPTURE_INFO(s, &status, nullptr, &graph, &deps, &edges, &n_deps));
  if (status != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  }
  cudaGraphConditionalHandle handle;
  // the handle falls back to 0 at every launch of the graph
  GC_CHECK(cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                            cudaGraphCondAssignDefault));
  GC_CHECK(static_cast<cudaError_t>(launch_set(s, handle, form, arg, n, 0)));
  // the frontier now ends at the set kernel
  GC_CHECK(GC_CAPTURE_INFO(s, &status, nullptr, &graph, &deps, &edges, &n_deps));
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  GC_CHECK(GC_ADD_NODE(&node, graph, deps, edges, n_deps, &params));
  GC_CHECK(GC_UPDATE_DEPS(s, &node, nullptr, 1, cudaStreamSetCaptureDependencies));
  cudaGraph_t body = params.conditional.phGraph_out[0];
  GC_CHECK(cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                         body, nullptr, nullptr, 0,
                                         cudaStreamCaptureModeThreadLocal));
  *handle_out = static_cast<unsigned long long>(handle);
  *body_graph_out = body;
  return 0;
}

// at the end of a WHILE body: form 0 sets the handle to any(arg[0:n]),
// form 1 advances the counter and sets the handle to counter < n
extern "C" int graph_cond_set(void* stream, unsigned long long handle,
                              int form, const void* arg, int n) {
  gc_failed = "";
  GC_CHECK(static_cast<cudaError_t>(launch_set(
      static_cast<cudaStream_t>(stream),
      static_cast<cudaGraphConditionalHandle>(handle), form, arg, n, 1)));
  return 0;
}

extern "C" int graph_cond_end(void* body_stream, void* body_graph) {
  gc_failed = "";
  cudaGraph_t got = nullptr;
  GC_CHECK(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &got));
  if (got != static_cast<cudaGraph_t>(body_graph)) {
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  }
  return 0;
}

// a stream of the caller's own for capturing bodies on the current device
// (PyTorch's streams come from a pool of 32 that it hands out in turn)
extern "C" int graph_cond_stream(void** stream_out) {
  gc_failed = "";
  cudaStream_t s = nullptr;
  GC_CHECK(cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking));
  *stream_out = s;
  return 0;
}

extern "C" int graph_cond_nodes(void* graph, unsigned long long* count) {
  gc_failed = "";
  size_t n = 0;
  GC_CHECK(cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n));
  *count = n;
  return 0;
}
