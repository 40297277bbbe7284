// Conditional CUDA-graph nodes for the port's captured rollouts (sm_90a).
//
// Replaces no Pallas kernel. It is the Hopper counterpart of the control flow
// that XLA compiles on the TPU: jax.lax.cond around the pool's reset branch
// (envpool_tpu/core/pool.py::_merge_resets) and jax.lax.while_loop in
// Pusher's reset (envpool_tpu/envs/mujoco/device_tasks.py). A captured CUDA
// graph cannot read a flag back to the host, so the branch becomes an IF or
// WHILE conditional node (CUDA >= 12.4) whose handle a kernel sets on the
// device. core/graph.py drives these functions while a stream is capturing:
//
//   graph_cond_begin  adds, at the capturing stream's frontier, the kernel
//                     that sets a new handle from a predicate, then the
//                     conditional node after it, and starts capturing a
//                     second stream into the node's body graph;
//   graph_cond_set    the same kernel alone, captured at the end of a WHILE
//                     body, so that the node tests the new carry;
//   graph_cond_end    ends the body's capture;
//   graph_cond_nodes  counts a graph's nodes.
//
// The kernel reads a bool vector and sets the handle to whether any element
// is set, so the `any` that the JAX code computes before its cond is fused
// into it. Bound: bytes, n bytes read once; the launch and the node dominate
// at every width the pool uses (n <= 16384), so one block suffices.

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

constexpr int kThreads = 256;

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const uint8_t* pred, int n) {
  int any = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) any |= pred[i] != 0;
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) cudaGraphSetConditional(handle, any ? 1u : 0u);
}

int launch_set(cudaStream_t stream, cudaGraphConditionalHandle handle,
               const void* pred, int n) {
  set_conditional_kernel<<<1, kThreads, 0, stream>>>(
      handle, static_cast<const uint8_t*>(pred), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define GC_CHECK(call)                              \
  do {                                              \
    cudaError_t err_ = (call);                      \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

// kind 0: IF (the body runs once when any(pred)); kind 1: WHILE (the body
// runs while the handle is set; it re-sets the handle with graph_cond_set).
extern "C" int graph_cond_begin(void* stream, void* body_stream, int kind,
                                const void* pred, int n,
                                unsigned long long* handle_out,
                                void** body_graph_out) {
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
  GC_CHECK(static_cast<cudaError_t>(launch_set(s, handle, pred, n)));
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

extern "C" int graph_cond_set(void* stream, unsigned long long handle,
                              const void* pred, int n) {
  return launch_set(static_cast<cudaStream_t>(stream),
                    static_cast<cudaGraphConditionalHandle>(handle), pred, n);
}

extern "C" int graph_cond_end(void* body_stream, void* body_graph) {
  cudaGraph_t got = nullptr;
  GC_CHECK(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &got));
  if (got != static_cast<cudaGraph_t>(body_graph)) {
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  }
  return 0;
}

extern "C" int graph_cond_nodes(void* graph, unsigned long long* count) {
  size_t n = 0;
  GC_CHECK(cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n));
  *count = n;
  return 0;
}
