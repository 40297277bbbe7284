// A conditional CUDA graph built with the CUDA runtime alone: no PyTorch and
// nothing of envpool_torch. tools/graph_cond_fault.py traces its launches as
// the control for the port's own conditional graphs.
//
// The graph has the shape of dm_control cheetah's reset inside the pool's
// step: an IF node whose handle a kernel sets to 1, and in its body a WHILE
// node of `rounds` rounds, each round `kernels` elementwise kernels over `n`
// floats and a kernel that counts the round and sets the WHILE handle.
// Every node is added with the explicit graph API (no stream capture).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC \
//     -o graph_cond_control.so graph_cond_control.cu

#include <cuda_runtime.h>

#if CUDART_VERSION >= 13000
#define GCC_ADD_NODE cudaGraphAddNode
#else
#define GCC_ADD_NODE cudaGraphAddNode_v2
#endif

namespace {

__global__ void set_one(cudaGraphConditionalHandle h) {
  cudaGraphSetConditional(h, 1u);
}

// advance 0 before the WHILE node, 1 at the end of a round
__global__ void count_round(cudaGraphConditionalHandle h, int* counter, int n,
                            int advance) {
  const int c = *counter + advance;
  const bool more = c < n;
  *counter = more ? c : 0;
  cudaGraphSetConditional(h, more ? 1u : 0u);
}

__global__ void work(float* x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = x[i] * 0.999f + 0.001f;
}

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t g,
                       const cudaGraphNode_t* dep, void* fn, unsigned grid,
                       unsigned block, void** args) {
  cudaKernelNodeParams p = {};
  p.func = fn;
  p.gridDim = dim3(grid);
  p.blockDim = dim3(block);
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, g, dep, dep ? 1 : 0, &p);
}

cudaError_t add_cond(cudaGraphNode_t* node, cudaGraph_t g, cudaGraphNode_t dep,
                     cudaGraphConditionalHandle h,
                     cudaGraphConditionalNodeType type, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = type;
  p.conditional.size = 1;
  const cudaError_t err = GCC_ADD_NODE(node, g, &dep, nullptr, 1, &p);
  *body = p.conditional.phGraph_out[0];
  return err;
}

}  // namespace

#define GCC_CHECK(call)                 \
  do {                                  \
    err = (call);                       \
    if (err != cudaSuccess) goto done;  \
  } while (0)

// Builds the graph over x[0:n], launches it once on `stream`, waits for it
// and frees it. Returns the CUDA error (0 on success).
extern "C" int graph_cond_control(float* x, int n, int rounds, int kernels,
                                  void* stream) {
  cudaError_t err = cudaSuccess;
  cudaGraph_t g = nullptr, if_body = nullptr, while_body = nullptr;
  cudaGraphExec_t exec = nullptr;
  int* counter = nullptr;
  cudaGraphConditionalHandle h_if, h_while;
  cudaGraphNode_t set_node, if_node, first, while_node, prev, node;
  int zero = 0, one = 1;
  void* set_args[] = {&h_if};
  void* first_args[] = {&h_while, &counter, &rounds, &zero};
  void* work_args[] = {&x, &n};
  void* round_args[] = {&h_while, &counter, &rounds, &one};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GCC_CHECK(cudaMalloc(&counter, sizeof(int)));
  GCC_CHECK(cudaMemset(counter, 0, sizeof(int)));
  GCC_CHECK(cudaGraphCreate(&g, 0));
  GCC_CHECK(cudaGraphConditionalHandleCreate(&h_if, g, 0, cudaGraphCondAssignDefault));
  GCC_CHECK(add_kernel(&set_node, g, nullptr, reinterpret_cast<void*>(set_one),
                       1, 1, set_args));
  GCC_CHECK(add_cond(&if_node, g, set_node, h_if, cudaGraphCondTypeIf, &if_body));
  GCC_CHECK(cudaGraphConditionalHandleCreate(&h_while, if_body, 0,
                                             cudaGraphCondAssignDefault));
  GCC_CHECK(add_kernel(&first, if_body, nullptr,
                       reinterpret_cast<void*>(count_round), 1, 1, first_args));
  GCC_CHECK(add_cond(&while_node, if_body, first, h_while, cudaGraphCondTypeWhile,
                     &while_body));
  for (int k = 0; k < kernels; ++k) {
    GCC_CHECK(add_kernel(&node, while_body, k ? &prev : nullptr,
                         reinterpret_cast<void*>(work), (n + 255) / 256, 256,
                         work_args));
    prev = node;
  }
  GCC_CHECK(add_kernel(&node, while_body, kernels ? &prev : nullptr,
                       reinterpret_cast<void*>(count_round), 1, 1, round_args));
  GCC_CHECK(cudaGraphInstantiate(&exec, g, 0));
  GCC_CHECK(cudaGraphLaunch(exec, s));
  GCC_CHECK(cudaStreamSynchronize(s));
done:
  if (exec) cudaGraphExecDestroy(exec);
  if (g) cudaGraphDestroy(g);
  if (counter) cudaFree(counter);
  return static_cast<int>(err);
}
