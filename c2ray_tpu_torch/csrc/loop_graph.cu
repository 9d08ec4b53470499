// A device-resident while loop around a captured CUDA graph: the
// counterpart of the lax.while_loop of c2ray_tpu/solver.py::
// Evolve3D._loop_program, used by c2ray_tpu_torch/cuda_graph.py.
//
// The loop body (one convergence iteration: sweep, chemistry tail,
// carry update and the loop's condition, written to a one-byte flag
// `go` by the body's last op) is captured by PyTorch into its own
// graph.  This library builds the graph that runs it:
//
//     set(h, go) -> WHILE h { body (a child-graph node); set(h, go) }
//
// a conditional WHILE node (CUDA 12.4+) whose handle h a one-thread
// kernel sets from go before the loop and after every body run, so the
// card runs iterations until the condition fails with no host round
// trip.  One launch of the instantiated graph is one timestep's loop.
// PyTorch 2.11 binds no conditional node, so the graph is built here
// through the CUDA runtime; the body graph's memory stays in PyTorch's
// private pool of the capture, which the caller keeps alive with the
// graph.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle h,
                              const unsigned char* go) {
  cudaGraphSetConditional(h, *go ? 1u : 0u);
}

cudaError_t add_set(cudaGraph_t g, const cudaGraphNode_t* deps, size_t ndeps,
                    cudaGraphConditionalHandle* h, const unsigned char** go,
                    cudaGraphNode_t* out) {
  void* args[2] = {h, go};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)set_condition;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  return cudaGraphAddKernelNode(out, g, deps, ndeps, &kp);
}

}  // namespace

extern "C" {

// Build and instantiate the while graph around `body` (a cudaGraph_t,
// which is cloned into it) under the flag go (one byte on the card).
// -> *graph_out, *exec_out.  Returns the first CUDA error code, 0 on
// success.
int c2r_while_graph(void* body, const unsigned char* go, void** graph_out,
                    void** exec_out) {
  cudaGraph_t g = nullptr;
  cudaError_t err = cudaGraphCreate(&g, 0);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle h;
  cudaGraphNode_t init, loop, child, again;
  cudaGraphNodeParams cp = {};
  cudaGraph_t inner = nullptr;
  cudaGraphExec_t exec = nullptr;
  err = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (err != cudaSuccess) goto fail;
  err = add_set(g, nullptr, 0, &h, &go, &init);
  if (err != cudaSuccess) goto fail;
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = h;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  err = cudaGraphAddNode(&loop, g, &init, 1, &cp);
  if (err != cudaSuccess) goto fail;
  inner = cp.conditional.phGraph_out[0];
  err = cudaGraphAddChildGraphNode(&child, inner, nullptr, 0,
                                   (cudaGraph_t)body);
  if (err != cudaSuccess) goto fail;
  err = add_set(inner, &child, 1, &h, &go, &again);
  if (err != cudaSuccess) goto fail;
  err = cudaGraphInstantiate(&exec, g, 0);
  if (err != cudaSuccess) goto fail;
  *graph_out = g;
  *exec_out = exec;
  return 0;
fail:
  cudaGraphDestroy(g);
  return (int)err;
}

// One run of the loop on `stream`.
int c2r_while_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// The nodes of a graph (the body's, as PyTorch captured it).
int c2r_graph_nodes(void* graph, unsigned long long* count) {
  size_t n = 0;
  const cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  *count = n;
  return (int)err;
}

// The kernel nodes of a graph (a launch of a kernel each).
int c2r_graph_kernel_nodes(void* graph, unsigned long long* count) {
  *count = 0;
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return (int)err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes((cudaGraph_t)graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err == cudaSuccess && type == cudaGraphNodeTypeKernel) ++*count;
  }
  delete[] nodes;
  return (int)err;
}

int c2r_while_graph_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph) {
    const cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
    if (err == cudaSuccess) err = e2;
  }
  return (int)err;
}

const char* c2r_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
