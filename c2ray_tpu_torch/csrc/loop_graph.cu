// A device-resident while loop around a captured CUDA graph: the
// counterpart of the lax.while_loop of c2ray_tpu/solver.py::
// Evolve3D._loop_program, used by c2ray_tpu_torch/cuda_graph.py.
//
// The loop body (one convergence iteration: sweep, chemistry tail,
// carry update and the loop's condition, written to a one-byte flag
// `go` by the body) is captured by PyTorch into its own
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
//
// The phase clock of the loop (ops/launches.PhaseClock) is here too: a
// one-thread stamp kernel that the body launches after each phase of an
// iteration, captured with it, and an anchor kernel launched on the
// stream before and after the graph.  Both read the card's %globaltimer
// (ns).  The clock's buffer is int64 rows of `width` columns, one row per
// iteration indexed by the carry's iteration counter, then one row of the
// clock's own: [previous stamp, first anchor, last anchor, ...].  A row is
// [phase ns ..., counts ..., first stamp, last stamp].

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// Charge the ns since the previous stamp to column `phase` of row *it,
// set the row's first (the previous stamp, at its first charge) and last
// stamp; with counts, add counts[0] and counts[1] to columns count_col
// and count_col + 1.  Does nothing unless *on.
__global__ void phase_stamp(const int* on, long long* rows, const int* it,
                            int nrows, int width, int phase,
                            const long long* counts, int count_col) {
  if (*on == 0) return;
  const long long now = globaltimer();
  long long* clock = rows + (long long)nrows * width;
  const int i = *it;
  if (i >= 0 && i < nrows) {
    long long* row = rows + (long long)i * width;
    const long long prev = clock[0];
    row[phase] += now - prev;
    if (row[width - 2] == 0) row[width - 2] = prev;
    row[width - 1] = now;
    if (counts != nullptr) {
      row[count_col] += counts[0];
      row[count_col + 1] += counts[1];
    }
  }
  clock[0] = now;
}

// Start the clock (the previous stamp) and keep the time in the clock
// row's column `slot` (0: the previous stamp alone, a restart).
__global__ void clock_anchor(long long* rows, int nrows, int width,
                             int slot) {
  const long long now = globaltimer();
  long long* clock = rows + (long long)nrows * width;
  clock[0] = now;
  clock[slot] = now;
}

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

// One stamp of the phase clock on `stream` (phase_stamp; counts may be
// null).
int c2r_phase_stamp(const int* on, long long* rows, const int* it, int nrows,
                    int width, int phase, const long long* counts,
                    int count_col, void* stream) {
  phase_stamp<<<1, 1, 0, (cudaStream_t)stream>>>(on, rows, it, nrows, width,
                                                 phase, counts, count_col);
  return (int)cudaGetLastError();
}

// One anchor of the phase clock on `stream` (clock_anchor).
int c2r_clock_anchor(long long* rows, int nrows, int width, int slot,
                     void* stream) {
  clock_anchor<<<1, 1, 0, (cudaStream_t)stream>>>(rows, nrows, width, slot);
  return (int)cudaGetLastError();
}

const char* c2r_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
