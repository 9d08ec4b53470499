// Window gather and window scatter-add of the windowed sweep, hand-written
// for Hopper (sm_90a).
//
// Replaces: c2ray_tpu/ops/window_pallas.py::_gather_kernel (launcher
// window_gather) and ::_scatter_kernel (launcher window_scatter_add).  The
// padded field and the accumulator are exactly m^3 = (n+2r)^3, row-major;
// the window of source q is the p^3 block (p = 2r+1) with its corner at q
// in padded coordinates, q in [0, n).  The TPU kernels' covering blocks,
// lane margins and rotates exist only for Mosaic's (8,128)-tiled DMA and
// do not carry over.
//
// What bounds them on the H100: bytes.  The gather reads and writes each
// window cell once (2*B*p^3*4 B: 10.1 MB at r = 8 x 256 windows, 3.0 us at
// 3.35 TB/s); the scatter reads the rates and reads and writes the
// accumulator cell (3*B*p^3*4 B: 15.1 MB, 4.5 us).  There is no arithmetic
// to speak of.
//
// Design of the gather (gather_slabs): a division-free slab copy.  One
// block per (window, x-slab i), a (32, 8) thread block: each warp copies
// rows j, j+8, ... of the slab, k in steps of 32, so a warp reads a run of
// p contiguous floats of the padded field and writes the matching
// contiguous row of the window.  The block computes its two base pointers
// once; the offsets inside the slab are 32-bit and need no division or
// modulo.  Each row is read once; windows that overlap find theirs in L2.
// A window whose corner lies outside [0, m-p] is written as zeros (a
// per-block early exit).  A build with C2R_WINDOW_GATHER_PER_CELL (timing
// only, never the shipped one) runs the first form instead, gather_cells:
// one thread per window cell, located by division, so the two can be
// compared on the card.
//
// Design of the scatter-add (scatter_cells, the first, simple form): one
// thread per window cell, neighbouring threads on neighbouring z, each
// cell located by division (locate).  It adds with atomicAdd in float,
// because windows overlap each other (and repeat where two sources share a
// cell); the TPU kernel relied on its sequential grid for a fixed
// summation order, so here the order of the sums, and with it the last
// bits of a cell that several windows cover, changes from run to run.  A
// window whose corner lies outside [0, m-p] is skipped, so a bad position
// cannot write outside the accumulator (the callers check positions on the
// host).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowLanes = 32, kRowWarps = 8;     // the gather's block

struct Cell {
  size_t src;   // (B, p, p, p) offset of this window cell
  size_t pad;   // m^3 offset of the same cell in the padded field
  bool ok;
};

__device__ __forceinline__ Cell locate(const int* pos, int m, int p,
                                       size_t idx) {
  const size_t p3 = (size_t)p * p * p;
  const int w = (int)(idx / p3);
  const size_t rem = idx - (size_t)w * p3;
  const int i = (int)(rem / ((size_t)p * p));
  const int j = (int)((rem / p) % p);
  const int k = (int)(rem % p);
  const int q0 = pos[3 * w], q1 = pos[3 * w + 1], q2 = pos[3 * w + 2];
  Cell cell;
  cell.src = idx;
  cell.ok = q0 >= 0 && q1 >= 0 && q2 >= 0 && q0 <= m - p && q1 <= m - p &&
            q2 <= m - p;
  cell.pad = ((size_t)(q0 + i) * m + (q1 + j)) * m + (q2 + k);
  return cell;
}

__device__ __forceinline__ bool corner_ok(int q0, int q1, int q2, int m,
                                          int p) {
  return q0 >= 0 && q1 >= 0 && q2 >= 0 && q0 <= m - p && q1 <= m - p &&
         q2 <= m - p;
}

#ifdef C2R_WINDOW_GATHER_PER_CELL
__global__ void gather_cells(const float* field, int m, const int* pos,
                             size_t total, int p, float* out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Cell cell = locate(pos, m, p, idx);
  out[idx] = cell.ok ? field[cell.pad] : 0.f;
}
#endif

// Block (window w, slab i): out[w][i][j][k] <- field[q0+i][q1+j][q2+k].
__global__ void __launch_bounds__(kRowLanes * kRowWarps)
gather_slabs(const float* __restrict__ field, int m,
             const int* __restrict__ pos, int p, float* __restrict__ out) {
  const int w = blockIdx.x, i = blockIdx.y;
  const int q0 = __ldg(pos + 3 * w), q1 = __ldg(pos + 3 * w + 1),
            q2 = __ldg(pos + 3 * w + 2);
  float* o = out + ((size_t)w * p + i) * p * p;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (!corner_ok(q0, q1, q2, m, p)) {
    for (int j = ty; j < p; j += kRowWarps)
      for (int k = tx; k < p; k += kRowLanes) o[j * p + k] = 0.f;
    return;
  }
  const float* src = field + ((size_t)(q0 + i) * m + q1) * m + q2;
  for (int j = ty; j < p; j += kRowWarps) {
    const float* row = src + j * m;
    float* orow = o + j * p;
    for (int k = tx; k < p; k += kRowLanes) orow[k] = __ldg(row + k);
  }
}

__global__ void scatter_cells(float* acc, int m, const int* pos,
                              size_t total, int p, const float* rates) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Cell cell = locate(pos, m, p, idx);
  if (cell.ok) atomicAdd(acc + cell.pad, rates[idx]);
}

int blocks(size_t total) { return (int)((total + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// out (B, p, p, p) <- the windows of field (m, m, m) at the B corners pos.
// Returns the first CUDA error code, 0 on success.
int c2r_window_gather(const float* field, int m, const int* pos, int nwin,
                      int p, float* out, void* stream) {
#ifdef C2R_WINDOW_GATHER_PER_CELL
  const size_t total = (size_t)nwin * p * p * p;
  gather_cells<<<blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      field, m, pos, total, p, out);
#else
  gather_slabs<<<dim3(nwin, p), dim3(kRowLanes, kRowWarps), 0,
                 (cudaStream_t)stream>>>(field, m, pos, p, out);
#endif
  return (int)cudaGetLastError();
}

// acc (m, m, m) += each window of rates (B, p, p, p) at its corner, in
// place.  Returns the first CUDA error code, 0 on success.
int c2r_window_scatter_add(float* acc, int m, const int* pos, int nwin,
                           int p, const float* rates, void* stream) {
  const size_t total = (size_t)nwin * p * p * p;
  scatter_cells<<<blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      acc, m, pos, total, p, rates);
  return (int)cudaGetLastError();
}

const char* c2r_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
