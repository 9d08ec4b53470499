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
// Design (first, simple form): one thread per window cell, neighbouring
// threads on neighbouring z, so each warp reads and writes runs of p
// contiguous floats.  The gather is a strided block copy.  The scatter adds
// with atomicAdd in float, because windows overlap each other (and repeat
// where two sources share a cell); the TPU kernel relied on its sequential
// grid for a fixed summation order, so here the order of the sums, and
// with it the last bits of a cell that several windows cover, changes from
// run to run.  A window whose corner lies outside [0, m-p] is skipped, so
// a bad position cannot write outside the accumulator (the callers check
// positions on the host).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void gather_cells(const float* field, int m, const int* pos,
                             size_t total, int p, float* out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Cell cell = locate(pos, m, p, idx);
  out[idx] = cell.ok ? field[cell.pad] : 0.f;
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
  const size_t total = (size_t)nwin * p * p * p;
  gather_cells<<<blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      field, m, pos, total, p, out);
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
