// Window gather and window scatter-add of the windowed sweep, hand-written
// for Hopper (sm_90a).
//
// Replaces: c2ray_tpu/ops/window_pallas.py::_gather_kernel (launcher
// window_gather) and ::_scatter_kernel (launcher window_scatter_add).  The
// padded field and the accumulator are exactly (m0, m, m), row-major: m0 =
// m = n+2r on the cube, m0 = (slab rows)+2r on the halo layout's slab
// (parallel/domain.py); the window of source q is the p^3 block (p = 2r+1)
// with its corner at q in padded coordinates.  Axis 0's extent enters only
// the corner test, so the cube's code and bits are those of m0 = m.  The
// TPU kernels' covering blocks, lane margins and rotates exist only for
// Mosaic's (8,128)-tiled DMA and do not carry over.
//
// What bounds them on the H100: bytes.  The gather reads and writes each
// window cell once (2*B*p^3*4 B: 10.1 MB at r = 8 x 256 windows, 3.0 us at
// 3.35 TB/s); the scatter reads the rates and reads and writes each
// accumulator cell that a window covers once (at most 3*B*p^3*4 B: 15.1
// MB, 4.5 us; less where windows overlap).  There is no arithmetic to
// speak of.
//
// Design of the gather (gather_slabs): a division-free slab copy.  One
// block per (window, x-slab i), a (32, 8) thread block: each warp copies
// rows j, j+8, ... of the slab, k in steps of 32, so a warp reads a run of
// p contiguous floats of the padded field and writes the matching
// contiguous row of the window.  The block computes its two base pointers
// once; the offsets inside the slab are 32-bit and need no division or
// modulo.  Each row is read once; windows that overlap find theirs in L2.
// A window whose corner lies outside [0, m0-p] x [0, m-p]^2 is written
// as zeros (a per-block early exit).  A build with
// C2R_WINDOW_GATHER_PER_CELL (timing only, never the shipped one) runs the
// first form instead, gather_cells: one thread per window cell, located by
// division, so the two can be compared on the card.
//
// Design of the scatter-add (scatter_slabs): owner computes, no atomics.
// Windows overlap each other (and repeat where two sources share a cell,
// or where a batch is padded with windows at corner 0).  The TPU kernel's
// grid is sequential, so it adds the windows in index order; here a cell
// of the accumulator belongs to the covering window with the lowest
// index, and only that window's thread reads and writes it:
//   s = acc[c];  s += rates[w][c];  for v > w covering c, in order:
//   s += rates[v][c - q_v];  acc[c] = s
// These are the additions of the sequential order, so the result is
// bitwise that of the plain version (one block add per window, in window
// order) and the same from run to run.  One block per (window w, x-slab
// i), a window's slabs side by side in the grid (so the owner of a run of
// padding windows, the run's first, starts early), 256 threads over the
// slab's p^2 cells in flat order (cell t, t+256, ...), two cells a pass;
// the own terms of a thread's first pass are loaded before anything
// else.  The block then lists the windows whose
// box meets its slab: one thread tests one window, and a barrier counts
// the hits.  At random corners there are usually none, and that one
// barrier is all the list costs; otherwise the block exits if a
// lower-index twin sits at its corner (the twin owns every cell), and
// ballots and the warps' counts place the hits in shared memory in index
// order (16 B each, so a batch of B windows needs 16*B B).  A thread sums
// a run of later windows (the owner of k identical windows sums k terms
// per cell) kScatterTerms terms at a time: cp.async copies a batch of
// terms for both of its cells into shared memory, so the loads are in
// flight together and hold no registers, and the adds follow in order.
// The kernel is held to 42 registers, six blocks per SM.  Every window
// adds, zero-flux padding included (its rates are +0 only where the
// density is nonzero).  A build with C2R_WINDOW_SCATTER_ROWS takes K4's
// mapping of threads to cells instead (warps over rows, lanes over k),
// and a build with C2R_WINDOW_SCATTER_ATOMIC the first form,
// scatter_cells (one thread per window cell, located by division, float
// atomicAdd, an order of the sums that changes from run to run); both are
// timing builds only, never the shipped one.  A window whose corner lies
// outside [0, m0-p] x [0, m-p]^2 is in no list and writes nothing, so a
// bad position cannot write outside the accumulator (the callers check
// positions on the host).
//
// Element type (real.cuh): float32, or float64 in the build with
// -DC2R_F64.  The gather is a copy in either.  The scatter-add's staging
// follows the element: cp.async copies 8-byte terms, a batch of terms
// takes 32 KB of shared memory instead of 16, so the list has less room
// and the build exports its own window limit
// (c2r_window_scatter_max_windows), and the kernel may hold 64 registers
// (four blocks per SM) for its double sums.  The owner form's fixed order
// of adds is the same, so the f64 build too is bitwise its plain version
// and the same from run to run.

#include <cuda_runtime.h>
#include <stddef.h>

#include "real.cuh"

#if defined(C2R_WINDOW_GATHER_PER_CELL) || defined(C2R_WINDOW_SCATTER_ATOMIC)
#define C2R_WINDOW_CELL_FORMS   // a first form: one thread per window cell
#endif

namespace {

constexpr int kRowLanes = 32, kRowWarps = 8;     // the gather's block

__device__ __forceinline__ bool corner_ok(int q0, int q1, int q2, int m0,
                                          int m, int p) {
  return q0 >= 0 && q1 >= 0 && q2 >= 0 && q0 <= m0 - p && q1 <= m - p &&
         q2 <= m - p;
}

#ifdef C2R_WINDOW_CELL_FORMS
constexpr int kThreads = 256;

struct Cell {
  size_t pad;   // m^3 offset of the cell in the padded field
  bool ok;
};

// Window cell idx of the (B, p, p, p) windows, located by division.
__device__ __forceinline__ Cell locate(const int* pos, int m0, int m, int p,
                                       size_t idx) {
  const size_t p3 = (size_t)p * p * p;
  const int w = (int)(idx / p3);
  const size_t rem = idx - (size_t)w * p3;
  const int i = (int)(rem / ((size_t)p * p));
  const int j = (int)((rem / p) % p);
  const int k = (int)(rem % p);
  const int q0 = pos[3 * w], q1 = pos[3 * w + 1], q2 = pos[3 * w + 2];
  Cell cell;
  cell.ok = corner_ok(q0, q1, q2, m0, m, p);
  cell.pad = ((size_t)(q0 + i) * m + (q1 + j)) * m + (q2 + k);
  return cell;
}

int blocks(size_t total) { return (int)((total + kThreads - 1) / kThreads); }
#endif

#ifdef C2R_WINDOW_GATHER_PER_CELL
__global__ void gather_cells(const real* field, int m0, int m,
                             const int* pos, size_t total, int p,
                             real* out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Cell cell = locate(pos, m0, m, p, idx);
  out[idx] = cell.ok ? field[cell.pad] : rl(0.);
}
#endif

// Block (window w, slab i): out[w][i][j][k] <- field[q0+i][q1+j][q2+k].
__global__ void __launch_bounds__(kRowLanes * kRowWarps)
gather_slabs(const real* __restrict__ field, int m0, int m,
             const int* __restrict__ pos, int p, real* __restrict__ out) {
  const int w = blockIdx.x, i = blockIdx.y;
  const int q0 = __ldg(pos + 3 * w), q1 = __ldg(pos + 3 * w + 1),
            q2 = __ldg(pos + 3 * w + 2);
  real* o = out + ((size_t)w * p + i) * p * p;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (!corner_ok(q0, q1, q2, m0, m, p)) {
    for (int j = ty; j < p; j += kRowWarps)
      for (int k = tx; k < p; k += kRowLanes) o[j * p + k] = rl(0.);
    return;
  }
  const real* src = field + ((size_t)(q0 + i) * m + q1) * m + q2;
  for (int j = ty; j < p; j += kRowWarps) {
    const real* row = src + j * m;
    real* orow = o + j * p;
    for (int k = tx; k < p; k += kRowLanes) orow[k] = __ldg(row + k);
  }
}

#ifdef C2R_WINDOW_SCATTER_ATOMIC
__global__ void scatter_cells(real* acc, int m0, int m, const int* pos,
                              size_t total, int p, const real* rates) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Cell cell = locate(pos, m0, m, p, idx);
  if (cell.ok) atomicAdd(acc + cell.pad, rates[idx]);
}
#else
constexpr int kScatterThreads = 256;
constexpr int kScatterWarps = kScatterThreads / 32;
// per SM: at most 42 registers in float, 64 in double
constexpr int kScatterMinBlocks = sizeof(real) == 8 ? 4 : 6;
constexpr int kScatterCells = 2;      // a thread's cells per pass
constexpr int kScatterTerms = 8;      // later windows' terms per batch

// The cells (j, k) of a slab that one thread takes, in order: row j
// (axis 1), column k (axis 2); the thread is done once j reaches p.
struct SlabCursor {
  int j, k;
#ifdef C2R_WINDOW_SCATTER_ROWS
  int lane;
  __device__ SlabCursor(int tid, int p) : lane(tid & 31) {
    j = lane < p ? tid >> 5 : p;
    k = lane;
  }
  __device__ void next(int p) {
    k += 32;
    if (k >= p) {
      k = lane;
      j += kScatterWarps;
    }
  }
#else
  int dj, dk;
  __device__ SlabCursor(int tid, int p) {
    j = tid / p;
    k = tid - j * p;
    dj = kScatterThreads / p;
    dk = kScatterThreads - dj * p;
  }
  __device__ void next(int p) {
    j += dj;
    k += dk;
    if (k >= p) {
      k -= p;
      ++j;
    }
  }
#endif
};

__device__ __forceinline__ bool inside(int y, int z, int p) {
  return (unsigned)y < (unsigned)p && (unsigned)z < (unsigned)p;
}

// A thread's next kScatterCells cells of the slab: their (j, k), the
// accumulator's values and w's own terms (j = p past the last).
__device__ __forceinline__ void load_pass(SlabCursor& cur, int p, int m,
                                          const real* slab,
                                          const real* own,
                                          int (&jj)[kScatterCells],
                                          int (&kk)[kScatterCells],
                                          real (&sum)[kScatterCells],
                                          real (&term)[kScatterCells]) {
#pragma unroll
  for (int u = 0; u < kScatterCells; ++u) {
    jj[u] = cur.j;
    kk[u] = cur.k;
    if (cur.j < p) {
      sum[u] = slab[cur.j * m + cur.k];
      term[u] = __ldg(own + cur.j * p + cur.k);
    }
    cur.next(p);
  }
}

// Copy one element (4 or 8 bytes) from src to shared memory without a
// register (read false: write 0.0 and read nothing).
__device__ __forceinline__ void copy_async(real* dst, const real* src,
                                           bool read) {
  constexpr int kBytes = (int)sizeof(real);
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(to),
               "l"(src), "n"(kBytes), "r"(read ? kBytes : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Block (window w, slab i): the cells (q0+i, q1+j, q2+k) that w owns get
// acc + rates[w] + the terms of the later windows that cover them.  Shared
// memory: the terms of a batch, kScatterCells * kScatterTerms per thread,
// then the list.  A list entry is (v, dy, dz, off): window v covers cell
// (j, k) of this slab where (j+dy, k+dz) lies in [0, p)^2, and its term
// is rates[off + j*p + k].
__global__ void __launch_bounds__(kScatterThreads, kScatterMinBlocks)
scatter_slabs(real* __restrict__ acc, int m0, int m,
              const int* __restrict__ pos, int nwin, int p,
              const real* __restrict__ rates) {
  extern __shared__ float4 shared[];
  __shared__ int counts[2][kScatterWarps];
  real* stage = (real*)shared + threadIdx.x;
  int4* near = (int4*)((real*)shared +
                       kScatterCells * kScatterTerms * kScatterThreads);
  const int w = blockIdx.y, i = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = __ldg(pos + 3 * w), q1 = __ldg(pos + 3 * w + 1),
            q2 = __ldg(pos + 3 * w + 2);
  if (!corner_ok(q0, q1, q2, m0, m, p)) return;
  const int x = q0 + i, pp = p * p;
  real* slab = acc + ((size_t)x * m + q1) * m + q2;
  const real* own = rates + ((size_t)w * p + i) * pp;

  SlabCursor cur(tid, p);
  int jj[kScatterCells], kk[kScatterCells];
  real sum[kScatterCells], term[kScatterCells];
  load_pass(cur, p, m, slab, own, jj, kk, sum, term);

  // the list: one thread per window tests it; usually nothing meets the
  // slab, and then one barrier is all the scan costs
  int nnear = 0;
  for (int base = 0, round = 0; base < nwin;
       base += kScatterThreads, round ^= 1) {
    const int v = base + tid;
    bool hit = false, twin = false;
    if (v < nwin && v != w) {
      const int v0 = __ldg(pos + 3 * v), v1 = __ldg(pos + 3 * v + 1),
                v2 = __ldg(pos + 3 * v + 2);
      if (corner_ok(v0, v1, v2, m0, m, p)) {
        twin = v < w && v0 == q0 && v1 == q1 && v2 == q2;
        hit = v0 <= x && x < v0 + p && abs(v1 - q1) < p && abs(v2 - q2) < p;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    // the counts alternate between two rows, so no row is rewritten
    // while a slower thread still reads it
    if (lane == 0) counts[round][warp] = __popc(ballot);
    if (__syncthreads_count(hit) == 0) continue;
    if (__syncthreads_or(twin)) return;   // the twin owns every cell
    int at = nnear;
#pragma unroll
    for (int u = 0; u < kScatterWarps; ++u) {
      at += u < warp ? counts[round][u] : 0;
      nnear += counts[round][u];
    }
    if (hit) {
      const int v0 = __ldg(pos + 3 * v), v1 = __ldg(pos + 3 * v + 1),
                v2 = __ldg(pos + 3 * v + 2);
      near[at + __popc(ballot & ((1u << lane) - 1u))] =
          make_int4(v, q1 - v1, q2 - v2,
                    (v * p + x - v0) * pp + (q1 - v1) * p + (q2 - v2));
    }
  }
  if (nnear > 0) __syncthreads();         // the list is read below
  int nlow = 0;                           // the entries below w
  while (nlow < nnear && near[nlow].x < w) ++nlow;

  // a thread's cells come in order, so a pass is live while its first is
  while (jj[0] < p) {
    bool mine[kScatterCells];
    int c[kScatterCells];
#pragma unroll
    for (int u = 0; u < kScatterCells; ++u) {
      mine[u] = jj[u] < p;
      for (int a = 0; a < nlow && mine[u]; ++a) {
        const int4 e = near[a];
        mine[u] = !inside(jj[u] + e.y, kk[u] + e.z, p);
      }
      c[u] = jj[u] * p + kk[u];
      sum[u] += term[u];
    }
    for (int a0 = nlow; a0 < nnear; a0 += kScatterTerms) {
      // a batch's terms go out together, straight to shared memory; a
      // sum takes a term only where its window covers the cell
      unsigned take[kScatterCells];
#pragma unroll
      for (int u = 0; u < kScatterCells; ++u) take[u] = 0;
#pragma unroll
      for (int a = 0; a < kScatterTerms; ++a) {
        const int4 e = near[min(a0 + a, nnear - 1)];
#pragma unroll
        for (int u = 0; u < kScatterCells; ++u) {
          const bool in = mine[u] && a0 + a < nnear &&
                          inside(jj[u] + e.y, kk[u] + e.z, p);
          take[u] |= (unsigned)in << a;
          copy_async(stage + (u * kScatterTerms + a) * kScatterThreads,
                     rates + (in ? e.w + c[u] : 0), in);
        }
      }
      copy_async_wait();
#pragma unroll
      for (int u = 0; u < kScatterCells; ++u)
#pragma unroll
        for (int a = 0; a < kScatterTerms; ++a) {
          const real next =
              sum[u] + stage[(u * kScatterTerms + a) * kScatterThreads];
          sum[u] = (take[u] >> a) & 1u ? next : sum[u];
        }
    }
#pragma unroll
    for (int u = 0; u < kScatterCells; ++u)
      if (mine[u]) slab[jj[u] * m + kk[u]] = sum[u];
    load_pass(cur, p, m, slab, own, jj, kk, sum, term);
  }
}
#endif

}  // namespace

extern "C" {

// out (B, p, p, p) <- the windows of field (m0, m, m) at the B corners
// pos.  Returns the first CUDA error code, 0 on success.
int c2r_window_gather(const real* field, int m0, int m, const int* pos,
                      int nwin, int p, real* out, void* stream) {
#ifdef C2R_WINDOW_GATHER_PER_CELL
  const size_t total = (size_t)nwin * p * p * p;
  gather_cells<<<blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      field, m0, m, pos, total, p, out);
#else
  gather_slabs<<<dim3(nwin, p), dim3(kRowLanes, kRowWarps), 0,
                 (cudaStream_t)stream>>>(field, m0, m, pos, p, out);
#endif
  return (int)cudaGetLastError();
}

// The most windows one scatter-add launch takes on the current device
// (0 if the device cannot be queried): the block's list, 16 bytes a
// window, its terms in flight (16 KB in float, 32 KB in double) and its
// static shared memory must
// fit the shared memory a block may opt in to, and a window is one row of
// the grid (y <= 65535).  The caller splits a longer batch into
// consecutive launches in window order, which add the same sums in the
// same order as one launch.
int c2r_window_scatter_max_windows(void) {
#ifdef C2R_WINDOW_SCATTER_ATOMIC
  return 0x7fffffff;
#else
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, scatter_slabs) != cudaSuccess)
    return 0;
  const long terms =
      (long)kScatterCells * kScatterTerms * kScatterThreads * sizeof(real);
  const long fit =
      ((long)optin - (long)attr.sharedSizeBytes - terms) / (long)sizeof(int4);
  return fit < 0 ? 0 : (int)(fit < 65535 ? fit : 65535);
#endif
}

// acc (m0, m, m) += each window of rates (B, p, p, p) at its corner, in
// place, in window order.  Returns the first CUDA error code, 0 on
// success (cudaErrorInvalidValue where B exceeds
// c2r_window_scatter_max_windows()).
int c2r_window_scatter_add(real* acc, int m0, int m, const int* pos,
                           int nwin, int p, const real* rates,
                           void* stream) {
#ifdef C2R_WINDOW_SCATTER_ATOMIC
  const size_t total = (size_t)nwin * p * p * p;
  scatter_cells<<<blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      acc, m0, m, pos, total, p, rates);
#else
  const size_t smem =
      (size_t)kScatterCells * kScatterTerms * kScatterThreads * sizeof(real) +
      (size_t)nwin * sizeof(int4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_slabs, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  scatter_slabs<<<dim3(p, nwin), kScatterThreads, smem,
                  (cudaStream_t)stream>>>(acc, m0, m, pos, nwin, p, rates);
#endif
  return (int)cudaGetLastError();
}

const char* c2r_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
