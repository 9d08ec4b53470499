// The fused window sweep, hand-written for Hopper (sm_90a): the march of a
// batch of source-centred windows (K3's cluster form) with the rate pass
// (K2w) as its per-cell epilogue, in one launch.
//
// Replaces, on the windowed path, c2ray_tpu/ops/sweep_pallas.py::_kernel
// (:59, the march inside a source's window) followed by the rate pass of
// c2ray_tpu/ops/sweep.py::_rate_pass (:663) as the JAX windowed_batch
// vmaps it (:917): B windows of p^3 cells (p = 2r + 1, the windows that
// c2r_window_gather cuts) -> per cell the per-atom photoionization rate
// phih (and, non-isothermal, the heating rate phiheat), per window the
// boundary loss and the LLS tally, and their two sums over the batch.  The
// columns never reach device memory.  Every build of K2 has it: float32 or
// float64 (-DC2R_F64), mixture or table rates (-DC2R_TABLE), each with the
// 12 instances of LLS off / scalar / grid x heat x X-ray (a grid LLS cube
// is also K3's kGridLLS), the R_max barrier a runtime rmax2 (+inf when
// off); the per-step scalars dr, rate_scale, lcol, rmax2 are read from the
// card where the caller gives pointers, as K2 reads them.
//
// One definition of each device function: the march's per-cell code
// (window_cell, window_owned, window_fixups) is window_march.cuh, which K3
// compiles too; the rate pass's (pair_geometry, pair_rates and beneath
// them) is rates.cuh, which K2 and K2w compile.  Built with --fmad=false,
// phih and phiheat are bitwise those of K3 then K2w, and of the plain
// PyTorch version (ops/sweep_cuda.window_sweep_reference).  The losses are
// the same terms summed in another order (in double), so they agree with
// K2w's and the plain version's to the last places.
//
// What bounds it on the H100, at r = 8 x 256 windows in float32 (1.258 M
// window cells): bytes, the windows read once and phih written once (10.1
// MB, 0.003 ms at 3.35 TB/s; K3 + K2w moved 25 MB between them, cdo
// written and read back); the SFU, the march's ~6 results on 1.5 M
// live-square plane cells and the rate pass's 37 on every lit cell, ~0.013
// ms.  In practice the instruction issue of the rate pass (expm1f is a
// software sequence around one SFU result; --fmad=false pins the
// arithmetic to the plain version's) and the march's chain of r dependent
// shells per block: a block's chain now carries its owned cells' rates, a
// few per thread in sequence each shell, and every block of a launch
// reaches the same phase together, so the march's latency and the rate
// pass's issue-bound work do not overlap.  On the H100 it takes more
// device time than K3 then K2w (about 1.2x at r = 8 x 256 in float32,
// more in float64 and at r = 32 and 64, where few windows busy few SMs);
// what it saves is a launch, a wrapper and the columns' round trip
// (PERF.md).
//
// Design:
//  * K3's cluster form: one thread-block cluster of six blocks per window,
//    one block per face, all shells in one launch, the face's two
//    ping-pong planes in shared memory and the wedge fixups read from the
//    sibling faces' planes through distributed shared memory (DSMEM);
//  * each block stages the mixture terms after its planes (none in a
//    table build: the tables are read through the read-only cache, as K2
//    reads them); the window's fluxes are a register per thread;
//  * the rate epilogue: in the cluster form every cell of the window is
//    owned by exactly one face block, which holds its final column once,
//    in the shell where it is computed (window_owned; an owned cell is
//    never a fixup cell).  The thread that computed it evaluates the rate
//    there, from the column in its block's plane, the cell's density (and
//    grid LLS column) and its integer offsets from the centre, and writes
//    phih (and phiheat), exactly zero where the pair is dead.  The source
//    cell (d = 0) is face 0's thread 0's;
//  * the shell chain stays short: a block arrives at the cluster barrier
//    (barrier.cluster.arrive) as soon as its plane of shell d is written,
//    evaluates shell d's rates while its siblings finish theirs, and only
//    then waits (barrier.cluster.wait) before the fixups read their
//    planes.  The rates read only the block's own owned cells, which no
//    fixup writes;
//  * deterministic losses: each thread adds its cells' boundary losses and
//    LLS tallies in double, in the fixed order it visits them; a block sums
//    its threads in a fixed order (warp shuffles, then the warps in order);
//    block 0 of the cluster sums the six blocks' sums through DSMEM in rank
//    order into the window's loss and tally; the last cluster to finish (a
//    device counter it resets) sums the batch's, window by window in a
//    fixed order.  Every run gives the same bits;
//  * its own fit rule (window_sweep_fits, exported as
//    c2r_window_sweep_fits, which the wrapper asks): the planes (2 p^2
//    elements), the staged terms and the reduction slots in one block's
//    232,448 bytes of shared memory.  In float32 that is p <= 170, every
//    windowed rung at 256^3; in float64 p <= 120, so r = 64 (p = 129) and
//    larger windows go to K3 (its per-shell form) and K2w;
//  * blocks of at most 512 threads (3 live-square cells per thread at the
//    largest shell, as K3), so the rate pass keeps up to 128 registers a
//    thread.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "rates.cuh"
#include "real.cuh"
#include "window_march.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kFaces = 6;                 // blocks per cluster, one per face
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kCellsPerThread = 3;        // live-square cells, largest shell
constexpr size_t kBlockSmem = 232448;     // shared memory one block may use
// doubles ahead of the planes: the warps' loss and tally partials, the
// block's two sums (read by the cluster's block 0) and the last-cluster flag
constexpr int kHeadDoubles = 2 * kMaxWarps + 4;

size_t sweep_smem_bytes(int p, int K, int Kx, bool heat, bool xray) {
  return kHeadDoubles * sizeof(double) +
         ((size_t)2 * p * p + terms_elems(K, Kx, heat, xray)) * sizeof(real);
}

// The one place the fused form's fit is decided.
int window_sweep_fits(int p, int K, int Kx, bool heat, bool xray) {
  return p >= 1 && sweep_smem_bytes(p, K, Kx, heat, xray) <= kBlockSmem;
}

int sweep_threads(int p) {
  int t = (p * p + kCellsPerThread - 1) / kCellsPerThread;
  t = (t + 31) / 32 * 32;
  return t < 64 ? 64 : (t > kMaxThreads ? kMaxThreads : t);
}

// Clusters of a launch that have finished; the last one sums the batch
// and sets it back to 0 for the next launch.
__device__ unsigned int g_sweeps_done = 0;

__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// What a window's rate epilogue reads besides the launch's parameters.
struct Window {
  const real* nd3;      // (p, p, p) its neutral density
  const real* lc3;      // (p, p, p) its grid LLS columns (kLLS == 2)
  real* ph3;            // (p, p, p) its phih out
  real* he3;            // (p, p, p) its phiheat out (kHeat)
  real nf, nfx;         // its fluxes
  int n, c, p_lim, q_lim;
};

// The rate pass at cube cell (i, j, k) of a window whose column out there
// is cd (consume_windows' cell, K2w): phih (and phiheat) written, exactly
// zero where the pair is dead; a live pair's boundary loss and LLS tally
// added to the thread's sums.
template <bool kTable, int kLLS, bool kHeat, bool kXray>
__device__ __forceinline__ void cell_rates(const Consume& p, const Terms& m,
                                           const Window& w, int i, int j,
                                           int k, real cd, double& loss,
                                           double& tally) {
  const int at = (i * w.n + j) * w.n + k;
  const real nd = w.nd3[at];
  const real lcol = kLLS == 2 ? w.lc3[at] : p.lcol;
  const real col_hi = nd * (kSqrt3 * p.dr);
  const bool can_stop = nd >= rl(0.);
  const int oi = i - w.c, oj = j - w.c, ok = k - w.c;
  int cheb;
  real dist2, path, cin;
  const bool live = pair_geometry(p, oi, oj, ok, true, cd, nd, col_hi,
                                  can_stop, cheb, dist2, path, cin);
  real rate = rl(0.), heat = rl(0.);
  if (live) {
    const bool bnd = oi == w.p_lim || oi == -w.q_lim || oj == w.p_lim ||
                     oj == -w.q_lim || ok == w.p_lim || ok == -w.q_lim;
    const PairOut o = pair_rates<kTable, kLLS, kHeat, kXray>(
        p, m, w.nf, w.nfx, cd, cin, path, dist2, cheb == 0, nd, lcol, bnd);
    rate = o.rate;
    heat = o.heat;
    loss += (double)o.loss;
    tally += (double)o.lls;
  }
  w.ph3[at] = rate;
  if (kHeat) w.he3[at] = heat;
}

// Block f of cluster q marches face f of window q through shells
// 1..nshell (K3's march_window_cluster) and evaluates the rates of the
// cells it owns as it finalises them.
template <bool kTable, int kLLS, bool kHeat, bool kXray>
__global__ void __cluster_dims__(kFaces, 1, 1)
    __launch_bounds__(kMaxThreads)
window_sweep(Consume p, int nshell) {
  constexpr bool kGridLLS = kLLS == 2;
  read_step_scalars(p);
  extern __shared__ double smem[];
  double* red = smem;                           // [2][kMaxWarps]
  double* blk = red + 2 * kMaxWarps;            // [2]: loss, tally
  double* last = blk + 2;                       // [1]: 1 in the last cluster
  real* planes = reinterpret_cast<real*>(smem + kHeadDoubles);
  cg::cluster_group cluster = cg::this_cluster();
  const int f = (int)cluster.block_rank();
  const int win = blockIdx.x / kFaces;
  const int n = p.n, nn = n * n, c = n / 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Terms m = stage_terms<kHeat, kXray>(p, planes + 2 * nn, tid, nt);
  // zero outside the live square: the corners a shell reads there carry
  // weight 0, and c * 0 is 0 only for finite c
  for (int q = tid; q < 2 * nn; q += nt) planes[q] = rl(0.);
  const size_t off = (size_t)win * nn * n;
  Window w;
  w.nd3 = p.ndhi + off;
  w.lc3 = kGridLLS ? p.lls + off : nullptr;
  w.ph3 = p.phih + off;
  w.he3 = kHeat ? p.phiheat + off : nullptr;
  w.nf = __ldg(p.nflux + win);
  w.nfx = kXray ? __ldg(p.nfx + win) : rl(0.);
  w.n = n;
  w.c = c;
  w.p_lim = min(p.max_shell, n - 1 - c);
  w.q_lim = min(p.max_shell, c);
  const real cdo0 = w.nd3[(c * n + c) * n + c] * (rl(0.5) * p.dr);
  // the sibling faces' planes, for the wedge fixups
  const real* pz = cluster.map_shared_rank(planes, 0);
  const real* mz = cluster.map_shared_rank(planes, 1);
  const real* py = cluster.map_shared_rank(planes, 2);
  const real* my = cluster.map_shared_rank(planes, 3);
  WindowShell s;
  s.wins = p.ndhi;
  s.lwins = p.lls;
  s.prev = nullptr;
  s.cur = nullptr;
  s.out = nullptr;
  s.n = n;
  s.c = c;
  s.dr = p.dr;
  s.lcol = p.lcol;
  s.use_lls = kLLS;
  double loss = 0.0, tally = 0.0;
  __syncthreads();
  if (f == 0 && tid == 0)
    cell_rates<kTable, kLLS, kHeat, kXray>(p, m, w, c, c, c, cdo0, loss,
                                           tally);

  for (int d = 1; d <= nshell; ++d) {
    s.d = d;
    const real* prev = planes + ((d - 1) & 1) * nn;
    real* cur = planes + (d & 1) * nn;
    const int lo = c - d, hi = c + d < n ? c + d : n - 1;
    const int wd = hi - lo + 1;
    const int row = c + ((f & 1) ? -d : d);     // == n only at even n, d = c
    // this face's values on the live square, cells in row-major order
    // (consecutive threads on consecutive b)
    const int qa = nt / wd, qb = nt - qa * wd;
    const int a0 = lo + tid / wd, b0 = lo + tid % wd;
    for (int a = a0, b = b0; a <= hi;) {
      cur[a * n + b] =
          window_cell<kGridLLS>(s, prev, w.nd3, w.lc3, f, a, b, cdo0);
      a += qa;
      b += qb;
      if (b > hi) {
        b -= wd;
        ++a;
      }
    }
    cluster_arrive();
    // the rates of the cells this thread just finalised, while the
    // siblings finish their planes
    if (row < n) {
      for (int a = a0, b = b0; a <= hi;) {
        if (window_owned(f, a, b, c, d)) {
          const real cd = cur[a * n + b];
          if (f < 2)
            cell_rates<kTable, kLLS, kHeat, kXray>(p, m, w, a, b, row, cd,
                                                   loss, tally);
          else if (f < 4)
            cell_rates<kTable, kLLS, kHeat, kXray>(p, m, w, a, row, b, cd,
                                                   loss, tally);
          else
            cell_rates<kTable, kLLS, kHeat, kXray>(p, m, w, row, a, b, cd,
                                                   loss, tally);
        }
        a += qa;
        b += qb;
        if (b > hi) {
          b -= wd;
          ++a;
        }
      }
    }
    cluster_wait();
    window_fixups(cur, pz, mz, py, my, f, n, c, d, lo, hi, tid, nt);
    __syncthreads();
  }

  // the block's sums: warp shuffles, then the warps in order
  loss = warp_sum_d(loss);
  tally = warp_sum_d(tally);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    red[warp] = loss;
    red[kMaxWarps + warp] = tally;
  }
  __syncthreads();
  if (tid < 2) {
    double x = 0.0;
    for (int q = 0; q < nt / 32; ++q) x += red[tid * kMaxWarps + q];
    blk[tid] = x;
  }
  // every block's sums written, and no sibling still reads a plane
  cluster.sync();
  if (f == 0 && tid < 2) {
    double x = 0.0;
    for (int r = 0; r < kFaces; ++r)
      x += cluster.map_shared_rank(blk, r)[tid];
    p.loss[tid * p.nsrc + win] = (real)x;
    __threadfence();
  }
  // no block leaves while block 0 reads its sums
  cluster.sync();
  if (f != 0) return;
  if (tid == 0) {
    const unsigned total = gridDim.x / kFaces;
    *last = atomicAdd(&g_sweeps_done, 1u) == total - 1 ? 1.0 : 0.0;
  }
  __syncthreads();
  if (*last == 0.0) return;
  __threadfence();
  // the last cluster: the two sums over the batch, window by window
  if (warp < 2) {
    double x = 0.0;
    for (int q = lane; q < p.nsrc; q += 32)
      x += (double)__ldcg(p.loss + (size_t)warp * p.nsrc + q);
    x = warp_sum_d(x);
    if (lane == 0) p.loss[2 * p.nsrc + warp] = (real)x;
  }
  if (tid == 0) g_sweeps_done = 0;
}

template <bool kTable, int kLLS, bool kHeat, bool kXray>
int launch_sweep(const Consume& prm, int nwin, int nshell, size_t smem,
                 cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_sweep<kTable, kLLS, kHeat, kXray>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  window_sweep<kTable, kLLS, kHeat, kXray>
      <<<kFaces * nwin, sweep_threads(prm.n), smem, st>>>(prm, nshell);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 if c2r_window_sweep runs at window extent p with K (Kx) mixture terms
// staged (0 in a table build), heat and X-ray as given; 0 if the caller
// must take K3 and K2w instead.
int c2r_window_sweep_fits(int p, int K, int Kx, int use_heat, int use_xray) {
  return window_sweep_fits(p, kTableBuild ? 0 : K, kTableBuild ? 0 : Kx,
                           use_heat != 0, use_xray != 0);
}

// The fused window sweep: wins (B, p, p, p) neutral-density windows, each
// centred on its source, marched to nshell = min(max_shell, p / 2) shells
// and their rate pass, in one launch.  lwins: the grid LLS columns'
// windows (use_lls 2, else ignored), nflux, nfx: (B,).  phih (and phiheat
// with use_heat): (B, p, p, p) out; cells beyond nshell are never written
// (the caller zero-fills them when nshell < p / 2).  loss: 2*B + 2
// elements out: the per-window boundary losses, the per-window LLS
// tallies, then their two sums over the batch.  The other arguments are
// c2r_consume_windows'.  Returns cudaErrorInvalidValue where
// c2r_window_sweep_fits says no, else the first CUDA error code, 0 on
// success.
int c2r_window_sweep(const real* wins, const real* lwins, const real* nflux,
                     const real* nfx, const void* const* tables, int K,
                     int Kx, int num_tau, int nwin, int p, int max_shell,
                     double dr, double rate_scale, double lcol, double rmax2,
                     const double* const* step, int use_lls, int use_heat,
                     int use_xray, double max_coldensh, double minlogtau,
                     double dlogtau, double photo_limit, double heat_limit,
                     real* phih, real* phiheat, real* loss, void* stream) {
  const Consume prm = make_params(
      nullptr, wins, lwins, nflux, nfx, tables, K, Kx, num_tau, nwin, p,
      max_shell, dr, rate_scale, lcol, rmax2, step, max_coldensh, minlogtau,
      dlogtau, photo_limit, heat_limit, phih, phiheat, nullptr, loss);
  if (use_lls < 0 || use_lls > 2 || nwin < 1 || nwin > 65535 ||
      max_shell < 1 ||
      !window_sweep_fits(p, prm.K, prm.Kx, use_heat != 0, use_xray != 0))
    return (int)cudaErrorInvalidValue;
  const int nshell = max_shell < p / 2 ? max_shell : p / 2;
  const size_t smem =
      sweep_smem_bytes(p, prm.K, prm.Kx, use_heat != 0, use_xray != 0);
  cudaStream_t st = (cudaStream_t)stream;
  const int v = use_lls * 4 + (use_heat ? 2 : 0) + (use_xray ? 1 : 0);
  switch (v) {
#define C2R_SWEEP_CASE(L, H, X)                                            \
    case L * 4 + H * 2 + X:                                                \
      return launch_sweep<kTableBuild, L, H != 0, X != 0>(prm, nwin,       \
                                                          nshell, smem, st);
    C2R_SWEEP_CASE(0, 0, 0) C2R_SWEEP_CASE(0, 0, 1)
    C2R_SWEEP_CASE(0, 1, 0) C2R_SWEEP_CASE(0, 1, 1)
    C2R_SWEEP_CASE(1, 0, 0) C2R_SWEEP_CASE(1, 0, 1)
    C2R_SWEEP_CASE(1, 1, 0) C2R_SWEEP_CASE(1, 1, 1)
    C2R_SWEEP_CASE(2, 0, 0) C2R_SWEEP_CASE(2, 0, 1)
    C2R_SWEEP_CASE(2, 1, 0) C2R_SWEEP_CASE(2, 1, 1)
#undef C2R_SWEEP_CASE
  }
  return (int)cudaErrorInvalidValue;
}

const char* c2r_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
