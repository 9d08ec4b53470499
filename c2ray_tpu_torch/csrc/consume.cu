// Fused rate deposition ("consume") for a batch of sources, hand-written
// for Hopper (sm_90a).
//
// Replaces: c2ray_tpu/ops/sweep_pallas.py::_kernel_consume (launcher
// consume_rates_pallas): per source, the source-centred coldensh_out cube
// is read in grid frame, the cell geometry and the exponential-mixture
// photoionization rates of c2ray_tpu/ops/sweep.py::_rate_pass and
// ops/tables.py::_photoion_expsum_impl are evaluated (with the fused LLS
// tally), the per-atom rates are summed over the batch into one grid-frame
// phih cube, and the per-source boundary and LLS photon losses are tallied.
// The non-isothermal build (kHeat, _kernel_consume's has_heat) also sums
// each live pair's photo-heating rate nf * sum_k hw_k * absorb_k / vol_ph
// * rate_scale over the batch into a second grid-frame cube, phiheat.
// Any cubic n.  LLS off, a scalar LLS column per cell (type 1, or type 2
// without a grid), or a grid LLS cube (type 2, _kernel_consume's has_lls:
// the cell's own column lls[cell]); the R_max barrier of LLS type 3 (a
// pair with dist2 > rmax2 is dead); and X-ray sources (use_xray: a second
// exponential mixture, the power-law one, under the per-source X-ray
// fluxes nfx).
//
// What bounds it on the H100 depends on the data.  A live (cell, source)
// pair (inside max_shell, incoming column <= max_coldensh) evaluates K
// mixture terms with one expf and one expm1f each, two more with the LLS
// tally: 4K + 5 SFU results per pair (37 at K = 8; the heat build adds
// one division and, per term, a multiply and an add), so with every cell
// lit the SFU bounds it (~2.4 ms at 256^3 x 16, 16 results per clock per
// SM); in practice the instruction issue does, since expm1f is a software
// sequence of a few dozen instructions around one SFU result.  A dead
// pair adds exactly zero and needs only its column: on optically thick
// grids, where most rays stop after a cell, the compulsory bytes bound it
// (the column cube read once, 1.07 GB, 0.32 ms at 3.35 TB/s).
//
// Design:
//  * one thread per grid cell, a 3-D launch with k fastest: a block is 32
//    k by 8 j of one i, a warp 32 consecutive k of one j, so the column
//    reads of a source are contiguous and liveness is nearly
//    warp-uniform.  No 64-bit division or modulo: source offsets lie in
//    (-n, 2n) and wrap by compare and subtract;
//  * the thread loops over the B sources in a fixed order, so phih is
//    deterministic without atomics;
//  * the column and the live test come first; a dead pair skips the
//    mixture (its rate, boundary loss and LLS tally are exactly zero, as
//    the plain version's masks make them, and a NaN stays where the pair
//    is live), and a warp whose pairs are all dead skips its two shuffle
//    reductions too;
//  * most dead pairs skip the geometry as well: a path is at most sqrt(3)
//    cells and float rounding is monotonic, so cd - nd * fl(sqrt(3) * dr)
//    > max_coldensh already implies cin > max_coldensh (for nd >= 0); only
//    the other pairs pay the division and the sqrt of their path;
//  * source cells, fluxes and the K mixture terms (a_k, w_k, and the heat
//    weights hw_k in the heat build) are staged in shared memory once per
//    block; the mixture loop is unrolled by 8, and the LLS tally and the
//    heat are template parameters, so neither costs a branch per term and
//    the isothermal build is the one without heat;
//  * the LLS mode (off, scalar, grid), the heat and the X-ray mixture are
//    template parameters; the R_max barrier is a runtime scalar, rmax2 =
//    +inf when type 3 is off (dist2 > inf is false for every finite
//    dist2, so the bits are those of the plain version's untaken
//    branch).  dist2 comes from integer offsets, so the barrier joins the
//    dead-pair test before any geometry: a pair beyond R_max is skipped
//    outright, exactly, as the plain version's mask zeroes it;
//  * grid LLS: a thread owns a grid cell, so the cell's LLS column is one
//    read per cell, before the source loop, and replaces the scalar in the
//    pre-LLS column;
//  * X-ray: the power-law mixture (Kx terms, staged in shared memory after
//    the stellar one, the fluxes nfx beside nf) reads the same tau_in,
//    dtau (and tau_pre, dtau_pre) as the stellar one.  Each mixture gives
//    its own photo_cell = (nf * phi_cell) / vol_ph, photo_out = nf *
//    phi_in - nf * phi_cell, heat (nf * heat_acc) / vol_ph and LLS tally
//    nf * lls_acc / vol_ph, the X-ray one's added to the stellar one's;
//    only then come * rate_scale / nd and the sums, in the plain version's
//    order (ops/tables.py::_photoion_expsum_impl).  The TPU kernel sums
//    nf * phi + nfx * xphi before one divide, a last-place difference.  A
//    pure X-ray source (nf = 0) deposits: nothing here skips a source for
//    its flux;
//  * heat reuses each term's absorb_k, so it adds no SFU result in the
//    loop; a live pair's heat is ((nf * heat_acc) / vol_ph) * rate_scale,
//    in the plain version's order, summed over the sources in the same
//    fixed order as phih (a dead pair adds exactly zero);
//  * expf / expm1f follow _photoion_expsum_impl exactly, including the
//    separate 80-clamp on the pre-LLS optical depth (no exponential is
//    shared between the main and the LLS terms: that would change the
//    rounding);
//  * the boundary-loss and heat divisor is 1/vol_ph as in _rate_pass; the
//    TPU kernel's 1/(vol*ndhi)*ndhi form gives NaN at zero density;
//  * per-source losses reduce in two deterministic stages: warp shuffles
//    and a per-block sum into (2, B, nblocks) partials, then a second
//    launch sums each source's partials in a fixed order in double.  The
//    block count comes from c2r_consume_nblocks, which the wrapper calls
//    to size the partials.
//
// The window mode (K2w, consume_windows): the same rate pass on a batch of
// B source-centred windows of p^3 cells, p = 2r + 1, the output of the
// window march (K3) on the windows the gather (K4) copied, before the
// scatter-add (K5).  Replaces no Pallas kernel: on the TPU XLA fuses the
// vmapped c2ray_tpu/ops/sweep.py::_rate_pass of windowed_batch, and the
// plain PyTorch version runs it as ~275 eager torch calls per batch.  It
// shares the grid mode's device functions (the geometry and stop tests,
// the mixture and the table reads), so it has every build and instance
// the grid mode has, with the same order of operations.  What bounds it
// on the H100: as the grid mode, the SFU where the windows are lit, else
// its bytes (cdo and wins read, phih written: 15.1 MB at r = 8 x 256 in
// float32, 0.0045 ms).  Design:
//  * one thread per (window, cell), grid (ceil(p^3 / 256), B): a block is
//    a chunk of one window's cells, k fastest, so the reads are
//    contiguous; the offsets from the window's centre are integers (no
//    wrap: every field is already centred), and the trace boundary is
//    the window's surface (p_lim = q_lim = min(max_shell, r));
//  * each cell writes its own rate (and heat), exactly zero where dead,
//    so no sum over sources and no atomics; a zero-flux padding window
//    is not skipped for its flux;
//  * the losses reduce in two deterministic stages in ONE launch: warp
//    shuffles and a per-block sum into (2, B, blocks-per-window)
//    partials; the last block to finish (a device counter, reset by that
//    block) sums each window's partials in a fixed order in double, then
//    the two sums over the batch, so a windowed batch makes no torch
//    reduction and one launch.
// The windowed path takes K2w only where the fused window sweep
// (window_sweep.cu: the window march with this rate pass as its per-cell
// epilogue) does not fit a block; the device functions the three kernels
// share (the geometry, the stop tests, the mixture and the table reads)
// are defined once, in rates.cuh.
//
// Element type and rate mode: each build is one shared library.  The
// element type (real.cuh) is float32, or float64 with -DC2R_F64; the
// rates are the exponential mixture, or with -DC2R_TABLE the lookup
// tables of rate_eval "table" (the mode that rate_eval "auto" picks in
// float64): the kernel's kTable template parameter, and the 12 instances
// of (LLS mode, heat, X-ray) are built for the build's mode.  The JAX
// package never takes its Pallas kernel in these modes: XLA runs
// c2ray_tpu/ops/sweep.py::_rate_pass there, and the table builds follow
// the port's plain ops/tables.py::photoion_rates table branch op for op:
//  * the lookup (table_lookup): log(max(tau, 1e-20)) * log10(e), the
//    clamped position, its floor and residual, two reads and t0 + (t1 -
//    t0) * resid; a pair computes the position of each optical depth
//    once and reads the photo and heat tables (and the X-ray ones) there;
//  * the thick difference or the thin rate as |dtau| passes its limit
//    (in float32 the limits rise to 3e-3 and the thin rate is read at the
//    midpoint optical depth, in float64 at tau_in);
//  * the LLS tally a second evaluation from the pre-LLS column to the
//    post-LLS one, its photo_cell the tally; X-ray each quantity after
//    its own evaluation, added to the stellar one;
//  * the tables are read through the read-only cache, not staged: a block
//    of 256 cells would stage 16-64 KB of tables, as many bytes as its
//    columns of all 16 sources;
//  * what bounds a live pair: three or four logs (tau_in, tau_out, the
//    midpoint in float32; with the LLS tally tau_pre and its midpoint),
//    two to four reads per table, no exponential.
// The dead-pair skip and the stop bound hold in either type: every step
// of cd - nd * fl(sqrt(3) * dr) rounds monotonically, and the path a
// pair computes is at most fl(sqrt(3)), since t2 / d^2 <= 2 exactly.
// Built with --fmad=false so each product and sum rounds as in the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stddef.h>

#include "rates.cuh"
#include "real.cuh"

namespace {

constexpr int kTileK = 32;                      // one warp of k
constexpr int kTileJ = 8;                       // warps per block
constexpr int kThreads = kTileK * kTileJ;

dim3 cell_grid(int n) {
  return dim3((n + kTileK - 1) / kTileK, (n + kTileJ - 1) / kTileJ, n);
}

__device__ __forceinline__ int wrap1(int x, int n) {
  return x < 0 ? x + n : (x >= n ? x - n : x);
}

__device__ __forceinline__ real warp_sum(real v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Elements of the cell kernel's shared memory (its B source cells follow
// as ints): the warps' loss partials, the fluxes and the mixture terms
// (K = Kx = 0 in a table build).
size_t consume_smem_elems(int nsrc, int K, int Kx, bool heat, bool xray) {
  const int per_term = heat ? 3 : 2;
  return (size_t)2 * nsrc * kTileJ + nsrc + per_term * K +
         (xray ? nsrc + per_term * Kx : 0);
}

// K2, the grid mode: one thread per grid cell, the batch's sources summed
// in a fixed order.
template <bool kTable, int kLLS, bool kHeat, bool kXray>
__global__ void __launch_bounds__(kThreads) consume_cells(Consume p) {
  read_step_scalars(p);
  extern __shared__ real smem[];
  const int nsrc = p.nsrc;
  real* red = smem;                             // [2][B][kTileJ]
  real* s_nf = red + 2 * nsrc * kTileJ;         // [B]
  real* s_nfx = s_nf + nsrc;                    // [B] (kXray)
  const int tid = threadIdx.y * kTileK + threadIdx.x;
  const Terms m = stage_terms<kHeat, kXray>(p, s_nfx + (kXray ? nsrc : 0),
                                            tid, kThreads);
  int* s_pos = reinterpret_cast<int*>(
      s_nfx + (kXray ? nsrc : 0) + terms_elems(m.K, m.Kx, kHeat, kXray));
  for (int q = tid; q < 3 * nsrc; q += kThreads) s_pos[q] = p.srcpos[q];
  for (int q = tid; q < nsrc; q += kThreads) {
    s_nf[q] = p.nflux[q];
    if (kXray) s_nfx[q] = p.nfx[q];
  }
  __syncthreads();

  const int n = p.n, c = n / 2, pos_max = n - 1 - c;
  const size_t n3 = (size_t)n * n * n;
  const int kk = blockIdx.x * kTileK + threadIdx.x;
  const int jj = blockIdx.y * kTileJ + threadIdx.y;
  const bool valid = kk < n && jj < n;
  const int i = blockIdx.z, j = valid ? jj : 0, k = valid ? kk : 0;
  const size_t cell = ((size_t)i * n + j) * n + k;
  const real nd = valid ? p.ndhi[cell] : rl(1.);
  // the LLS column of this cell (one read per cell) or the scalar one
  const real lcol = kLLS == 2 ? (valid ? p.lls[cell] : rl(0.)) : p.lcol;
  // the most column a cell can add (path <= sqrt(3)); rounding is
  // monotonic, so cd - col_hi > max_coldensh implies cin > max_coldensh
  const real col_hi = nd * (kSqrt3 * p.dr);
  const bool can_stop = nd >= rl(0.);
  const int p_lim = min(p.max_shell, pos_max), q_lim = min(p.max_shell, c);
  const int warp = threadIdx.y, lane = threadIdx.x;
  real acc = rl(0.), hacc = rl(0.);

  for (int src = 0; src < nsrc; ++src) {
    const int oi = wrap1(i - s_pos[3 * src] + c, n) - c;
    const int oj = wrap1(j - s_pos[3 * src + 1] + c, n) - c;
    const int ok = wrap1(k - s_pos[3 * src + 2] + c, n) - c;
    const real cd = valid
        ? __ldg(p.cdo + src * n3 + ((size_t)(oi + c) * n + (oj + c)) * n +
                (ok + c))
        : rl(0.);
    int cheb;
    real dist2, path, cin;
    const bool live = pair_geometry(p, oi, oj, ok, valid, cd, nd, col_hi,
                                    can_stop, cheb, dist2, path, cin);
    real loss = rl(0.), lls = rl(0.);
    if (live) {
      const bool bnd = oi == p_lim || oi == -q_lim || oj == p_lim ||
                       oj == -q_lim || ok == p_lim || ok == -q_lim;
      const PairOut o = pair_rates<kTable, kLLS, kHeat, kXray>(
          p, m, s_nf[src], kXray ? s_nfx[src] : rl(0.), cd, cin, path, dist2,
          cheb == 0, nd, lcol, bnd);
      acc = acc + o.rate;
      if (kHeat) hacc = hacc + o.heat;
      loss = o.loss;
      lls = o.lls;
    }
    // a dead pair adds +0 to the warp's sums: skip them when all are dead
    if (__any_sync(0xffffffffu, live)) {
      loss = warp_sum(loss);
      lls = warp_sum(lls);
    }
    if (lane == 0) {
      red[(0 * nsrc + src) * kTileJ + warp] = loss;
      red[(1 * nsrc + src) * kTileJ + warp] = lls;
    }
  }
  if (valid) {
    p.phih[cell] = acc;
    if (kHeat) p.phiheat[cell] = hacc;
  }
  __syncthreads();
  const int nblocks = gridDim.x * gridDim.y * gridDim.z;
  const int block = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                    blockIdx.x;
  for (int q = tid; q < 2 * nsrc; q += kThreads) {
    real s = rl(0.);
    for (int w = 0; w < kTileJ; ++w) s += red[q * kTileJ + w];
    p.partial[(size_t)q * nblocks + block] = s;
  }
}

// One block per (tally, source): a fixed-order sum of the block partials.
__global__ void consume_reduce(const real* partial, int nblocks,
                               real* loss) {
  __shared__ double buf[kThreads];
  const real* row = partial + (size_t)blockIdx.x * nblocks;
  double s = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) s += row[b];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[blockIdx.x] = (real)buf[0];
}

// ---------------------------------------------------------------------------
// K2w, the window mode: the rate pass of a batch of source-centred windows
// ---------------------------------------------------------------------------

// Blocks of one window's cells in the window launch.
__host__ __device__ __forceinline__ int window_blocks(int p) {
  const long long p3 = (long long)p * p * p;
  return (int)((p3 + kThreads - 1) / kThreads);
}

// Blocks of a window launch that have finished; the last one to finish
// reduces the partials and sets it back to 0 for the next launch.
__device__ unsigned int g_windows_done = 0;

__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The last block of a window launch: each window's two tallies from its
// blocks' partials, in double, then their sums over the batch.  A row
// (tally, window) of at most 32 partials is one thread's, summed in order
// (the rows of a batch of small windows at once); a longer row is one
// warp's (each lane's partials in order, then the warp's shuffles).
__device__ void windows_final(const real* partial, int nwin, int nbx,
                              real* loss) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (nbx <= 32) {
    for (int row = threadIdx.x; row < 2 * nwin; row += kThreads) {
      const real* part = partial + (size_t)row * nbx;
      double s = 0.0;
      for (int b = 0; b < nbx; ++b) s += (double)__ldcg(part + b);
      loss[row] = (real)s;
    }
  } else {
    for (int row = warp; row < 2 * nwin; row += kThreads / 32) {
      const real* part = partial + (size_t)row * nbx;
      double s = 0.0;
      for (int b = lane; b < nbx; b += 32) s += (double)__ldcg(part + b);
      s = warp_sum_d(s);
      if (lane == 0) loss[row] = (real)s;
    }
  }
  __syncthreads();
  if (warp < 2) {
    double s = 0.0;
    for (int w = lane; w < nwin; w += 32)
      s += (double)__ldcg(loss + (size_t)warp * nwin + w);
    s = warp_sum_d(s);
    if (lane == 0) loss[2 * nwin + warp] = (real)s;
  }
}

// One thread per (window, cell): grid (window_blocks(p), B), each block a
// chunk of one window's p^3 cells, k fastest.  Every field is centred on
// the window's source (its centre cell c = p / 2), so the offsets are the
// cell's own coordinates less c, and the trace boundary is the window's
// surface.  A dead pair writes exactly zero.
template <bool kTable, int kLLS, bool kHeat, bool kXray>
__global__ void __launch_bounds__(kThreads) consume_windows(Consume p) {
  read_step_scalars(p);
  extern __shared__ real smem[];
  __shared__ bool s_last;
  real* red = smem;                             // [2][kTileJ]
  const int tid = threadIdx.x;
  const Terms m = stage_terms<kHeat, kXray>(p, red + 2 * kTileJ, tid,
                                            kThreads);
  __syncthreads();

  const int pw = p.n, c = pw / 2, pos_max = pw - 1 - c;
  const int pp = pw * pw, p3 = pp * pw;
  const int win = blockIdx.y, nbx = gridDim.x;
  const int cell = blockIdx.x * kThreads + tid;
  const bool valid = cell < p3;
  const int q = valid ? cell : 0;
  const int i = q / pp, jk = q - i * pp, j = jk / pw, k = jk - j * pw;
  const size_t at = (size_t)win * p3 + q;
  const real cd = valid ? __ldg(p.cdo + at) : rl(0.);
  const real nd = valid ? __ldg(p.ndhi + at) : rl(1.);
  const real lcol = kLLS == 2 ? (valid ? __ldg(p.lls + at) : rl(0.))
                              : p.lcol;
  const real col_hi = nd * (kSqrt3 * p.dr);
  const bool can_stop = nd >= rl(0.);
  const int p_lim = min(p.max_shell, pos_max), q_lim = min(p.max_shell, c);
  const int oi = i - c, oj = j - c, ok = k - c;
  int cheb;
  real dist2, path, cin;
  const bool live = pair_geometry(p, oi, oj, ok, valid, cd, nd, col_hi,
                                  can_stop, cheb, dist2, path, cin);
  real rate = rl(0.), heat = rl(0.), loss = rl(0.), lls = rl(0.);
  if (live) {
    const bool bnd = oi == p_lim || oi == -q_lim || oj == p_lim ||
                     oj == -q_lim || ok == p_lim || ok == -q_lim;
    const PairOut o = pair_rates<kTable, kLLS, kHeat, kXray>(
        p, m, __ldg(p.nflux + win), kXray ? __ldg(p.nfx + win) : rl(0.), cd,
        cin, path, dist2, cheb == 0, nd, lcol, bnd);
    rate = o.rate;
    heat = o.heat;
    loss = o.loss;
    lls = o.lls;
  }
  if (valid) {
    p.phih[at] = rate;
    if (kHeat) p.phiheat[at] = heat;
  }
  if (__any_sync(0xffffffffu, live)) {
    loss = warp_sum(loss);
    lls = warp_sum(lls);
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    red[warp] = loss;
    red[kTileJ + warp] = lls;
  }
  __syncthreads();
  if (tid < 2) {
    real s = rl(0.);
    for (int w = 0; w < kTileJ; ++w) s += red[tid * kTileJ + w];
    p.partial[((size_t)tid * p.nsrc + win) * nbx + blockIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) {
    const unsigned total = gridDim.x * gridDim.y;
    s_last = atomicAdd(&g_windows_done, 1u) == total - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  windows_final(p.partial, p.nsrc, nbx, p.loss);
  if (tid == 0) g_windows_done = 0;
}

}  // namespace

extern "C" {

// Blocks of the cell launch at mesh n: the partials hold 2*B of these.
int c2r_consume_nblocks(int n) {
  const dim3 g = cell_grid(n);
  return (int)(g.x * g.y * g.z);
}

// partial: scratch of 2*B*c2r_consume_nblocks(n) elements.
// loss: (2, B) -> row 0 boundary losses, row 1 LLS losses.  use_lls: 0 LLS
// off, 1 the scalar column lcol, 2 the grid lls (n, n, n) (ignored, and may
// be null, otherwise).  tables: 8 device pointers, as Consume::tab; a
// mixture build reads K and Kx terms, a table build num_tau + 1 entries
// of each table and the table scalars minlogtau, dlogtau (table_lookup)
// and photo_limit, heat_limit (the thin limits); each build ignores the
// other's.  With use_heat the heat build runs (phiheat (n, n, n) out);
// with use_xray the X-ray rates run under the fluxes nfx (B,); otherwise
// those are ignored.  rmax2: the squared R_max barrier in cells (+inf when
// LLS type 3 is off).  Every scalar comes as a double, already rounded to
// the build's type where the plain version holds it in that type, and is
// cast to it here, as torch casts a Python float.  step: 4 pointers, for
// dr, rate_scale, lcol and rmax2 in that order; one that is not null
// points at that double on the card, which the kernel reads at launch
// instead (the device loop's graph replays one capture over steps of
// another dr).  Returns the first CUDA error code, 0 on success.
int c2r_consume(const real* cdo, const real* ndhi, const real* lls,
                const int* srcpos, const real* nflux, const real* nfx,
                const void* const* tables, int K, int Kx, int num_tau,
                int nsrc, int n, int max_shell, double dr, double rate_scale,
                double lcol, double rmax2, const double* const* step,
                int use_lls, int use_heat, int use_xray, double max_coldensh,
                double minlogtau,
                double dlogtau, double photo_limit, double heat_limit,
                real* phih, real* phiheat, real* partial, real* loss,
                void* stream) {
  Consume p = make_params(cdo, ndhi, lls, nflux, nfx, tables, K, Kx,
                          num_tau, nsrc, n, max_shell, dr, rate_scale, lcol,
                          rmax2, step, max_coldensh, minlogtau, dlogtau,
                          photo_limit, heat_limit, phih, phiheat, partial,
                          loss);
  p.srcpos = srcpos;
  if (use_lls < 0 || use_lls > 2) return (int)cudaErrorInvalidValue;
  const size_t smem =
      consume_smem_elems(nsrc, p.K, p.Kx, use_heat != 0, use_xray != 0) *
          sizeof(real) + (size_t)3 * nsrc * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = cell_grid(n), block(kTileK, kTileJ);
  // the instance of (LLS mode, heat, X-ray) in this build's rate mode
  const int v = use_lls * 4 + (use_heat ? 2 : 0) + (use_xray ? 1 : 0);
  switch (v) {
#define C2R_CONSUME_CASE(L, H, X)                                         \
    case L * 4 + H * 2 + X:                                               \
      consume_cells<kTableBuild, L, H != 0, X != 0>                       \
          <<<grid, block, smem, st>>>(p);                                 \
      break;
    C2R_CONSUME_CASE(0, 0, 0) C2R_CONSUME_CASE(0, 0, 1)
    C2R_CONSUME_CASE(0, 1, 0) C2R_CONSUME_CASE(0, 1, 1)
    C2R_CONSUME_CASE(1, 0, 0) C2R_CONSUME_CASE(1, 0, 1)
    C2R_CONSUME_CASE(1, 1, 0) C2R_CONSUME_CASE(1, 1, 1)
    C2R_CONSUME_CASE(2, 0, 0) C2R_CONSUME_CASE(2, 0, 1)
    C2R_CONSUME_CASE(2, 1, 0) C2R_CONSUME_CASE(2, 1, 1)
#undef C2R_CONSUME_CASE
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  consume_reduce<<<2 * nsrc, kThreads, 0, st>>>(
      partial, c2r_consume_nblocks(n), loss);
  err = cudaGetLastError();
  return (int)err;
}

// Blocks of one window's cells in the window launch at extent p: the
// partials hold 2*B of these.
int c2r_consume_windows_nblocks(int p) { return window_blocks(p); }

// The window mode (K2w): the rate pass of B windows of p^3 cells, each
// centred on its source.  cdo: (B, p, p, p) columns out, wins: (B, p, p, p)
// neutral densities, lwins: the grid LLS columns' windows (use_lls 2,
// else ignored), nflux, nfx: (B,).  phih (and phiheat with use_heat): (B,
// p, p, p) out.  partial: scratch of 2*B*c2r_consume_windows_nblocks(p)
// elements.  loss: 2*B + 2 elements out: the per-window boundary losses,
// the per-window LLS tallies, then their two sums over the batch.  The
// other arguments are c2r_consume's.  One launch: its last block reduces.
// Returns the first CUDA error code, 0 on success.
int c2r_consume_windows(const real* cdo, const real* wins, const real* lwins,
                        const real* nflux, const real* nfx,
                        const void* const* tables, int K, int Kx,
                        int num_tau, int nwin, int p, int max_shell,
                        double dr, double rate_scale, double lcol,
                        double rmax2, const double* const* step, int use_lls,
                        int use_heat, int use_xray, double max_coldensh,
                        double minlogtau, double dlogtau, double photo_limit,
                        double heat_limit, real* phih, real* phiheat,
                        real* partial, real* loss, void* stream) {
  const Consume prm = make_params(
      cdo, wins, lwins, nflux, nfx, tables, K, Kx, num_tau, nwin, p,
      max_shell, dr, rate_scale, lcol, rmax2, step, max_coldensh, minlogtau,
      dlogtau, photo_limit, heat_limit, phih, phiheat, partial, loss);
  if (use_lls < 0 || use_lls > 2 || nwin < 1 || nwin > 65535 || p < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(2 * kTileJ + terms_elems(prm.K, prm.Kx, use_heat != 0,
                                        use_xray != 0)) * sizeof(real);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(window_blocks(p), nwin), block(kThreads);
  const int v = use_lls * 4 + (use_heat ? 2 : 0) + (use_xray ? 1 : 0);
  switch (v) {
#define C2R_WINDOWS_CASE(L, H, X)                                         \
    case L * 4 + H * 2 + X:                                               \
      consume_windows<kTableBuild, L, H != 0, X != 0>                     \
          <<<grid, block, smem, st>>>(prm);                               \
      break;
    C2R_WINDOWS_CASE(0, 0, 0) C2R_WINDOWS_CASE(0, 0, 1)
    C2R_WINDOWS_CASE(0, 1, 0) C2R_WINDOWS_CASE(0, 1, 1)
    C2R_WINDOWS_CASE(1, 0, 0) C2R_WINDOWS_CASE(1, 0, 1)
    C2R_WINDOWS_CASE(1, 1, 0) C2R_WINDOWS_CASE(1, 1, 1)
    C2R_WINDOWS_CASE(2, 0, 0) C2R_WINDOWS_CASE(2, 0, 1)
    C2R_WINDOWS_CASE(2, 1, 0) C2R_WINDOWS_CASE(2, 1, 1)
#undef C2R_WINDOWS_CASE
  }
  return (int)cudaGetLastError();
}

const char* c2r_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
