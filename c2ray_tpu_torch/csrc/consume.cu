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

#include "real.cuh"

namespace {

constexpr real kSigma = rl(6.30e-18);             // SIGMA_HI_AT_ION_FREQ
constexpr real kFourPi = rl(12.566370614359172);
constexpr real kSqrt3 = rl(1.7320508075688772);   // the longest path, cells
constexpr int kTileK = 32;                      // one warp of k
constexpr int kTileJ = 8;                       // warps per block
constexpr int kThreads = kTileK * kTileJ;
// log10(e): the plain table_lookup's log10 (natural log times this)
constexpr double kLog10E = 0.4342944819032518;

#ifdef C2R_TABLE
constexpr bool kTableBuild = true;     // rate_eval "table"
#else
constexpr bool kTableBuild = false;    // the exponential mixture
#endif
// in float32 the plain version takes the thin rate at the midpoint
// optical depth (ops/tables.photoion_rates), in float64 at tau_in
constexpr bool kThinMid = sizeof(real) == 4;

struct Consume {
  const real* cdo;      // (B, n, n, n) centred coldensh_out
  const real* ndhi;     // (n, n, n) grid frame
  const real* lls;      // (n, n, n) grid frame LLS columns (kLLS == 2)
  const int* srcpos;     // (B, 3)
  const real* nflux;    // (B,)
  const real* nfx;      // (B,) X-ray fluxes (kXray)
  // The rates' tables.  Mixture builds: a (K,), w (K,), the heat
  // weights (K,, kHeat), then the X-ray mixture's three (Kx,, kXray).
  // Table builds: photo thick, photo thin, heat thick, heat thin (kHeat),
  // then the X-ray tables in the same order (kXray), num_tau + 1 entries
  // each.
  const real* tab[8];
  real* phih;           // (n, n, n) grid frame
  real* phiheat;        // (n, n, n) grid frame (kHeat)
  real* partial;        // (2, B, nblocks)
  int K, Kx, nsrc, n, max_shell, num_tau;
  real dr, rate_scale, lcol, rmax2, max_coldensh;
  // where not null, read at launch in place of dr, rate_scale, lcol, rmax2
  const double *dr_p, *rate_scale_p, *lcol_p, *rmax2_p;
  // table builds: table_lookup's scalars and the thick/thin switches
  real minlogtau, inv_dlogtau, photo_limit, heat_limit;
};

dim3 cell_grid(int n) {
  return dim3((n + kTileK - 1) / kTileK, (n + kTileJ - 1) / kTileJ, n);
}

__device__ __forceinline__ int wrap1(int x, int n) {
  return x < 0 ? x + n : (x >= n ? x - n : x);
}

// max(x, 0) and min(x, 80) that keep a NaN, as jnp/torch do
__device__ __forceinline__ real max0(real x) {
  return x < rl(0.) ? rl(0.) : x;
}
__device__ __forceinline__ real min80(real x) {
  return x > rl(80.) ? rl(80.) : x;
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

// One exponential mixture's sums for a live pair, term for term
// _photoion_expsum_impl's loop: phi_in, phi_cell, the heat weights' sum
// (kHeat) and the LLS tally's (kTally).
template <bool kTally, bool kHeat>
__device__ __forceinline__ void mixture(
    const real* s_a, const real* s_w, const real* s_hw, int K,
    real tau_in, real dtau, real tau_pre, real dtau_pre, real& phi_in,
    real& phi_cell, real& heat_acc, real& lls_acc) {
  phi_in = rl(0.);
  phi_cell = rl(0.);
  heat_acc = rl(0.);
  lls_acc = rl(0.);
#pragma unroll 8
  for (int t = 0; t < K; ++t) {
    const real a = s_a[t], w = s_w[t];
    const real att = r_exp(-min80(a * tau_in));
    const real absorb = att * -r_expm1(-min80(a * dtau));
    phi_in = phi_in + w * att;
    phi_cell = phi_cell + w * absorb;
    if (kHeat) heat_acc = heat_acc + s_hw[t] * absorb;
    if (kTally) {
      const real att_pre = r_exp(-min80(a * tau_pre));
      lls_acc = lls_acc + (w * att_pre) * -r_expm1(-min80(a * dtau_pre));
    }
  }
}

// A position in the rate tables (ops/tables.table_lookup): the two
// entries and the residual, computed once per optical depth and shared by
// every table read there.  Op for op the plain version on the card: torch
// casts each Python scalar to the tensor's type, and divides by a scalar
// as a multiply by its reciprocal (1.0 / b in double on the host, then
// cast to that type), so the kernel takes inv_dlogtau = (real)(1 /
// dlogtau).
struct TabPos {
  int i0, i1;
  real resid;
};

__device__ __forceinline__ TabPos tab_pos(const Consume& p, real tau) {
  const real logtau = r_log(r_max(tau, rl(1.0e-20))) * rl(kLog10E);
  real odpos = rl(1.0) + (logtau - p.minlogtau) * p.inv_dlogtau;
  odpos = r_min(r_max(odpos, rl(0.)), (real)p.num_tau);
  const real fl = r_floor(odpos);
  TabPos q;
  q.i0 = (int)fl;
  q.i1 = min(q.i0 + 1, p.num_tau);
  q.resid = odpos - fl;
  return q;
}

// t0 + (t1 - t0) * resid; the tables (2001 entries, 8 or 16 KB each) are
// read through the read-only cache, where a block's pairs find them
__device__ __forceinline__ real tab_read(const real* t, const TabPos& q) {
  const real t0 = __ldg(t + q.i0), t1 = __ldg(t + q.i1);
  return t0 + (t1 - t0) * q.resid;
}

// One source's table rates (photoion_rates' one_source): the cell's
// phi_cell / vol_ph, phi_out = phi_in - phi_cell and (kHeat) its heat /
// vol_ph, each from the thick difference or the thin rate as |dtau|
// passes its limit, in the plain version's order of operations.
template <bool kHeat>
__device__ __forceinline__ void table_source(
    const real* const* t, real nf, real dtau, const TabPos& q_in,
    const TabPos& q_out, const TabPos& q_thin, bool photo_thick,
    bool heat_thick, real vol_ph, real& photo_cell, real& phi_out,
    real& heat) {
  const real phi_in = nf * tab_read(t[0], q_in);
  const real phi_cell = photo_thick
      ? phi_in - nf * tab_read(t[0], q_out)
      : nf * dtau * tab_read(t[1], q_thin);
  phi_out = phi_in - phi_cell;
  photo_cell = phi_cell / vol_ph;
  if (kHeat) {
    if (heat_thick)
      heat = (nf * tab_read(t[2], q_in) - nf * tab_read(t[2], q_out)) /
             vol_ph;
    else
      heat = nf * dtau * tab_read(t[3], q_thin) / vol_ph;
  }
}

// The LLS tally of one source in table mode: the photo_cell of a second
// evaluation from the pre-LLS column to the post-LLS one
// (photoion_rates_lls_fused), its thick read at tau_in shared with the
// main evaluation's.
__device__ __forceinline__ real table_tally(
    const real* const* t, real nf, real dtau, const TabPos& q_pre,
    const TabPos& q_in, const TabPos& q_thin, bool photo_thick,
    real vol_ph) {
  const real phi_cell = photo_thick
      ? nf * tab_read(t[0], q_pre) - nf * tab_read(t[0], q_in)
      : nf * dtau * tab_read(t[1], q_thin);
  return phi_cell / vol_ph;
}

// kTable: table rates, else the mixture.  kLLS: 0 LLS off, 1 the scalar
// column p.lcol, 2 the grid p.lls.
template <bool kTable, int kLLS, bool kHeat, bool kXray>
__global__ void __launch_bounds__(kThreads) consume_cells(Consume p) {
  if (p.dr_p) p.dr = (real)*p.dr_p;
  if (p.rate_scale_p) p.rate_scale = (real)*p.rate_scale_p;
  if (p.lcol_p) p.lcol = (real)*p.lcol_p;
  if (p.rmax2_p) p.rmax2 = (real)*p.rmax2_p;
  constexpr bool kTally = kLLS != 0;
  extern __shared__ real smem[];
  const int nsrc = p.nsrc, K = p.K, Kx = kXray ? p.Kx : 0;
  real* red = smem;                             // [2][B][kTileJ]
  real* s_nf = red + 2 * nsrc * kTileJ;         // [B]
  real* s_a = s_nf + nsrc;                      // [K]
  real* s_w = s_a + K;                          // [K]
  real* s_hw = s_w + K;                         // [K] (kHeat)
  real* s_nfx = s_hw + (kHeat ? K : 0);         // [B] (kXray)
  real* s_xa = s_nfx + (kXray ? nsrc : 0);      // [Kx] (kXray)
  real* s_xw = s_xa + Kx;                       // [Kx]
  real* s_xhw = s_xw + Kx;                      // [Kx] (kHeat)
  int* s_pos = reinterpret_cast<int*>(s_xhw + (kHeat ? Kx : 0));  // [B][3]
  const int tid = threadIdx.y * kTileK + threadIdx.x;
  for (int q = tid; q < 3 * nsrc; q += kThreads) s_pos[q] = p.srcpos[q];
  for (int q = tid; q < nsrc; q += kThreads) {
    s_nf[q] = p.nflux[q];
    if (kXray) s_nfx[q] = p.nfx[q];
  }
  for (int q = tid; q < K; q += kThreads) {
    s_a[q] = p.tab[0][q];
    s_w[q] = p.tab[1][q];
    if (kHeat) s_hw[q] = p.tab[2][q];
  }
  for (int q = tid; q < Kx; q += kThreads) {
    s_xa[q] = p.tab[3][q];
    s_xw[q] = p.tab[4][q];
    if (kHeat) s_xhw[q] = p.tab[5][q];
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
    const int cheb = max(max(abs(oi), abs(oj)), abs(ok));
    const real cd = valid
        ? __ldg(p.cdo + src * n3 + ((size_t)(oi + c) * n + (oj + c)) * n +
                (ok + c))
        : rl(0.);
    const real fi = (real)oi, fj = (real)oj, fk = (real)ok;
    const real dist2 = fi * fi + fj * fj + fk * fk;
    // dead for sure: no geometry needed (the R_max barrier is exact here)
    bool live = valid && cheb <= p.max_shell && !(dist2 > p.rmax2) &&
                !(can_stop && cd - col_hi > p.max_coldensh);
    // geometry, exactly _rate_pass
    const bool is_src = cheb == 0;
    const real dom = (real)cheb;
    real path = rl(0.5), cin = rl(0.);
    if (live) {
      const real safe_d = r_max(dom, rl(1.));
      const real t2 = dist2 - dom * dom;
      if (!is_src) path = r_sqrt(t2 / (safe_d * safe_d) + rl(1.));
      const real colcell = nd * (path * p.dr);
      cin = max0(cd - colcell);
      live = !(cin > p.max_coldensh);
    }

    real loss = rl(0.), lls = rl(0.);
    if (live) {
      real vol_ph = kFourPi * dist2 * path;
      if (is_src) vol_ph = rl(1.);
      real photo_cell, phi_out, heat = rl(0.), llsc = rl(0.);
      if (kTable) {
        const real tau_in = cin * kSigma, tau_out = cd * kSigma;
        const real dtau = tau_out - tau_in;
        const TabPos q_in = tab_pos(p, tau_in), q_out = tab_pos(p, tau_out);
        const TabPos q_thin =
            kThinMid ? tab_pos(p, rl(0.5) * (tau_in + tau_out)) : q_in;
        const bool thick = r_abs(dtau) > p.photo_limit;
        const bool hthick = r_abs(dtau) > p.heat_limit;
        table_source<kHeat>(p.tab, s_nf[src], dtau, q_in, q_out, q_thin,
                            thick, hthick, vol_ph, photo_cell, phi_out,
                            heat);
        if (kXray) {
          real xphoto_cell, xphi_out, xheat = rl(0.);
          table_source<kHeat>(p.tab + 4, s_nfx[src], dtau, q_in, q_out,
                              q_thin, thick, hthick, vol_ph, xphoto_cell,
                              xphi_out, xheat);
          photo_cell = photo_cell + xphoto_cell;
          phi_out = phi_out + xphi_out;
          if (kHeat) heat = heat + xheat;
        }
        if (kTally) {
          const real cold_pre = max0(cin - lcol * path);
          const real tau_pre = cold_pre * kSigma;
          const real dtau_t = tau_in - tau_pre;
          const TabPos q_pre = tab_pos(p, tau_pre);
          const TabPos q_tt =
              kThinMid ? tab_pos(p, rl(0.5) * (tau_pre + tau_in)) : q_pre;
          const bool tthick = r_abs(dtau_t) > p.photo_limit;
          llsc = table_tally(p.tab, s_nf[src], dtau_t, q_pre, q_in, q_tt,
                             tthick, vol_ph);
          if (kXray)
            llsc = llsc + table_tally(p.tab + 4, s_nfx[src], dtau_t, q_pre,
                                      q_in, q_tt, tthick, vol_ph);
        }
      } else {
        const real tau_in = cin * kSigma;
        const real dtau = (cd - cin) * kSigma;
        real tau_pre = rl(0.), dtau_pre = rl(0.);
        if (kTally) {
          const real cold_pre = max0(cin - lcol * path);
          tau_pre = cold_pre * kSigma;
          dtau_pre = (cin - cold_pre) * kSigma;
        }
        real phi_in, phi_cell, heat_acc, lls_acc;
        mixture<kTally, kHeat>(s_a, s_w, s_hw, K, tau_in, dtau, tau_pre,
                               dtau_pre, phi_in, phi_cell, heat_acc,
                               lls_acc);
        const real nf = s_nf[src];
        phi_in = nf * phi_in;
        phi_cell = nf * phi_cell;
        phi_out = phi_in - phi_cell;
        photo_cell = phi_cell / vol_ph;
        if (kHeat) heat = (nf * heat_acc) / vol_ph;
        if (kTally) llsc = nf * lls_acc / vol_ph;
        if (kXray) {
          real xphi_in, xphi_cell, xheat_acc, xlls_acc;
          mixture<kTally, kHeat>(s_xa, s_xw, s_xhw, Kx, tau_in, dtau,
                                 tau_pre, dtau_pre, xphi_in, xphi_cell,
                                 xheat_acc, xlls_acc);
          const real nfx = s_nfx[src];
          xphi_in = nfx * xphi_in;
          xphi_cell = nfx * xphi_cell;
          phi_out = phi_out + (xphi_in - xphi_cell);
          photo_cell = photo_cell + xphi_cell / vol_ph;
          if (kHeat) heat = heat + (nfx * xheat_acc) / vol_ph;
          if (kTally) llsc = llsc + nfx * xlls_acc / vol_ph;
        }
      }
      acc = acc + photo_cell * p.rate_scale / nd;
      if (kHeat) hacc = hacc + heat * p.rate_scale;
      const bool bnd = oi == p_lim || oi == -q_lim || oj == p_lim ||
                       oj == -q_lim || ok == p_lim || ok == -q_lim;
      if (bnd) loss = phi_out / vol_ph;
      if (kTally) lls = llsc;
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
  Consume p;
  p.cdo = cdo;
  p.ndhi = ndhi;
  p.lls = lls;
  p.srcpos = srcpos;
  p.nflux = nflux;
  p.nfx = nfx;
  for (int t = 0; t < 8; ++t) p.tab[t] = (const real*)tables[t];
  p.phih = phih;
  p.phiheat = phiheat;
  p.partial = partial;
  p.K = kTableBuild ? 0 : K;
  p.Kx = kTableBuild ? 0 : Kx;
  p.nsrc = nsrc;
  p.n = n;
  p.max_shell = max_shell;
  p.num_tau = num_tau;
  p.dr = (real)dr;
  p.rate_scale = (real)rate_scale;
  p.lcol = (real)lcol;
  p.rmax2 = (real)rmax2;
  p.dr_p = step[0];
  p.rate_scale_p = step[1];
  p.lcol_p = step[2];
  p.rmax2_p = step[3];
  p.max_coldensh = (real)max_coldensh;
  p.minlogtau = (real)minlogtau;
  p.inv_dlogtau = (real)(1.0 / dlogtau);
  p.photo_limit = (real)photo_limit;
  p.heat_limit = (real)heat_limit;
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

const char* c2r_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
