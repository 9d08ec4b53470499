// The rate pass's device code, shared by the kernels that evaluate it:
// K2 and its window mode K2w (consume.cu) and the fused window sweep
// (window_sweep.cu).  One definition of each function, so every kernel
// that includes it computes a (cell, source) pair with the same operations
// in the same order, and they are bitwise equal to one another and to the
// plain PyTorch version (ops/sweep._rate_pass; built with --fmad=false).
//
//  * Consume: a launch's arrays and scalars (make_params fills it from a C
//    entry's arguments; read_step_scalars takes the per-step scalars from
//    the card where the caller gave pointers);
//  * stage_terms / terms_elems: the mixture terms a block stages in shared
//    memory;
//  * pair_geometry: a pair's Chebyshev distance, path, incoming column
//    and stop tests; pair_rates: what a live pair deposits (the mixture or
//    table rates, heat, boundary loss and LLS tally), with mixture,
//    tab_pos, tab_read, table_source and table_tally beneath it.
// See consume.cu for what bounds these and why they are written so.

#pragma once

#include <stddef.h>

#include "real.cuh"

namespace {

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
  real* loss;           // window mode: (2, B) tallies, then their 2 sums
  int K, Kx, nsrc, n, max_shell, num_tau;
  real dr, rate_scale, lcol, rmax2, max_coldensh;
  // where not null, read at launch in place of dr, rate_scale, lcol, rmax2
  const double *dr_p, *rate_scale_p, *lcol_p, *rmax2_p;
  // table builds: table_lookup's scalars and the thick/thin switches
  real minlogtau, inv_dlogtau, photo_limit, heat_limit;
};

// max(x, 0) and min(x, 80) that keep a NaN, as jnp/torch do
__device__ __forceinline__ real max0(real x) {
  return x < rl(0.) ? rl(0.) : x;
}
__device__ __forceinline__ real min80(real x) {
  return x > rl(80.) ? rl(80.) : x;
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

// The mixture terms staged in a block's shared memory (K = Kx = 0 in a
// table build): a_k, w_k and the heat weights hw_k (kHeat), then the X-ray
// mixture's (kXray).
struct Terms {
  const real *a, *w, *hw, *xa, *xw, *xhw;
  int K, Kx;
};

// Stage the terms after `base` in shared memory -> the terms and the
// first element past them.
template <bool kHeat, bool kXray>
__device__ __forceinline__ Terms stage_terms(const Consume& p, real* base,
                                             int tid, int nthreads) {
  const int K = p.K, Kx = kXray ? p.Kx : 0;
  real* s_a = base;
  real* s_w = s_a + K;
  real* s_hw = s_w + K;                         // (kHeat)
  real* s_xa = s_hw + (kHeat ? K : 0);          // (kXray)
  real* s_xw = s_xa + Kx;
  real* s_xhw = s_xw + Kx;                      // (kHeat)
  for (int q = tid; q < K; q += nthreads) {
    s_a[q] = p.tab[0][q];
    s_w[q] = p.tab[1][q];
    if (kHeat) s_hw[q] = p.tab[2][q];
  }
  for (int q = tid; q < Kx; q += nthreads) {
    s_xa[q] = p.tab[3][q];
    s_xw[q] = p.tab[4][q];
    if (kHeat) s_xhw[q] = p.tab[5][q];
  }
  return Terms{s_a, s_w, s_hw, s_xa, s_xw, s_xhw, K, Kx};
}

// Elements of the staged terms.
__host__ __device__ __forceinline__ int terms_elems(int K, int Kx, bool heat,
                                                    bool xray) {
  return (heat ? 3 : 2) * (K + (xray ? Kx : 0));
}

// A (cell, source) pair at integer offsets (oi, oj, ok) from its source,
// whose column out is cd: the geometry and the stop tests of _rate_pass.
// The dead-for-sure test comes first (no geometry needed; the R_max barrier
// is exact there), then a live pair's path and incoming column.  -> live.
__device__ __forceinline__ bool pair_geometry(
    const Consume& p, int oi, int oj, int ok, bool valid, real cd, real nd,
    real col_hi, bool can_stop, int& cheb, real& dist2, real& path,
    real& cin) {
  cheb = max(max(abs(oi), abs(oj)), abs(ok));
  const real fi = (real)oi, fj = (real)oj, fk = (real)ok;
  dist2 = fi * fi + fj * fj + fk * fk;
  bool live = valid && cheb <= p.max_shell && !(dist2 > p.rmax2) &&
              !(can_stop && cd - col_hi > p.max_coldensh);
  const real dom = (real)cheb;
  path = rl(0.5);
  cin = rl(0.);
  if (live) {
    const real safe_d = r_max(dom, rl(1.));
    const real t2 = dist2 - dom * dom;
    if (cheb != 0) path = r_sqrt(t2 / (safe_d * safe_d) + rl(1.));
    const real colcell = nd * (path * p.dr);
    cin = max0(cd - colcell);
    live = !(cin > p.max_coldensh);
  }
  return live;
}

// What a live pair deposits: its per-atom rate photo_cell * rate_scale /
// nd, its heat (kHeat) heat * rate_scale, its boundary loss phi_out /
// vol_ph (on the trace boundary, else 0) and its LLS tally (kLLS != 0).
struct PairOut {
  real rate, heat, loss, lls;
};

// kTable: table rates, else the mixture.  kLLS: 0 LLS off, 1 the scalar
// column p.lcol, 2 a grid column (lcol, the cell's).
template <bool kTable, int kLLS, bool kHeat, bool kXray>
__device__ __forceinline__ PairOut pair_rates(
    const Consume& p, const Terms& m, real nf, real nfx, real cd, real cin,
    real path, real dist2, bool is_src, real nd, real lcol, bool bnd) {
  constexpr bool kTally = kLLS != 0;
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
    table_source<kHeat>(p.tab, nf, dtau, q_in, q_out, q_thin, thick, hthick,
                        vol_ph, photo_cell, phi_out, heat);
    if (kXray) {
      real xphoto_cell, xphi_out, xheat = rl(0.);
      table_source<kHeat>(p.tab + 4, nfx, dtau, q_in, q_out, q_thin, thick,
                          hthick, vol_ph, xphoto_cell, xphi_out, xheat);
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
      llsc = table_tally(p.tab, nf, dtau_t, q_pre, q_in, q_tt, tthick,
                         vol_ph);
      if (kXray)
        llsc = llsc + table_tally(p.tab + 4, nfx, dtau_t, q_pre, q_in, q_tt,
                                  tthick, vol_ph);
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
    mixture<kTally, kHeat>(m.a, m.w, m.hw, m.K, tau_in, dtau, tau_pre,
                           dtau_pre, phi_in, phi_cell, heat_acc, lls_acc);
    phi_in = nf * phi_in;
    phi_cell = nf * phi_cell;
    phi_out = phi_in - phi_cell;
    photo_cell = phi_cell / vol_ph;
    if (kHeat) heat = (nf * heat_acc) / vol_ph;
    if (kTally) llsc = nf * lls_acc / vol_ph;
    if (kXray) {
      real xphi_in, xphi_cell, xheat_acc, xlls_acc;
      mixture<kTally, kHeat>(m.xa, m.xw, m.xhw, m.Kx, tau_in, dtau, tau_pre,
                             dtau_pre, xphi_in, xphi_cell, xheat_acc,
                             xlls_acc);
      xphi_in = nfx * xphi_in;
      xphi_cell = nfx * xphi_cell;
      phi_out = phi_out + (xphi_in - xphi_cell);
      photo_cell = photo_cell + xphi_cell / vol_ph;
      if (kHeat) heat = heat + (nfx * xheat_acc) / vol_ph;
      if (kTally) llsc = llsc + nfx * xlls_acc / vol_ph;
    }
  }
  PairOut o;
  o.rate = photo_cell * p.rate_scale / nd;
  o.heat = kHeat ? heat * p.rate_scale : rl(0.);
  o.loss = bnd ? phi_out / vol_ph : rl(0.);
  o.lls = kTally ? llsc : rl(0.);
  return o;
}

__device__ __forceinline__ void read_step_scalars(Consume& p) {
  if (p.dr_p) p.dr = (real)*p.dr_p;
  if (p.rate_scale_p) p.rate_scale = (real)*p.rate_scale_p;
  if (p.lcol_p) p.lcol = (real)*p.lcol_p;
  if (p.rmax2_p) p.rmax2 = (real)*p.rmax2_p;
}

// The launch parameters common to both modes (the C entries' arguments).
Consume make_params(const real* cdo, const real* ndhi, const real* lls,
                    const real* nflux, const real* nfx,
                    const void* const* tables, int K, int Kx, int num_tau,
                    int nsrc, int n, int max_shell, double dr,
                    double rate_scale, double lcol, double rmax2,
                    const double* const* step, double max_coldensh,
                    double minlogtau, double dlogtau, double photo_limit,
                    double heat_limit, real* phih, real* phiheat,
                    real* partial, real* loss) {
  Consume p;
  p.cdo = cdo;
  p.ndhi = ndhi;
  p.lls = lls;
  p.srcpos = nullptr;
  p.nflux = nflux;
  p.nfx = nfx;
  for (int t = 0; t < 8; ++t) p.tab[t] = (const real*)tables[t];
  p.phih = phih;
  p.phiheat = phiheat;
  p.partial = partial;
  p.loss = loss;
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
  return p;
}

}  // namespace
