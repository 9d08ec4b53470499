// The grid-wide chemistry pass, hand-written for Hopper (sm_90a): one
// persistent launch per call, a thread per cell at a time.
//
// Replaces: what XLA fuses out of c2ray_tpu/ops/chemistry.py::
// global_chemistry (a masked lax.while_loop of doric passes over the
// grid) and, in the non-isothermal build, c2ray_tpu/ops/thermal.py::
// _thermal_core (the masked subcycle loops of every pass).  No Pallas
// kernel: on the TPU both loops live inside the one XLA program, and
// the PyTorch plain version (ops/chemistry.global_chemistry_reference)
// runs them as host-driven loops that test the grid's running cells
// from the host.  Here every cell runs its own loops in registers:
//
//  * passes restart doric from the step-initial state (ops/doric.py);
//    a cell stops after the pass in which |dxh0_av / xh0_av| <
//    minimum_fractional_change or xh0_av < minimum_fraction_of_atoms,
//    or at max_iter passes.  Cells are independent, so this is the
//    masked loop's result bit for bit: the masked loop only freezes a
//    stopped cell, and runs a pass while any cell runs;
//  * the heat build (kHeat) also integrates the cell's temperature in
//    every pass from the step-initial temperature under phiheat, in
//    its own adaptive substeps (ops/thermal.py::_make_substep and
//    coolin), at most max_sub of them, and the next pass's
//    recombination rates follow the new time-averaged temperature;
//  * then the outer count's ion_cond (evolve_point.F90:384-391).
//
// Every operation follows the plain version's torch ops in their order,
// with torch's CUDA semantics: a division of a tensor by a Python float
// is a multiply by the reciprocal, 1.0 / b taken in double on the host
// and cast to the build's type (for the cooling table's step 8/60 the
// two roundings differ: 7.5f, not 1.0f / 0.13333334f), a Python
// scalar divided by a tensor is reciprocal(t) * s, each constant is
// cast to the build's type, clamp and minimum keep a NaN, and every
// math function is its libdevice routine (real.cuh).  Every product of
// this source's own floating-point values is r_mul (real.cuh), which
// never fuses with an add (tests/test_torch_chemistry_schedule.py fails
// on a bare one), and _build.py builds it with --fmad=true, so the
// libdevice routines are compiled as in PyTorch's elementwise kernels
// (under --fmad=false the float64 pow differs from PyTorch's in the last
// place on some arguments: phase 12's state at 2 K shows it).  The
// isothermal build reads the recombination rates the wrapper computes
// once with the plain version's own torch ops (0-d, or a grid under a
// clumping grid).  The per-cell arithmetic is one device function
// (run_cell, over doric_pass, thermal_* and cell_output) that both forms
// below compile.
//
// The photon audit (where the caller asks for it): what the solver's tail
// computes with two calls of ops/photonstats.py::grid_counts (the JAX
// twin's c2ray_tpu/ops/photonstats.py::grid_counts, called twice in
// c2ray_tpu/solver.py's _tail; XLA fuses it there), folded into the
// output of each cell, which holds every input of those sums in
// registers: h0 and h1 of the stored iterate, rec_rate and coll_rate of
// the stored average under the output temperature (heat) or the initial
// temperature, with a scalar or per-cell clumping, decoded from
// compressed storage as grid_counts decodes it.  Each cell's four terms
// follow grid_counts' ops; they are summed in double in a fixed order
// (below), so the sums are the same from run to run and differ from
// torch.sum's only by the order of the sum.  The audit is an instance
// (kAudit), so calls without it carry none of its registers.
//
// What bounds it on the H100: the compulsory bytes, one read of each
// input grid and one write of each output.  Isothermal float32 at
// 256^3: ndens, xh1_old, xh1_av, phih read and two grids written (and
// xh1_intermed, counted once), 7 x 67.1 MB = 470 MB, 0.140 ms at 3.35
// TB/s; the heat build reads phiheat and two temperatures and writes two
// more, 805 MB, 0.240 ms.  The arithmetic depends on the data: a doric
// pass takes one exp and one expm1 per cell (the heat build adds pow,
// sqrt, exp and a division for the rates, and per substep one log and
// three divisions), so chip_smoke.py counts the passes and substeps this
// run's data needs from the kernel's counters: in float32 over the SFU's
// rate; in float64 each libdevice routine is a sequence of FP64
// instructions, which chip_smoke.py counts from this build's SASS
// (cuobjdump -sass of the one-routine kernels c2r_chemistry_probe_*
// below: the FP64 instructions on each routine's fast path, normal
// arguments and no special case), over 64 FP64 instructions a clock on
// each SM.  Counted in this build's SASS (CUDA 12.8, sm_90a): exp 15,
// expm1 19, log 28, pow 86, sqrt 8 and a division 8 (their static totals
// 18, 21, 30, 96, 22 and 24; sqrt and the division add one MUFU each).
//
// Design (the previous form, a block of 256 threads per 256 cells and a
// two-launch reduce, stays as the timing build -DC2R_CHEM_CELL_PER_THREAD):
//
//  * persistent blocks of 256 threads: as many as the card holds at once
//    (its SMs times cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked
//    once per device and instance), at most one per 256 cells;
//  * thread t of the T in the grid takes cells t, t + T, ..., each run to
//    its end before the next (the per-cell loads and stores coalesce
//    across a warp); no block pays a per-256-cell epilogue;
//  * one launch: counters (integers, exact) and audit terms (double)
//    accumulate per thread over its cells, in cell order; the block
//    reduces them once (warps in order), and the last block to finish (a
//    device counter it resets) sums the blocks' partials in block order
//    and writes the five counters and the four audit sums (the grid, so
//    each thread's cells and the audit's order, is fixed per device and
//    build: the sums repeat from call to call).  No allocation, no host
//    sync: the launch replays in the device loop's
//    CUDA graph with dt and the cooling coefficient read at launch.
//
// Not kept, from timing on the card (PERF.md): a persistent form whose
// warps streamed tiles of cells through shared memory with bulk copies and
// refilled a lane with the tile's next cell as soon as its own was done.
// On the states the chip runs make (about one substep a cell and pass,
// 1-2 passes a cell; 4.4 in the cold IGM, every cell alike) it was slower
// than this form everywhere but float64 heat on phase 12's state, and held
// 55-108 registers.  A state where a few cells take tens of substeps while
// their warp's others take one is what it was for.

#include <cuda_runtime.h>

#include <mutex>

#include "real.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTempPoints = 61;     // the cooling table (cooling.f90:26)

// the C entry's scalars, in ops/chemistry_cuda.py's order; the last four
// are the audit's isothermal rates as photonstats.grid_counts takes them,
// Python floats there (chemistry_cuda.audit_scalars): the recombination
// rate of a scalar clumping, (T / 1e4)^ALBPOW for a clumping tensor, T and
// -TEMPH0 / T
enum Scalar {
  kDt, kEps, kMfc, kMinAtoms, kLossScalar, kClumpBh, kBh00, kAlbpow,
  kColh0, kTemph0, kAbuC, kKb, kGamma1, kLog10e, kTabMin, kTabStep,
  kMinitemp, kRelDenergy, kCoeff, kAuditBrech, kAuditPow, kAuditTemp,
  kAuditNegT, kNumScalars
};

// the audit's sums (photonstats.GridCounts): h0 and h1 of the iterate
// xh1_intermed, rec_rate and coll_rate of the average xh1_av
enum Audit { kH0, kH1, kRec, kColl, kNumAudit };

// counters: conv_flag, most passes of a cell, passes, substeps, most
// substeps of a cell in one pass
enum Counter { kConv, kMaxPasses, kPasses, kSubsteps, kMaxSubsteps,
               kNumCounters };

__device__ __forceinline__ bool is_max(int c) {
  return c == kMaxPasses || c == kMaxSubsteps;
}

struct Chem {
  const real* ndens;
  const real* xh1_old;
  const real* xh_int;
  const real* xh_av;
  const real* phih;
  const real* loss;     // photon_loss_rate, or null: loss_scalar
  const real* brech;    // isothermal rates (brech: stride 0 or 1)
  const real* acol;
  const real* clump;    // clumping (stride 0 or 1), or null: clump_bh
  const real* phiheat;
  const real* t_cur;
  const real* t_av;
  const real* cie;
  real* out_int;
  real* out_av;
  real* out_tint;
  real* out_tav;
  unsigned long long* counters;
  unsigned long long* partial;   // kNumCounters x blocks
  double* apartial;     // kNumAudit x blocks, or null: no audit
  real* audit;          // kNumAudit sums out
  long long ncell;
  int loss_stride, brech_stride, clump_stride;
  int max_iter, max_sub;
  real dt, eps, one_minus_eps, mfc, min_atoms, loss_scalar, clump_bh;
  real bh00, albpow, inv_1e4, colh0, neg_temph0, abu_c, k_b, gamma1,
      inv_gamma1, log10e, tab_min, inv_tab_step, minitemp, rel_denergy,
      coeff, rate_floor, audit_brech, audit_pow, audit_temp, audit_neg_t;
  // where not null, read at launch in place of dt and coeff
  const double *dt_p, *coeff_p;
};

// torch.clamp(x, min=lo) on CUDA: a NaN stays NaN
__device__ __forceinline__ real clamp_min(real x, real lo) {
  return x != x ? x : r_max(x, lo);
}

// torch.minimum: a NaN in either wins
__device__ __forceinline__ real t_minimum(real a, real b) {
  if (a != a) return a;
  if (b != b) return b;
  return r_min(a, b);
}

// state.xh1_of / xh0_of / compress_xh
__device__ __forceinline__ real xh1_of(real xc) {
  return xc >= rl(0.0) ? xc : rl(1.0) + xc;
}
__device__ __forceinline__ real xh0_of(real xc) {
  return xc >= rl(0.0) ? rl(1.0) - xc : -xc;
}
__device__ __forceinline__ real compress(real x1, real x0) {
  return x1 <= rl(0.5) ? x1 : (x0 > rl(0.0) ? -x0 : rl(1.0));
}

// recombination_rates at the temperature t (doric.f90:74-79), the heat
// build's form: clump_bh * ((t / 1e4) ^ ALBPOW) and COLH0 sqrt(t) exp(-TEMPH0
// / t), as torch on the card evaluates them
__device__ __forceinline__ void rates_at(const Chem& p, real t, real clump_bh,
                                         real& brech, real& acol) {
  brech = r_mul(clump_bh, r_pow(r_mul(t, p.inv_1e4), p.albpow));
  acol = r_mul(r_mul(p.colh0, r_sqrt(t)),
               r_exp(r_mul(rl(1.0) / t, p.neg_temph0)));
}

// The warp's sums of the four audit terms in six double shuffles, not 20:
// the first two exchanges each hand half of a lane's values to its
// partner, the last three sum one value over the rest.  Lane l ends with
// the sum of term audit_of_lane(l); a fixed order, so the same bits from
// run to run.
__device__ __forceinline__ double warp_sum4_d(const double* a, int lane) {
  const unsigned full = 0xffffffffu;
  const bool h1 = lane & 16, h0 = lane & 8;
  double s0 = h1 ? a[2] : a[0], s1 = h1 ? a[3] : a[1];
  s0 += __shfl_xor_sync(full, h1 ? a[0] : a[2], 16);
  s1 += __shfl_xor_sync(full, h1 ? a[1] : a[3], 16);
  double u = h0 ? s1 : s0;
  u += __shfl_xor_sync(full, h0 ? s0 : s1, 8);
  for (int o = 4; o > 0; o >>= 1) u += __shfl_xor_sync(full, u, o);
  return u;
}

__device__ __forceinline__ int audit_of_lane(int lane) {
  return ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1);
}

// --- the per-cell arithmetic, shared by both forms -------------------------

// One doric pass of a cell (doric.f90:96-124) from its current average
// (hav1, hav0) and, with heat, its average temperature t_av (the rates
// follow it; isothermally brech and acol are given): the pass's iterate
// and average replace (h1, h0) and (hav1, hav0); -> whether the cell
// converged in this pass.
template <bool kHeat, bool kCompressed>
__device__ __forceinline__ bool doric_pass(
    const Chem& p, real dt, real nd, real ph, real h1_old, real h0_old,
    real t_av, real clump_bh, real& brech, real& acol, real& h1, real& h0,
    real& hav1, real& hav0) {
  const real eps = p.eps;
  const real prev = kCompressed ? hav0 : clamp_min(rl(1.0) - hav1, eps);
  const real rhe = r_mul(nd, hav1 + p.abu_c);
  // recombination_rates at the cell's average temperature
  if (kHeat) rates_at(p, t_av, clump_bh, brech, acol);
  const real aih0 = ph + r_mul(rhe, acol);
  const real delth = aih0 + r_mul(rhe, brech);
  const real eq1 = aih0 / delth;
  const real eq0 = r_mul(rhe, brech) / delth;
  const real deltht = r_mul(delth, dt);
  const real ee = r_exp(-deltht);
  const real x0old = kCompressed ? h0_old : rl(1.0) - h1_old;
  real x1 = r_mul(h1_old - eq1, ee) + eq1;
  real x0 = r_mul(x0old - eq0, ee) + eq0;
  if (x0 < eps) {
    x0 = eps;
    x1 = p.one_minus_eps;
  }
  const real af =
      deltht < rl(1.0e-8) ? rl(1.0) : (-r_expm1(-deltht)) / deltht;
  const real x1av = eq1 + r_mul(h1_old - eq1, af);
  const real x0av = kCompressed ? clamp_min(eq0 + r_mul(x0old - eq0, af), eps)
                                : clamp_min(rl(1.0) - x1av, eps);
  const bool conv =
      (r_abs((x0av - prev) / x0av) < p.mfc) || (x0av < p.min_atoms);
  h1 = x1;
  hav1 = x1av;
  if (kCompressed) {
    h0 = x0;
    hav0 = x0av;
  }
  return conv;
}

// ops/thermal.py::thermal for one cell, in three parts.  The step-initial
// internal energy (temper2pressr / GAMMA1, the latter a multiply by its
// reciprocal): the same in every pass.
__device__ __forceinline__ real thermal_e0(const Chem& p, real t0, real nd,
                                           real h1_old) {
  const real ne_old = r_mul(nd, h1_old + p.abu_c);
  return r_mul(r_mul(r_mul(nd + ne_old, p.k_b), t0), p.inv_gamma1);
}

// a pass's constants of _make_substep's closure, from the pass's average
// ionized fraction
struct ThermalPass {
  real e_floor, ndne, pden;
};

__device__ __forceinline__ ThermalPass thermal_pass(const Chem& p, real nd,
                                                    real x1_av) {
  const real ne_av = r_mul(nd, x1_av + p.abu_c);
  ThermalPass th;
  th.e_floor = r_mul(r_mul(nd + ne_av, p.k_b), p.minitemp);
  th.ndne = r_mul(nd, ne_av);
  th.pden = r_mul(p.k_b, nd + ne_av);
  return th;
}

// one substep (thermal.f90:98-159) of (e, t, avg, cum); -> done
__device__ __forceinline__ bool thermal_substep(
    const Chem& p, real dt, real tol, real heat, real cosmo_rate,
    const ThermalPass& th, real& e, real& t, real& avg, real& cum) {
  // coolin: log10 as the natural log times log10(e), linear table
  // interpolation
  const real tpos =
      r_mul(r_mul(r_log(t), p.log10e) - p.tab_min, p.inv_tab_step) + rl(1.0);
  int it = (int)r_floor(tpos);
  it = it < 1 ? 1 : (it > kTempPoints - 1 ? kTempPoints - 1 : it);
  const real dtpos = tpos - (real)it;
  const int it1 = it + 1 > kTempPoints ? kTempPoints : it + 1;
  const real c0 = p.cie[it - 1];
  const real c1 = p.cie[it1 - 1];
  const real cooling =
      r_mul(th.ndne, c0 + r_mul(c1 - c0, dtpos)) + cosmo_rate;
  const real rate = clamp_min(r_abs(cooling - heat), p.rate_floor);
  const real dt_thermal = r_mul(p.rel_denergy, e) / rate;
  const real dt_ode = t_minimum(dt_thermal, dt - cum);
  real e_new = e + r_mul(dt_ode, heat - cooling);
  real avg_new = avg + r_mul(r_mul(rl(0.5), t), dt_ode);
  real t_new = r_mul(e_new, p.gamma1) / th.pden;
  avg_new = avg_new + r_mul(r_mul(rl(0.5), t_new), dt_ode);
  // the temperature floor (thermal.f90:142-148)
  if (t_new < p.minitemp) {
    e_new = th.e_floor;
    t_new = p.minitemp;
  }
  const real cum_new = cum + dt_ode;
  e = e_new;
  t = t_new;
  avg = avg_new;
  cum = cum_new;
  return (cum_new >= dt) || (r_abs(cum_new - dt) < tol);
}

// the pass's final and average temperature, from its last (e, avg) and
// the pass's iterate x1_end; a cell at or below minitemp keeps t0
__device__ __forceinline__ void thermal_end(const Chem& p, real dt, real t0,
                                            bool active0, real nd,
                                            real x1_end, real e, real avg,
                                            real& final_t, real& avg_t) {
  const real ne_end = r_mul(nd, x1_end + p.abu_c);
  const real ft = r_mul(e, p.gamma1) / r_mul(p.k_b, nd + ne_end);
  const real at = dt > rl(0.0) ? avg / dt : t0;
  final_t = active0 ? ft : t0;
  avg_t = active0 ? at : t0;
}

// A finished cell: its outer non-convergence count (evolve_point.F90:
// 384-391), its two stored fractions and, where asked, the audit's four
// terms of grid_counts on the stored outputs, op for op: x1 and x0
// decoded from each (or x0 = 1 - x1), the rates at the output
// temperature t_av (heat) or at the scalar initial temperature (the
// isothermal acol_a, and brech_a unless clumping is a tensor, are the
// same in every cell).
template <bool kHeat, bool kCompressed, bool kAudit>
__device__ __forceinline__ void cell_output(
    const Chem& p, real nd, real old0, real h1, real h0, real hav1,
    real hav0, real t_av_in, real t_av, real clump_bh, real acol_a,
    bool& ion, real& o_int, real& o_av, double* audit) {
  const real end0 = kCompressed ? hav0 : clamp_min(rl(1.0) - hav1, p.eps);
  bool cond = (r_abs(end0 - old0) > p.mfc) &&
              (r_abs((end0 - old0) / end0) > p.mfc) && (end0 > p.min_atoms);
  if (kHeat) {
    cond = cond || ((r_abs((t_av_in - t_av) / t_av) > rl(1.0e-1)) &&
                    (r_abs(t_av_in - t_av) > rl(100.0)));
  }
  ion = cond;
  o_int = kCompressed ? compress(h1, h0) : h1;
  o_av = kCompressed ? compress(hav1, hav0) : hav1;
  if (kAudit) {
    const real x1i = kCompressed ? xh1_of(o_int) : o_int;
    const real x0i = kCompressed ? xh0_of(o_int) : rl(1.0) - o_int;
    const real x1a = kCompressed ? xh1_of(o_av) : o_av;
    const real x0a = kCompressed ? xh0_of(o_av) : rl(1.0) - o_av;
    real brech_a, acol_b;
    if (kHeat) {
      rates_at(p, t_av, clump_bh, brech_a, acol_b);
    } else {
      brech_a = p.clump ? r_mul(clump_bh, p.audit_pow) : p.audit_brech;
      acol_b = acol_a;
    }
    const real ne = r_mul(nd, x1a + p.abu_c);
    audit[kH0] = (double)r_mul(nd, x0i);
    audit[kH1] = (double)r_mul(nd, x1i);
    audit[kRec] = (double)r_mul(r_mul(r_mul(nd, x1a), ne), brech_a);
    audit[kColl] = (double)r_mul(r_mul(r_mul(nd, x0a), ne), acol_b);
  }
}

__device__ __forceinline__ real read_dt(const Chem& p) {
  return p.dt_p ? (real)*p.dt_p : p.dt;
}
__device__ __forceinline__ real read_coeff(const Chem& p) {
  return p.coeff_p ? (real)*p.coeff_p : p.coeff;
}

__device__ __forceinline__ unsigned long long warp_sum_u64(
    unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(0xffffffffu, v, o);
    v = x > v ? x : v;
  }
  return v;
}
__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A finished cell's counts: whether it counts in conv_flag, its passes, its
// substeps over them and its most substeps in one pass
struct CellCount {
  bool ion;
  unsigned passes, subs, max_subs;
};

// The whole of cell i: its inputs read, its passes (and, with heat, their
// substeps) run, its outputs stored; its counts in c and, with kAudit, its
// four audit terms in audit.  acol_a: the isothermal audit's collisional
// rate (the same in every cell).
template <bool kHeat, bool kCompressed, bool kAudit>
__device__ __forceinline__ void run_cell(const Chem& p, long long i, real dt,
                                         real coeff, real acol_a,
                                         CellCount& c, double* audit) {
  const real eps = p.eps;
  const real nd = p.ndens[i];
  const real ph =
      p.phih[i] + (p.loss ? p.loss[i * p.loss_stride] : p.loss_scalar);
  real h1_old, h0_old = rl(0.0), hav1, hav0 = rl(0.0), h1 = rl(0.0),
               h0 = rl(0.0), old0;
  const real xa = p.xh_av[i];
  if (kCompressed) {
    const real xo = p.xh1_old[i];
    h1_old = clamp_min(xh1_of(xo), eps);
    h0_old = clamp_min(xh0_of(xo), eps);
    hav1 = clamp_min(xh1_of(xa), eps);
    hav0 = clamp_min(xh0_of(xa), eps);
    old0 = hav0;
  } else {
    h1_old = clamp_min(p.xh1_old[i], eps);
    hav1 = clamp_min(xa, eps);
    old0 = rl(1.0) - hav1;
  }
  real t_int = rl(0.0), t_av = rl(0.0), t_av_in = rl(0.0), t0 = rl(0.0),
       heat = rl(0.0), e0 = rl(0.0), cosmo_rate = rl(0.0),
       clump_bh = p.clump_bh;
  real brech = rl(0.0), acol = rl(0.0);
  bool active0 = false;
  if (kHeat) {
    t0 = p.t_cur[i];
    t_int = t0;
    t_av_in = p.t_av[i];
    t_av = t_av_in;
    heat = p.phiheat[i];
    e0 = thermal_e0(p, t0, nd, h1_old);
    cosmo_rate = r_mul(e0, coeff);
    active0 = t0 > p.minitemp;                      // thermal.f90:83
  } else {
    brech = p.brech[i * p.brech_stride];
    acol = p.acol[0];
  }
  if (p.clump) clump_bh = r_mul(p.clump[i * p.clump_stride], p.bh00);
  const real tol = r_mul(dt, rl(1e-6));
  c.passes = c.subs = c.max_subs = 0;
  for (int nit = 1; nit <= p.max_iter; ++nit) {
    c.passes = nit;
    const bool conv = doric_pass<kHeat, kCompressed>(
        p, dt, nd, ph, h1_old, h0_old, t_av, clump_bh, brech, acol, h1, h0,
        hav1, hav0);
    if (kHeat) {
      const ThermalPass th = thermal_pass(p, nd, hav1);
      real e = e0, t = t0, avg = rl(0.0), cum = rl(0.0);
      unsigned k = 0;
      bool running = active0;
      while (running && k < (unsigned)p.max_sub) {
        running = !thermal_substep(p, dt, tol, heat, cosmo_rate, th, e, t,
                                   avg, cum);
        ++k;
      }
      thermal_end(p, dt, t0, active0, nd, h1, e, avg, t_int, t_av);
      c.subs += k;
      c.max_subs = k > c.max_subs ? k : c.max_subs;
    }
    if (conv) break;
  }
  if (c.passes == 0) {
    // no pass ran: the iterate keeps its clamped input
    const real xi = p.xh_int[i];
    if (kCompressed) {
      h1 = clamp_min(xh1_of(xi), eps);
      h0 = clamp_min(xh0_of(xi), eps);
    } else {
      h1 = clamp_min(xi, eps);
    }
  }
  real o_int, o_av;
  cell_output<kHeat, kCompressed, kAudit>(p, nd, old0, h1, h0, hav1, hav0,
                                          t_av_in, t_av, clump_bh, acol_a,
                                          c.ion, o_int, o_av, audit);
  p.out_int[i] = o_int;
  p.out_av[i] = o_av;
  if (kHeat) {
    p.out_tint[i] = t_int;
    p.out_tav[i] = t_av;
  }
}

// the isothermal audit's collisional rate, COLH0 sqrt(T) exp(-TEMPH0 / T)
// at the initial temperature
__device__ __forceinline__ real audit_acol(const Chem& p) {
  return r_mul(r_mul(p.colh0, r_sqrt(p.audit_temp)), r_exp(p.audit_neg_t));
}

#ifdef C2R_CHEM_CELL_PER_THREAD
// ---------------------------------------------------------------------------
// The previous form, kept as a timing build: one thread per cell, 256 a
// block, the audit a runtime branch, the counters and audit sums reduced
// per block and then by two more launches.

constexpr int kReduceThreads = 1024;
// the reduce's first stage: the per-block partials of each quantity in
// this many contiguous chunks, one block each
constexpr int kChunks = 128;

template <bool kHeat, bool kCompressed>
__global__ void __launch_bounds__(kThreads) chemistry_cells(Chem p) {
  const real dt = read_dt(p);
  const real coeff = read_coeff(p);
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  CellCount c = {false, 0, 0, 0};
  double audit[kNumAudit] = {0.0, 0.0, 0.0, 0.0};
  if (i < p.ncell) {
    if (p.apartial)
      run_cell<kHeat, kCompressed, true>(p, i, dt, coeff, audit_acol(p), c,
                                         audit);
    else
      run_cell<kHeat, kCompressed, false>(p, i, dt, coeff, rl(0.0), c,
                                          audit);
  }
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned w[kNumCounters] = {
      __reduce_add_sync(full, c.ion ? 1u : 0u),
      __reduce_max_sync(full, c.passes), __reduce_add_sync(full, c.passes),
      __reduce_add_sync(full, c.subs), __reduce_max_sync(full, c.max_subs)};
  // the block's audit sums, in double: warp shuffles, then the warps in
  // order (a fixed order, so the same bits from run to run); the
  // counters' warp sums share their barrier
  __shared__ double s_a[kNumAudit][kWarps];
  if (p.apartial) {
    const double wsum = warp_sum4_d(audit, lane);
    if ((lane & 7) == 0) s_a[audit_of_lane(lane)][warp] = wsum;
  }
  __shared__ unsigned s_w[kNumCounters][kWarps];
  if (lane == 0) {
    for (int q = 0; q < kNumCounters; ++q) s_w[q][warp] = w[q];
  }
  __syncthreads();
  if (threadIdx.x < kNumCounters) {
    const int q = threadIdx.x;
    unsigned long long v = 0;
    for (int k = 0; k < kWarps; ++k) {
      const unsigned long long x = s_w[q][k];
      v = is_max(q) ? (x > v ? x : v) : v + x;
    }
    p.partial[(long long)q * gridDim.x + blockIdx.x] = v;
  }
  // a second warp writes the audit's partials
  if (p.apartial && warp == 1 && lane < kNumAudit) {
    double v = 0.0;
    for (int k = 0; k < kWarps; ++k) v += s_a[lane][k];
    p.apartial[(long long)lane * gridDim.x + blockIdx.x] = v;
  }
}


// The reduce's first stage, where the cell launch has more blocks than
// kChunks: block (c, q) sums (or, for a maximum, maxes) chunk c of
// quantity q's per-block partials, a contiguous range, in a fixed order:
// q < kNumCounters a counter, else an audit sum (where audit is not null).
// The second stage, reduce_counters, then reduces kChunks values per
// quantity.
__global__ void __launch_bounds__(kThreads)
reduce_chunks(const unsigned long long* partial, const double* apartial,
              long long nblocks, unsigned long long* counters,
              double* audit) {
  __shared__ unsigned long long buf[kThreads];
  __shared__ double dbuf[kThreads];
  const int q = blockIdx.y, c = blockIdx.x, t = threadIdx.x;
  const long long per = (nblocks + kChunks - 1) / kChunks;
  const long long lo = c * per, hi = lo + per < nblocks ? lo + per : nblocks;
  if (q < kNumCounters) {
    const bool mx = is_max(q);
    unsigned long long v = 0;
    for (long long b = lo + t; b < hi; b += kThreads) {
      const unsigned long long x = partial[q * nblocks + b];
      v = mx ? (x > v ? x : v) : v + x;
    }
    buf[t] = v;
    __syncthreads();
    for (int h = kThreads / 2; h > 0; h >>= 1) {
      if (t < h) {
        const unsigned long long x = buf[t + h];
        buf[t] = mx ? (x > buf[t] ? x : buf[t]) : buf[t] + x;
      }
      __syncthreads();
    }
    if (t == 0) counters[q * kChunks + c] = buf[0];
  } else {
    if (!audit) return;
    const int a = q - kNumCounters;
    double v = 0.0;
    for (long long b = lo + t; b < hi; b += kThreads)
      v += apartial[a * nblocks + b];
    dbuf[t] = v;
    __syncthreads();
    for (int h = kThreads / 2; h > 0; h >>= 1) {
      if (t < h) dbuf[t] += dbuf[t + h];
      __syncthreads();
    }
    if (t == 0) audit[a * kChunks + c] = dbuf[0];
  }
}

// The counters and the audit sums (where not null) from the per-block
// partials (or the first stage's chunks): one block; the counters' sums
// and maxima exact, the audit's sums in double, in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_counters(const unsigned long long* partial, long long nblocks,
                unsigned long long* counters, const double* apartial,
                real* audit) {
  __shared__ unsigned long long buf[kReduceThreads];
  __shared__ double dbuf[kReduceThreads];
  for (int c = 0; c < kNumCounters; ++c) {
    unsigned long long v = 0;
    for (long long b = threadIdx.x; b < nblocks; b += kReduceThreads) {
      const unsigned long long x = partial[c * nblocks + b];
      v = is_max(c) ? (x > v ? x : v) : v + x;
    }
    buf[threadIdx.x] = v;
    __syncthreads();
    for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) {
        const unsigned long long x = buf[threadIdx.x + h];
        buf[threadIdx.x] = is_max(c) ? (x > buf[threadIdx.x]
                                            ? x : buf[threadIdx.x])
                                     : buf[threadIdx.x] + x;
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) counters[c] = buf[0];
    __syncthreads();
  }
  for (int a = 0; audit && a < kNumAudit; ++a) {
    double v = 0.0;
    for (long long b = threadIdx.x; b < nblocks; b += kReduceThreads)
      v += apartial[a * nblocks + b];
    dbuf[threadIdx.x] = v;
    __syncthreads();
    for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) dbuf[threadIdx.x] += dbuf[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) audit[a] = (real)dbuf[0];
    __syncthreads();
  }
}

// -> the number of launches, or a negative CUDA error code
int launch_chemistry(const Chem& p, bool heat, bool compressed,
                     cudaStream_t st) {
  const long long blocks = (p.ncell + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -(int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(kThreads);
  if (heat) {
    if (compressed)
      chemistry_cells<true, true><<<grid, block, 0, st>>>(p);
    else
      chemistry_cells<true, false><<<grid, block, 0, st>>>(p);
  } else {
    if (compressed)
      chemistry_cells<false, true><<<grid, block, 0, st>>>(p);
    else
      chemistry_cells<false, false><<<grid, block, 0, st>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return -(int)err;
  int launches = 1;
  const unsigned long long* cin = p.partial;
  const double* ain = p.apartial;
  long long n = blocks;
  if (blocks > kChunks) {
    // the first stage's chunks go after the per-block partials
    unsigned long long* c2 = p.partial + kNumCounters * blocks;
    double* a2 = p.apartial ? p.apartial + kNumAudit * blocks : nullptr;
    reduce_chunks<<<dim3(kChunks, kNumCounters + kNumAudit), kThreads, 0,
                    st>>>(p.partial, p.apartial, blocks, c2, a2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return -(int)err;
    ++launches;
    cin = c2;
    ain = a2;
    n = kChunks;
  }
  reduce_counters<<<1, kReduceThreads, 0, st>>>(cin, n, p.counters, ain,
                                                p.apartial ? p.audit
                                                           : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return -(int)err;
  return launches + 1;
}

long long scratch_blocks(long long ncell) {
  return (ncell + kThreads - 1) / kThreads + kChunks;
}


#else
// ---------------------------------------------------------------------------
// The persistent form.

// The blocks of 256 an SM must hold (registers: 65,536 / (blocks x 256) a
// thread at most), chosen per build by timing builds on the card
// (PERF.md): float32 heat 4 (64 registers, no spill; 66 unbounded, so 3
// blocks), float64 heat 3 (80 registers and 80-176 bytes of spill stores;
// 95-113 unbounded, so 2 blocks); 5 blocks in float32 heat spilled and ran
// slower.  Isothermally the compiler's allotment (36-47 registers in
// float32, 61-77 in float64).
template <bool kHeat>
struct Occupancy {
#ifdef C2R_F64
  static constexpr int kMinBlocks = kHeat ? 3 : 1;
#else
  static constexpr int kMinBlocks = kHeat ? 4 : 1;
#endif
};

// Blocks of a launch that have finished; the last one sums the partials
// and sets it back to 0 for the next launch.
__device__ unsigned int g_chem_done = 0;

template <bool kHeat, bool kCompressed, bool kAudit>
__global__ void __launch_bounds__(kThreads, Occupancy<kHeat>::kMinBlocks)
    chemistry_persistent(const __grid_constant__ Chem p) {
  __shared__ unsigned long long s_c[kNumCounters][kWarps];
  __shared__ double s_a[kNumAudit][kWarps];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const real dt = read_dt(p);
  const real coeff = read_coeff(p);
  const real acol_a = (kAudit && !kHeat) ? audit_acol(p) : rl(0.0);

  // the thread's sums over its cells, in cell order
  unsigned ion = 0, passes = 0, max_passes = 0, max_subs = 0;
  unsigned long long subs = 0;
  double acc[kNumAudit] = {0.0, 0.0, 0.0, 0.0};
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < p.ncell; i += stride) {
    CellCount c;
    double terms[kNumAudit];
    run_cell<kHeat, kCompressed, kAudit>(p, i, dt, coeff, acol_a, c, terms);
    ion += c.ion ? 1u : 0u;
    passes += c.passes;
    max_passes = c.passes > max_passes ? c.passes : max_passes;
    subs += c.subs;
    max_subs = c.max_subs > max_subs ? c.max_subs : max_subs;
    if (kAudit) {
      for (int a = 0; a < kNumAudit; ++a) acc[a] += terms[a];
    }
  }

  // the block's sums: warp shuffles, then the warps in order (a fixed
  // order, so the same bits from run to run)
  const unsigned long long w[kNumCounters] = {
      warp_sum_u64(ion), warp_max_u64(max_passes), warp_sum_u64(passes),
      warp_sum_u64(subs), warp_max_u64(max_subs)};
  if (lane == 0) {
    for (int q = 0; q < kNumCounters; ++q) s_c[q][warp] = w[q];
  }
  if (kAudit) {
    const double wsum = warp_sum4_d(acc, lane);
    if ((lane & 7) == 0) s_a[audit_of_lane(lane)][warp] = wsum;
  }
  __syncthreads();
  if (threadIdx.x < kNumCounters) {
    const int q = threadIdx.x;
    unsigned long long v = 0;
    for (int k = 0; k < kWarps; ++k) {
      const unsigned long long x = s_c[q][k];
      v = is_max(q) ? (x > v ? x : v) : v + x;
    }
    p.partial[(long long)q * gridDim.x + blockIdx.x] = v;
  }
  if (kAudit && warp == 1 && lane < kNumAudit) {
    double v = 0.0;
    for (int k = 0; k < kWarps; ++k) v += s_a[lane][k];
    p.apartial[(long long)lane * gridDim.x + blockIdx.x] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&g_chem_done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: every block's partials, each lane over blocks lane,
  // lane + 32, ... in order, then the lanes in a fixed butterfly
  const int nq = kNumCounters + (kAudit ? kNumAudit : 0);
  for (int q = warp; q < nq; q += kWarps) {
    if (q < kNumCounters) {
      unsigned long long v = 0;
      for (unsigned b = lane; b < gridDim.x; b += 32) {
        const unsigned long long x =
            __ldcg(p.partial + (long long)q * gridDim.x + b);
        v = is_max(q) ? (x > v ? x : v) : v + x;
      }
      v = is_max(q) ? warp_max_u64(v) : warp_sum_u64(v);
      if (lane == 0) p.counters[q] = v;
    } else {
      const int a = q - kNumCounters;
      double v = 0.0;
      for (unsigned b = lane; b < gridDim.x; b += 32)
        v += __ldcg(p.apartial + (long long)a * gridDim.x + b);
      v = warp_sum_d(v);
      if (lane == 0) p.audit[a] = (real)v;
    }
  }
  if (threadIdx.x == 0) g_chem_done = 0;
}

// The persistent grid of an instance: the SMs times the blocks each holds,
// asked once per device and instance.
struct GridEntry {
  const void* fn;
  int device;
  int blocks;
};
std::mutex g_grid_mu;
GridEntry g_grids[64];
int g_ngrids = 0;

template <bool kHeat, bool kCompressed, bool kAudit>
int launch_persistent(const Chem& p, cudaStream_t st) {
  const void* fn =
      (const void*)chemistry_persistent<kHeat, kCompressed, kAudit>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  long long blocks = 0;
  {
    std::lock_guard<std::mutex> lock(g_grid_mu);
    for (int e = 0; e < g_ngrids; ++e)
      if (g_grids[e].fn == fn && g_grids[e].device == dev)
        blocks = g_grids[e].blocks;
    if (blocks == 0) {
      int per_sm = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                          kThreads, 0);
      if (err != cudaSuccess) return -(int)err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return -(int)err;
      if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
      blocks = (long long)per_sm * sms;
      if (g_ngrids < 64) g_grids[g_ngrids++] = {fn, dev, (int)blocks};
    }
  }
  // no more blocks than take a cell a thread
  const long long need = (p.ncell + kThreads - 1) / kThreads;
  if (need < blocks) blocks = need;
  chemistry_persistent<kHeat, kCompressed, kAudit>
      <<<(unsigned)blocks, kThreads, 0, st>>>(p);
  err = cudaGetLastError();
  return err == cudaSuccess ? 1 : -(int)err;
}

template <bool kHeat, bool kCompressed>
int launch_audit(const Chem& p, cudaStream_t st) {
  return p.apartial ? launch_persistent<kHeat, kCompressed, true>(p, st)
                    : launch_persistent<kHeat, kCompressed, false>(p, st);
}

// -> the number of launches, or a negative CUDA error code
int launch_chemistry(const Chem& p, bool heat, bool compressed,
                     cudaStream_t st) {
  if (heat)
    return compressed ? launch_audit<true, true>(p, st)
                      : launch_audit<true, false>(p, st);
  return compressed ? launch_audit<false, true>(p, st)
                    : launch_audit<false, false>(p, st);
}

// an upper bound of the persistent grid: the SMs times the most blocks an
// SM holds
long long scratch_blocks(long long) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxBlocksPerMultiprocessor,
                             dev) != cudaSuccess)
    return -1;
  return (long long)sms * per_sm;
}

#endif  // C2R_CHEM_CELL_PER_THREAD

}  // namespace

extern "C" {

// One chemistry pass over ncell cells.  loss: the per-cell
// photon_loss_rate (stride 1) or a 0-d one (stride 0), or null for the
// scalar s[kLossScalar].  brech, acol: the isothermal build's rates
// (brech stride 0 or 1; ignored by the heat build).  clump: the
// clumping (stride 0 or 1), or null for a Python scalar clumping: the heat
// build then takes s[kClumpBh], the product clumping * BH00, and the
// isothermal audit s[kAuditBrech].  phiheat, t_cur,
// t_av, cie: the heat build's grids and the 61-point cooling table.
// s: kNumScalars doubles in Scalar's order, each cast to the build's
// type as torch casts a Python float; dt_p and coeff_p, where not null,
// point at s[kDt] and s[kCoeff]'s values on the card, which the kernel
// reads at launch instead (the device loop's graph replays one capture
// over steps of another dt).  counters: 5 64-bit integers out (Counter);
// partial: scratch of 5 x c2r_chemistry_blocks(ncell) of them.  audit: 4
// sums out (Audit; the isothermal build takes its rates from
// s[kAuditBrech..kAuditNegT] and clump), or null for none; apartial:
// scratch of 4 x c2r_chemistry_blocks(ncell) doubles.  heat, compressed:
// the instance.  *launches: the kernel launches made.  Returns the first
// CUDA error code, 0 on success.
int c2r_chemistry(const real* ndens, const real* xh1_old, const real* xh_int,
                  const real* xh_av, const real* phih, const real* loss,
                  int loss_stride, const real* brech, int brech_stride,
                  const real* acol, const real* clump, int clump_stride,
                  const real* phiheat, const real* t_cur, const real* t_av,
                  const real* cie, const double* s, const double* dt_p,
                  const double* coeff_p, long long ncell,
                  int max_iter, int max_sub, int heat, int compressed,
                  real* out_int, real* out_av, real* out_tint, real* out_tav,
                  unsigned long long* counters, unsigned long long* partial,
                  double* apartial, real* audit, int* launches,
                  void* stream) {
  *launches = 0;
  Chem p = {};
  p.ndens = ndens;
  p.xh1_old = xh1_old;
  p.xh_int = xh_int;
  p.xh_av = xh_av;
  p.phih = phih;
  p.loss = loss;
  p.brech = brech;
  p.acol = acol;
  p.clump = clump;
  p.phiheat = phiheat;
  p.t_cur = t_cur;
  p.t_av = t_av;
  p.cie = cie;
  p.out_int = out_int;
  p.out_av = out_av;
  p.out_tint = out_tint;
  p.out_tav = out_tav;
  p.counters = counters;
  p.partial = partial;
  p.apartial = audit ? apartial : nullptr;
  p.audit = audit;
  p.ncell = ncell;
  p.loss_stride = loss_stride;
  p.brech_stride = brech_stride;
  p.clump_stride = clump_stride;
  p.max_iter = max_iter;
  p.max_sub = max_sub;
  p.dt = (real)s[kDt];
  p.eps = (real)s[kEps];
  p.one_minus_eps = (real)(1.0 - s[kEps]);   // Python's 1.0 - eps, cast
  p.mfc = (real)s[kMfc];
  p.min_atoms = (real)s[kMinAtoms];
  p.loss_scalar = (real)s[kLossScalar];
  p.clump_bh = (real)s[kClumpBh];
  p.bh00 = (real)s[kBh00];
  p.albpow = (real)s[kAlbpow];
  // torch's division by a Python scalar: (real)(1.0 / b) times the tensor
  p.inv_1e4 = (real)(1.0 / 1e4);
  p.colh0 = (real)s[kColh0];
  p.neg_temph0 = (real)(-s[kTemph0]);
  p.abu_c = (real)s[kAbuC];
  p.k_b = (real)s[kKb];
  p.gamma1 = (real)s[kGamma1];
  p.inv_gamma1 = (real)(1.0 / s[kGamma1]);
  p.log10e = (real)s[kLog10e];
  p.tab_min = (real)s[kTabMin];
  p.inv_tab_step = (real)(1.0 / s[kTabStep]);
  p.minitemp = (real)s[kMinitemp];
  p.rel_denergy = (real)s[kRelDenergy];
  p.coeff = (real)s[kCoeff];
  p.dt_p = dt_p;
  p.coeff_p = coeff_p;
  p.rate_floor = rl(1e-50);
  p.audit_brech = (real)s[kAuditBrech];
  p.audit_pow = (real)s[kAuditPow];
  p.audit_temp = (real)s[kAuditTemp];
  p.audit_neg_t = (real)s[kAuditNegT];
  if (ncell <= 0) return 0;
  if (loss_stride < 0 || loss_stride > 1 || brech_stride < 0 ||
      brech_stride > 1 || clump_stride < 0 || clump_stride > 1 ||
      max_iter < 0 || max_sub < 0)
    return (int)cudaErrorInvalidValue;
  if (heat ? (!phiheat || !t_cur || !t_av || !cie || !out_tint || !out_tav)
           : (!brech || !acol))
    return (int)cudaErrorInvalidValue;
  if (!counters || !partial || (audit && !apartial))
    return (int)cudaErrorInvalidValue;
  const int n = launch_chemistry(p, heat != 0, compressed != 0,
                                 (cudaStream_t)stream);
  if (n < 0) return -n;
  *launches = n;
  return 0;
}

// The partials' length per quantity for ncell cells (the counters'
// scratch holds 5 x this, the audit's 4 x this): the persistent grid's
// most blocks (the cell-per-thread build: its blocks and the reduce's
// first-stage chunks).
long long c2r_chemistry_blocks(long long ncell) {
  return scratch_blocks(ncell);
}

// One kernel per libdevice routine of the build's type, whose SASS
// chip_smoke.py counts for the float64 bound.
__global__ void c2r_chemistry_probe_exp(real* x) {
  x[threadIdx.x] = r_exp(x[threadIdx.x]);
}
__global__ void c2r_chemistry_probe_expm1(real* x) {
  x[threadIdx.x] = r_expm1(x[threadIdx.x]);
}
__global__ void c2r_chemistry_probe_log(real* x) {
  x[threadIdx.x] = r_log(x[threadIdx.x]);
}
__global__ void c2r_chemistry_probe_pow(real* x) {
  x[threadIdx.x] = r_pow(x[threadIdx.x], x[threadIdx.x + 32]);
}
__global__ void c2r_chemistry_probe_sqrt(real* x) {
  x[threadIdx.x] = r_sqrt(x[threadIdx.x]);
}
__global__ void c2r_chemistry_probe_div(real* x) {
  x[threadIdx.x] = x[threadIdx.x] / x[threadIdx.x + 32];
}

const char* c2r_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
