// The grid-wide chemistry pass, one thread per cell, hand-written for
// Hopper (sm_90a).
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
// math function is its libdevice routine (real.cuh).  _build.py passes
// --fmad=false, so no multiply and add fuse.  The isothermal build reads
// the recombination rates the wrapper computes once with the plain
// version's own torch ops (0-d, or a grid under a clumping grid).
//
// What bounds it on the H100: the compulsory bytes, one read of each
// input grid and one write of each output.  Isothermal float32 at
// 256^3: ndens, xh1_old, xh1_intermed, xh1_av, phih read and two grids
// written, 7 x 67.1 MB = 470 MB, 0.140 ms at 3.35 TB/s; the heat build
// reads phiheat and two temperatures and writes two more, 805 MB,
// 0.240 ms.  The arithmetic depends on the data: a doric pass takes
// one expf and one expm1f per cell (the heat build adds powf, sqrtf,
// expf and a division for the rates, and per substep one logf and
// three divisions), so the SFU term is (passes x cells) x results per
// pass over 4.2e12 results/s; chip_smoke.py counts the passes and
// substeps this run's data needs from the kernel's counters.  Thermal
// stragglers share warps with cells that finish early, and a warp runs
// as long as its slowest cell: that divergence is this design's cost.
//
// Design: one thread per cell, 256 a block; shared memory only for the
// block's reductions.  The per-cell state lives in registers; the inputs
// are read once, before the loops (xh1_intermed only where no pass
// runs: every pass overwrites it).  The five counters are reduced in the
// block (warp shuffles, then shared memory) into per-block partials,
// which a second one-block launch reduces: integers, so exact, and no
// atomics on five shared addresses (the first form, one atomic per warp
// and counter, serialized there: -DC2R_CHEM_ATOMIC_COUNTERS keeps it as
// a timing build).
//
// The photon audit (where the caller asks for it): what the solver's tail
// computes with two calls of ops/photonstats.py::grid_counts (the JAX
// twin's c2ray_tpu/ops/photonstats.py::grid_counts, called twice in
// c2ray_tpu/solver.py's _tail; XLA fuses it there), folded into the
// output pass, which holds every input of those sums in registers: h0 and
// h1 of the stored iterate, rec_rate and coll_rate of the stored average
// under the output temperature (heat) or the initial temperature, with a
// scalar or per-cell clumping, decoded from compressed storage as
// grid_counts decodes it.  Each cell's four terms follow grid_counts' ops;
// they are summed in double, per block (warp shuffles, then the warps in
// order) and then by the reduce launch in a fixed order, so the sums are
// the same from run to run and differ from torch.sum's only by the order
// of the sum.  The audit reads no extra bytes (a clumping grid, where
// given, is read once in either build).

#include <cuda_runtime.h>

#include "real.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 1024;
// the reduce's first stage: the per-block partials of each quantity in
// this many contiguous chunks, one block each
constexpr int kChunks = 128;
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
  brech = clump_bh * r_pow(t * p.inv_1e4, p.albpow);
  acol = (p.colh0 * r_sqrt(t)) * r_exp((rl(1.0) / t) * p.neg_temph0);
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

// ops/thermal.py::thermal for one cell, with the pass's doric output
// (x1_end, x1_av) and the step-initial t0: -> (final T, average T) and
// the substeps taken
__device__ void thermal_cell(const Chem& p, real t0, real nd, real x1_end,
                             real x1_av, real h1_old, real heat,
                             real& final_t, real& avg_t, unsigned& nsub) {
  const real ne_old = nd * (h1_old + p.abu_c);
  // temper2pressr / GAMMA1, the latter a multiply by its reciprocal
  const real e0 = (((nd + ne_old) * p.k_b) * t0) * p.inv_gamma1;
  const real cosmo_rate = e0 * p.coeff;
  const real ne_av = nd * (x1_av + p.abu_c);
  const bool active0 = t0 > p.minitemp;                 // thermal.f90:83
  const real e_floor = ((nd + ne_av) * p.k_b) * p.minitemp;
  const real ndne = nd * ne_av;
  const real pden = p.k_b * (nd + ne_av);
  const real tol = p.dt * rl(1e-6);
  real e = e0, t = t0, avg = rl(0.0), cum = rl(0.0);
  unsigned k = 0;
  bool running = active0;
  while (running && k < (unsigned)p.max_sub) {
    // coolin: log10 as the natural log times log10(e), linear table
    // interpolation
    const real tpos =
        ((r_log(t) * p.log10e - p.tab_min) * p.inv_tab_step) + rl(1.0);
    int it = (int)r_floor(tpos);
    it = it < 1 ? 1 : (it > kTempPoints - 1 ? kTempPoints - 1 : it);
    const real dtpos = tpos - (real)it;
    const int it1 = it + 1 > kTempPoints ? kTempPoints : it + 1;
    const real c0 = p.cie[it - 1];
    const real c1 = p.cie[it1 - 1];
    const real cooling = ndne * (c0 + (c1 - c0) * dtpos) + cosmo_rate;
    const real rate = clamp_min(r_abs(cooling - heat), p.rate_floor);
    const real dt_thermal = (p.rel_denergy * e) / rate;
    const real dt_ode = t_minimum(dt_thermal, p.dt - cum);
    real e_new = e + dt_ode * (heat - cooling);
    real avg_new = avg + (rl(0.5) * t) * dt_ode;
    real t_new = (e_new * p.gamma1) / pden;
    avg_new = avg_new + (rl(0.5) * t_new) * dt_ode;
    // the temperature floor (thermal.f90:142-148)
    if (t_new < p.minitemp) {
      e_new = e_floor;
      t_new = p.minitemp;
    }
    const real cum_new = cum + dt_ode;
    const bool done = (cum_new >= p.dt) || (r_abs(cum_new - p.dt) < tol);
    e = e_new;
    t = t_new;
    avg = avg_new;
    cum = cum_new;
    running = !done;
    ++k;
  }
  nsub = k;
  const real ne_end = nd * (x1_end + p.abu_c);
  const real ft = (e * p.gamma1) / (p.k_b * (nd + ne_end));
  const real at = p.dt > rl(0.0) ? avg / p.dt : t0;
  final_t = active0 ? ft : t0;
  avg_t = active0 ? at : t0;
}

template <bool kHeat, bool kCompressed>
__global__ void __launch_bounds__(kThreads) chemistry_cells(Chem p) {
  if (p.dt_p) p.dt = (real)*p.dt_p;
  if (p.coeff_p) p.coeff = (real)*p.coeff_p;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < p.ncell;
  unsigned ion = 0, passes = 0, subs = 0, max_subs = 0;
  // the audit's terms of this cell (photonstats.grid_counts)
  double audit[kNumAudit] = {0.0, 0.0, 0.0, 0.0};
  if (live) {
    const real eps = p.eps;
    const real nd = p.ndens[i];
    const real ph =
        p.phih[i] + (p.loss ? p.loss[i * p.loss_stride] : p.loss_scalar);
    real h1_old, h0_old = rl(0.0), hav1, hav0 = rl(0.0), h1 = rl(0.0),
                 h0 = rl(0.0);
    const real xa = p.xh_av[i];
    if (kCompressed) {
      const real xo = p.xh1_old[i];
      h1_old = clamp_min(xh1_of(xo), eps);
      h0_old = clamp_min(xh0_of(xo), eps);
      hav1 = clamp_min(xh1_of(xa), eps);
      hav0 = clamp_min(xh0_of(xa), eps);
    } else {
      h1_old = clamp_min(p.xh1_old[i], eps);
      hav1 = clamp_min(xa, eps);
    }
    const real hav0_start = hav0;
    real t_int = rl(0.0), t_av = rl(0.0), t_av_in = rl(0.0), t0 = rl(0.0),
         heat = rl(0.0), clump_bh = p.clump_bh;
    real brech = rl(0.0), acol = rl(0.0);
    if (kHeat) {
      t0 = p.t_cur[i];
      t_int = t0;
      t_av_in = p.t_av[i];
      t_av = t_av_in;
      heat = p.phiheat[i];
      if (p.clump) clump_bh = p.clump[i * p.clump_stride] * p.bh00;
    } else {
      brech = p.brech[i * p.brech_stride];
      acol = p.acol[0];
    }
    const real x0_init = rl(1.0) - h1_old;    // doric's xh0_old
    for (int nit = 1; nit <= p.max_iter; ++nit) {
      passes = nit;
      const real prev = kCompressed ? hav0 : clamp_min(rl(1.0) - hav1, eps);
      const real rhe = nd * (hav1 + p.abu_c);
      // recombination_rates at the cell's average temperature
      if (kHeat) rates_at(p, t_av, clump_bh, brech, acol);
      // doric (doric.f90:96-124)
      const real aih0 = ph + rhe * acol;
      const real delth = aih0 + rhe * brech;
      const real eq1 = aih0 / delth;
      const real eq0 = (rhe * brech) / delth;
      const real deltht = delth * p.dt;
      const real ee = r_exp(-deltht);
      const real x0old = kCompressed ? h0_old : x0_init;
      real x1 = (h1_old - eq1) * ee + eq1;
      real x0 = (x0old - eq0) * ee + eq0;
      if (x0 < eps) {
        x0 = eps;
        x1 = p.one_minus_eps;
      }
      const real af =
          deltht < rl(1.0e-8) ? rl(1.0) : (-r_expm1(-deltht)) / deltht;
      const real x1av = eq1 + (h1_old - eq1) * af;
      const real x0av = kCompressed
                            ? clamp_min(eq0 + (x0old - eq0) * af, eps)
                            : clamp_min(rl(1.0) - x1av, eps);
      if (kHeat) {
        unsigned ns;
        thermal_cell(p, t0, nd, x1, x1av, h1_old, heat, t_int, t_av, ns);
        subs += ns;
        max_subs = ns > max_subs ? ns : max_subs;
      }
      const bool conv =
          (r_abs((x0av - prev) / x0av) < p.mfc) || (x0av < p.min_atoms);
      h1 = x1;
      hav1 = x1av;
      if (kCompressed) {
        h0 = x0;
        hav0 = x0av;
      }
      if (conv) break;
    }
    if (passes == 0) {
      // no pass ran: the iterate keeps its clamped input
      const real xi = p.xh_int[i];
      if (kCompressed) {
        h1 = clamp_min(xh1_of(xi), eps);
        h0 = clamp_min(xh0_of(xi), eps);
      } else {
        h1 = clamp_min(xi, eps);
      }
    }
    // the outer non-convergence count (evolve_point.F90:384-391)
    real old0, end0;
    if (kCompressed) {
      old0 = hav0_start;
      end0 = hav0;
    } else {
      old0 = rl(1.0) - clamp_min(xa, eps);
      end0 = clamp_min(rl(1.0) - hav1, eps);
    }
    bool cond = (r_abs(end0 - old0) > p.mfc) &&
                (r_abs((end0 - old0) / end0) > p.mfc) && (end0 > p.min_atoms);
    if (kHeat) {
      cond = cond || ((r_abs((t_av_in - t_av) / t_av) > rl(1.0e-1)) &&
                      (r_abs(t_av_in - t_av) > rl(100.0)));
    }
    ion = cond ? 1u : 0u;
    const real o_int = kCompressed ? compress(h1, h0) : h1;
    const real o_av = kCompressed ? compress(hav1, hav0) : hav1;
    p.out_int[i] = o_int;
    p.out_av[i] = o_av;
    if (kHeat) {
      p.out_tint[i] = t_int;
      p.out_tav[i] = t_av;
    }
    if (p.apartial) {
      // grid_counts on the stored outputs, op for op: x1 and x0 decoded
      // from each (or x0 = 1 - x1), the rates at the output temperature
      // t_av (heat) or at the scalar initial temperature
      const real x1i = kCompressed ? xh1_of(o_int) : o_int;
      const real x0i = kCompressed ? xh0_of(o_int) : rl(1.0) - o_int;
      const real x1a = kCompressed ? xh1_of(o_av) : o_av;
      const real x0a = kCompressed ? xh0_of(o_av) : rl(1.0) - o_av;
      real brech_a, acol_a;
      if (kHeat) {
        rates_at(p, t_av, clump_bh, brech_a, acol_a);
      } else {
        brech_a = p.clump ? (p.clump[i * p.clump_stride] * p.bh00) *
                                p.audit_pow
                          : p.audit_brech;
        acol_a = (p.colh0 * r_sqrt(p.audit_temp)) * r_exp(p.audit_neg_t);
      }
      const real ne = nd * (x1a + p.abu_c);
      audit[kH0] = (double)(nd * x0i);
      audit[kH1] = (double)(nd * x1i);
      audit[kRec] = (double)(((nd * x1a) * ne) * brech_a);
      audit[kColl] = (double)(((nd * x0a) * ne) * acol_a);
    }
  }
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned w[kNumCounters] = {
      __reduce_add_sync(full, ion), __reduce_max_sync(full, passes),
      __reduce_add_sync(full, passes), __reduce_add_sync(full, subs),
      __reduce_max_sync(full, max_subs)};
  // the block's audit sums, in double: warp shuffles, then the warps in
  // order (a fixed order, so the same bits from run to run); the
  // counters' warp sums share their barrier
  __shared__ double s_a[kNumAudit][kWarps];
  if (p.apartial) {
    const double wsum = warp_sum4_d(audit, lane);
    if ((lane & 7) == 0) s_a[audit_of_lane(lane)][warp] = wsum;
  }
#ifdef C2R_CHEM_ATOMIC_COUNTERS
  if (lane == 0) {
    if (w[kConv]) atomicAdd(p.counters + kConv, (unsigned long long)w[kConv]);
    atomicMax(p.counters + kMaxPasses, (unsigned long long)w[kMaxPasses]);
    atomicAdd(p.counters + kPasses, (unsigned long long)w[kPasses]);
    if (kHeat) {
      atomicAdd(p.counters + kSubsteps, (unsigned long long)w[kSubsteps]);
      atomicMax(p.counters + kMaxSubsteps,
                (unsigned long long)w[kMaxSubsteps]);
    }
  }
  if (p.apartial) __syncthreads();
#else
  __shared__ unsigned s_w[kNumCounters][kWarps];
  if (lane == 0) {
    for (int c = 0; c < kNumCounters; ++c) s_w[c][warp] = w[c];
  }
  __syncthreads();
  if (threadIdx.x < kNumCounters) {
    const int c = threadIdx.x;
    unsigned long long v = 0;
    for (int k = 0; k < kWarps; ++k) {
      const unsigned long long x = s_w[c][k];
      v = is_max(c) ? (x > v ? x : v) : v + x;
    }
    p.partial[(long long)c * gridDim.x + blockIdx.x] = v;
  }
#endif
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
// q < kNumCounters a counter (where counters is not null), else an audit
// sum (where audit is not null).  The second stage, reduce_counters, then
// reduces kChunks values per quantity.  One block reading every partial
// (the second stage alone) is bound by its loads' latency.
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
    if (!counters) return;
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

// The counters (where not null) and the audit sums (where not null) from
// the per-block partials (or the first stage's chunks): one block; the
// counters' sums and maxima exact, the audit's sums in double, in a fixed
// order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_counters(const unsigned long long* partial, long long nblocks,
                unsigned long long* counters, const double* apartial,
                real* audit) {
  __shared__ unsigned long long buf[kReduceThreads];
  __shared__ double dbuf[kReduceThreads];
  for (int c = 0; counters && c < kNumCounters; ++c) {
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
// over steps of another dt).  counters: 5 zeroed 64-bit
// integers (Counter); partial: scratch of 5 x c2r_chemistry_blocks(ncell)
// of them (the per-block partials, then the reduce's first stage).  audit: 4 sums out (Audit; the isothermal build takes its
// rates from s[kAuditBrech..kAuditNegT] and clump), or null for none;
// apartial: scratch of 4 x c2r_chemistry_blocks(ncell) doubles.  heat,
// compressed: the instance.  Returns the first CUDA error code, 0 on
// success.
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
                  double* apartial, real* audit, void* stream) {
  Chem p;
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
  if (audit && !apartial) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = (ncell + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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
  if (err != cudaSuccess) return (int)err;
#ifdef C2R_CHEM_ATOMIC_COUNTERS
  unsigned long long* reduced = nullptr;   // the kernel added them
#else
  unsigned long long* reduced = counters;
#endif
  if (reduced || audit) {
    const unsigned long long* cin = partial;
    const double* ain = apartial;
    long long n = blocks;
    if (blocks > kChunks) {
      // the first stage's chunks go after the per-block partials
      unsigned long long* c2 = partial + kNumCounters * blocks;
      double* a2 = audit ? apartial + kNumAudit * blocks : nullptr;
      reduce_chunks<<<dim3(kChunks, kNumCounters + kNumAudit), kThreads, 0,
                      st>>>(partial, apartial, blocks, reduced ? c2 : nullptr,
                            a2);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      cin = c2;
      ain = a2;
      n = kChunks;
    }
    reduce_counters<<<1, kReduceThreads, 0, st>>>(cin, n, reduced, ain,
                                                  audit);
    err = cudaGetLastError();
  }
  return (int)err;
}

// The partials' length per quantity for ncell cells: the cell launch's
// blocks and the reduce's first-stage chunks (the counters' scratch holds
// 5 x this, the audit's 4 x this).
long long c2r_chemistry_blocks(long long ncell) {
  return (ncell + kThreads - 1) / kThreads + kChunks;
}

const char* c2r_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
