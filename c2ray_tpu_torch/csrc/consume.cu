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
// Built with --fmad=false so each product and sum rounds as in the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kSigma = 6.30e-18f;             // SIGMA_HI_AT_ION_FREQ
constexpr float kFourPi = 12.566370614359172f;
constexpr float kSqrt3 = 1.7320508075688772f;   // the longest path, cells
constexpr int kTileK = 32;                      // one warp of k
constexpr int kTileJ = 8;                       // warps per block
constexpr int kThreads = kTileK * kTileJ;

struct Consume {
  const float* cdo;      // (B, n, n, n) centred coldensh_out
  const float* ndhi;     // (n, n, n) grid frame
  const float* lls;      // (n, n, n) grid frame LLS columns (kLLS == 2)
  const int* srcpos;     // (B, 3)
  const float* nflux;    // (B,)
  const float* nfx;      // (B,) X-ray fluxes (kXray)
  const float* mix_a;    // (K,)
  const float* mix_w;    // (K,)
  const float* heat_w;   // (K,) heat weights (kHeat)
  const float* xmix_a;   // (Kx,) the X-ray mixture (kXray)
  const float* xmix_w;   // (Kx,)
  const float* xheat_w;  // (Kx,) (kXray and kHeat)
  float* phih;           // (n, n, n) grid frame
  float* phiheat;        // (n, n, n) grid frame (kHeat)
  float* partial;        // (2, B, nblocks)
  int K, Kx, nsrc, n, max_shell;
  float dr, rate_scale, lcol, rmax2, max_coldensh;
};

dim3 cell_grid(int n) {
  return dim3((n + kTileK - 1) / kTileK, (n + kTileJ - 1) / kTileJ, n);
}

__device__ __forceinline__ int wrap1(int x, int n) {
  return x < 0 ? x + n : (x >= n ? x - n : x);
}

// max(x, 0) and min(x, 80) that keep a NaN, as jnp/torch do
__device__ __forceinline__ float max0(float x) { return x < 0.f ? 0.f : x; }
__device__ __forceinline__ float min80(float x) { return x > 80.f ? 80.f : x; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Floats of the cell kernel's shared memory (its B source cells follow
// as ints): the warps' loss partials, the fluxes and the mixture terms.
size_t consume_smem_floats(int nsrc, int K, int Kx, bool heat, bool xray) {
  const int per_term = heat ? 3 : 2;
  return (size_t)2 * nsrc * kTileJ + nsrc + per_term * K +
         (xray ? nsrc + per_term * Kx : 0);
}

// One exponential mixture's sums for a live pair, term for term
// _photoion_expsum_impl's loop: phi_in, phi_cell, the heat weights' sum
// (kHeat) and the LLS tally's (kTally).
template <bool kTally, bool kHeat>
__device__ __forceinline__ void mixture(
    const float* s_a, const float* s_w, const float* s_hw, int K,
    float tau_in, float dtau, float tau_pre, float dtau_pre, float& phi_in,
    float& phi_cell, float& heat_acc, float& lls_acc) {
  phi_in = 0.f;
  phi_cell = 0.f;
  heat_acc = 0.f;
  lls_acc = 0.f;
#pragma unroll 8
  for (int t = 0; t < K; ++t) {
    const float a = s_a[t], w = s_w[t];
    const float att = expf(-min80(a * tau_in));
    const float absorb = att * -expm1f(-min80(a * dtau));
    phi_in = phi_in + w * att;
    phi_cell = phi_cell + w * absorb;
    if (kHeat) heat_acc = heat_acc + s_hw[t] * absorb;
    if (kTally) {
      const float att_pre = expf(-min80(a * tau_pre));
      lls_acc = lls_acc + (w * att_pre) * -expm1f(-min80(a * dtau_pre));
    }
  }
}

// kLLS: 0 LLS off, 1 the scalar column p.lcol, 2 the grid p.lls.
template <int kLLS, bool kHeat, bool kXray>
__global__ void __launch_bounds__(kThreads) consume_cells(Consume p) {
  constexpr bool kTally = kLLS != 0;
  extern __shared__ float smem[];
  const int nsrc = p.nsrc, K = p.K, Kx = kXray ? p.Kx : 0;
  float* red = smem;                             // [2][B][kTileJ]
  float* s_nf = red + 2 * nsrc * kTileJ;         // [B]
  float* s_a = s_nf + nsrc;                      // [K]
  float* s_w = s_a + K;                          // [K]
  float* s_hw = s_w + K;                         // [K] (kHeat)
  float* s_nfx = s_hw + (kHeat ? K : 0);         // [B] (kXray)
  float* s_xa = s_nfx + (kXray ? nsrc : 0);      // [Kx] (kXray)
  float* s_xw = s_xa + Kx;                       // [Kx]
  float* s_xhw = s_xw + Kx;                      // [Kx] (kHeat)
  int* s_pos = reinterpret_cast<int*>(s_xhw + (kHeat ? Kx : 0));  // [B][3]
  const int tid = threadIdx.y * kTileK + threadIdx.x;
  for (int q = tid; q < 3 * nsrc; q += kThreads) s_pos[q] = p.srcpos[q];
  for (int q = tid; q < nsrc; q += kThreads) {
    s_nf[q] = p.nflux[q];
    if (kXray) s_nfx[q] = p.nfx[q];
  }
  for (int q = tid; q < K; q += kThreads) {
    s_a[q] = p.mix_a[q];
    s_w[q] = p.mix_w[q];
    if (kHeat) s_hw[q] = p.heat_w[q];
  }
  for (int q = tid; q < Kx; q += kThreads) {
    s_xa[q] = p.xmix_a[q];
    s_xw[q] = p.xmix_w[q];
    if (kHeat) s_xhw[q] = p.xheat_w[q];
  }
  __syncthreads();

  const int n = p.n, c = n / 2, pos_max = n - 1 - c;
  const size_t n3 = (size_t)n * n * n;
  const int kk = blockIdx.x * kTileK + threadIdx.x;
  const int jj = blockIdx.y * kTileJ + threadIdx.y;
  const bool valid = kk < n && jj < n;
  const int i = blockIdx.z, j = valid ? jj : 0, k = valid ? kk : 0;
  const size_t cell = ((size_t)i * n + j) * n + k;
  const float nd = valid ? p.ndhi[cell] : 1.f;
  // the LLS column of this cell (one read per cell) or the scalar one
  const float lcol = kLLS == 2 ? (valid ? p.lls[cell] : 0.f) : p.lcol;
  // the most column a cell can add (path <= sqrt(3)); rounding is
  // monotonic, so cd - col_hi > max_coldensh implies cin > max_coldensh
  const float col_hi = nd * (kSqrt3 * p.dr);
  const bool can_stop = nd >= 0.f;
  const int p_lim = min(p.max_shell, pos_max), q_lim = min(p.max_shell, c);
  const int warp = threadIdx.y, lane = threadIdx.x;
  float acc = 0.f, hacc = 0.f;

  for (int src = 0; src < nsrc; ++src) {
    const int oi = wrap1(i - s_pos[3 * src] + c, n) - c;
    const int oj = wrap1(j - s_pos[3 * src + 1] + c, n) - c;
    const int ok = wrap1(k - s_pos[3 * src + 2] + c, n) - c;
    const int cheb = max(max(abs(oi), abs(oj)), abs(ok));
    const float cd = valid
        ? __ldg(p.cdo + src * n3 + ((size_t)(oi + c) * n + (oj + c)) * n +
                (ok + c))
        : 0.f;
    const float fi = (float)oi, fj = (float)oj, fk = (float)ok;
    const float dist2 = fi * fi + fj * fj + fk * fk;
    // dead for sure: no geometry needed (the R_max barrier is exact here)
    bool live = valid && cheb <= p.max_shell && !(dist2 > p.rmax2) &&
                !(can_stop && cd - col_hi > p.max_coldensh);
    // geometry, exactly _rate_pass
    const bool is_src = cheb == 0;
    const float dom = (float)cheb;
    float path = 0.5f, cin = 0.f;
    if (live) {
      const float safe_d = fmaxf(dom, 1.f);
      const float t2 = dist2 - dom * dom;
      if (!is_src) path = sqrtf(t2 / (safe_d * safe_d) + 1.f);
      const float colcell = nd * (path * p.dr);
      cin = max0(cd - colcell);
      live = !(cin > p.max_coldensh);
    }

    float loss = 0.f, lls = 0.f;
    if (live) {
      float vol_ph = kFourPi * dist2 * path;
      if (is_src) vol_ph = 1.f;
      const float tau_in = cin * kSigma;
      const float dtau = (cd - cin) * kSigma;
      float tau_pre = 0.f, dtau_pre = 0.f;
      if (kTally) {
        const float cold_pre = max0(cin - lcol * path);
        tau_pre = cold_pre * kSigma;
        dtau_pre = (cin - cold_pre) * kSigma;
      }
      float phi_in, phi_cell, heat_acc, lls_acc;
      mixture<kTally, kHeat>(s_a, s_w, s_hw, K, tau_in, dtau, tau_pre,
                             dtau_pre, phi_in, phi_cell, heat_acc, lls_acc);
      const float nf = s_nf[src];
      phi_in = nf * phi_in;
      phi_cell = nf * phi_cell;
      float phi_out = phi_in - phi_cell;
      float photo_cell = phi_cell / vol_ph;
      float heat = 0.f, llsc = 0.f;
      if (kHeat) heat = (nf * heat_acc) / vol_ph;
      if (kTally) llsc = nf * lls_acc / vol_ph;
      if (kXray) {
        float xphi_in, xphi_cell, xheat_acc, xlls_acc;
        mixture<kTally, kHeat>(s_xa, s_xw, s_xhw, Kx, tau_in, dtau, tau_pre,
                               dtau_pre, xphi_in, xphi_cell, xheat_acc,
                               xlls_acc);
        const float nfx = s_nfx[src];
        xphi_in = nfx * xphi_in;
        xphi_cell = nfx * xphi_cell;
        phi_out = phi_out + (xphi_in - xphi_cell);
        photo_cell = photo_cell + xphi_cell / vol_ph;
        if (kHeat) heat = heat + (nfx * xheat_acc) / vol_ph;
        if (kTally) llsc = llsc + nfx * xlls_acc / vol_ph;
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
    float s = 0.f;
    for (int w = 0; w < kTileJ; ++w) s += red[q * kTileJ + w];
    p.partial[(size_t)q * nblocks + block] = s;
  }
}

// One block per (tally, source): a fixed-order sum of the block partials.
__global__ void consume_reduce(const float* partial, int nblocks,
                               float* loss) {
  __shared__ double buf[kThreads];
  const float* row = partial + (size_t)blockIdx.x * nblocks;
  double s = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) s += row[b];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[blockIdx.x] = (float)buf[0];
}

}  // namespace

extern "C" {

// Blocks of the cell launch at mesh n: the partials hold 2*B of these.
int c2r_consume_nblocks(int n) {
  const dim3 g = cell_grid(n);
  return (int)(g.x * g.y * g.z);
}

// partial: scratch of 2*B*c2r_consume_nblocks(n) floats.
// loss: (2, B) -> row 0 boundary losses, row 1 LLS losses.  use_lls: 0 LLS
// off, 1 the scalar column lcol, 2 the grid lls (n, n, n) (ignored, and may
// be null, otherwise).  With use_heat the heat build runs: heat_w (K,) in
// (and xheat_w (Kx,) with use_xray), phiheat (n, n, n) out; otherwise they
// are ignored.  With use_xray the X-ray mixture xmix_a, xmix_w (Kx,) runs
// under the fluxes nfx (B,); otherwise they are ignored.  rmax2: the
// squared R_max barrier in cells (+inf when LLS type 3 is off).  Returns
// the first CUDA error code, 0 on success.
int c2r_consume(const float* cdo, const float* ndhi, const float* lls,
                const int* srcpos, const float* nflux, const float* nfx,
                const float* mix_a, const float* mix_w, const float* heat_w,
                int K, const float* xmix_a, const float* xmix_w,
                const float* xheat_w, int Kx, int nsrc, int n, int max_shell,
                float dr, float rate_scale, float lcol, int use_lls,
                int use_heat, int use_xray, float rmax2, float max_coldensh,
                float* phih, float* phiheat, float* partial, float* loss,
                void* stream) {
  Consume p;
  p.cdo = cdo;
  p.ndhi = ndhi;
  p.lls = lls;
  p.srcpos = srcpos;
  p.nflux = nflux;
  p.nfx = nfx;
  p.mix_a = mix_a;
  p.mix_w = mix_w;
  p.heat_w = heat_w;
  p.xmix_a = xmix_a;
  p.xmix_w = xmix_w;
  p.xheat_w = xheat_w;
  p.phih = phih;
  p.phiheat = phiheat;
  p.partial = partial;
  p.K = K;
  p.Kx = Kx;
  p.nsrc = nsrc;
  p.n = n;
  p.max_shell = max_shell;
  p.dr = dr;
  p.rate_scale = rate_scale;
  p.lcol = lcol;
  p.rmax2 = rmax2;
  p.max_coldensh = max_coldensh;
  if (use_lls < 0 || use_lls > 2) return (int)cudaErrorInvalidValue;
  const size_t smem =
      consume_smem_floats(nsrc, K, Kx, use_heat != 0, use_xray != 0) *
          sizeof(float) + (size_t)3 * nsrc * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = cell_grid(n), block(kTileK, kTileJ);
  // the instance of (LLS mode, heat, X-ray)
  const int v = use_lls * 4 + (use_heat ? 2 : 0) + (use_xray ? 1 : 0);
  switch (v) {
#define C2R_CONSUME_CASE(L, H, X)                                          \
    case L * 4 + H * 2 + X:                                                \
      consume_cells<L, H != 0, X != 0><<<grid, block, smem, st>>>(p);      \
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
