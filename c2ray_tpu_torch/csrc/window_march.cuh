// The window march's per-cell device code, shared by the kernels that
// march source-centred windows: K3 (march.cu's window mode, both forms)
// and the fused window sweep (window_sweep.cu).  One definition, so a face
// plane cell's column is computed with the same operations in the same
// order in every kernel, bitwise equal to the plain PyTorch version
// (ops/sweep.march_windows; built with --fmad=false).  See march.cu for
// the march's design.

#pragma once

#include <stddef.h>

#include "real.cuh"

namespace {

struct WindowShell {
  const real* wins;     // (B, n, n, n) per-source centred cubes (n = p)
  const real* lwins;    // (B, n, n, n) their LLS windows (kGridLLS)
  const real* prev;     // (B, 6, n, n) planes of shell d-1 (unused at d=1)
  real* cur;            // (B, 6, n, n) planes of shell d
  real* out;            // (B, n, n, n) centred coldensh_out
  int n, c, d;
  real dr, lcol;
  int use_lls;     // 0: LLS off, 1: the scalar lcol, 2: the LLS windows
};

__device__ __forceinline__ int wrapn(int x, int n) {
  int r = x % n;
  return r < 0 ? r + n : r;
}

// Unfixed value of face f at plane cell (a, b) of shell d (see march.cu's
// grid_value), its corners read from pf, the face's plane of shell d-1
// (in device memory or in shared memory); with kGridLLS the cell's LLS
// column from lc3, this window's LLS cube, at the density's index.
template <bool kGridLLS>
__device__ __forceinline__ real window_cell(const WindowShell& s,
                                             const real* pf,
                                             const real* nd3,
                                             const real* lc3, int f, int a,
                                             int b, real cdo0) {
  const int n = s.n, c = s.c, d = s.d;
  const int ta = a - c, tb = b - c;
  const int am = ta >= 0 ? a - 1 : a + 1;      // corner toward the source
  const int bm = tb >= 0 ? b - 1 : b + 1;
  real c1, c2, c3, c4;
  if (d == 1) {
    c4 = (a == c && b == c) ? cdo0 : rl(0.);
    c3 = (am == c && b == c) ? cdo0 : rl(0.);
    c2 = (a == c && bm == c) ? cdo0 : rl(0.);
    c1 = (am == c && bm == c) ? cdo0 : rl(0.);
  } else {
    c4 = pf[(size_t)a * n + b];
    c3 = pf[(size_t)am * n + b];
    c2 = pf[(size_t)a * n + bm];
    c1 = pf[(size_t)am * n + bm];
  }
  const real df = (real)d;
  const real inv_d = rl(1.0) / df;
  const real fta = (real)ta, ftb = (real)tb;
  const real fa = r_min(r_max((df - r_abs(fta)) * inv_d, rl(0.)), rl(1.));
  const real fb = r_min(r_max((df - r_abs(ftb)) * inv_d, rl(0.)), rl(1.));
  const real s1 = (rl(1.) - fa) * (rl(1.) - fb);
  const real s2 = fa * (rl(1.) - fb);
  const real s3 = (rl(1.) - fa) * fb;
  const real s4 = fa * fb;
  const real w1 = s1 * (rl(1.0) / r_max(c1 * kSigma, rl(0.6)));
  const real w2 = s2 * (rl(1.0) / r_max(c2 * kSigma, rl(0.6)));
  const real w3 = s3 * (rl(1.0) / r_max(c3 * kSigma, rl(0.6)));
  const real w4 = s4 * (rl(1.0) / r_max(c4 * kSigma, rl(0.6)));
  real cdensi = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) /
                 (w1 + w2 + w3 + w4);
  if (d == 1) {
    const bool a1 = ta == 1 || ta == -1, b1 = tb == 1 || tb == -1;
    cdensi = cdensi * ((a1 && b1) ? kSqrt3 : ((a1 || b1) ? kSqrt2 : rl(1.)));
  }
  const real path = r_sqrt((fta * fta + ftb * ftb) * (inv_d * inv_d) + rl(1.));
  // the cube cell of this face plane (the source is at the centre, so the
  // plane cell is the cube cell)
  const int row = wrapn(c + ((f & 1) ? -d : d), n);
  size_t at;
  if (f < 2) {            // z faces: plane (x, y), read strided
    at = ((size_t)a * n + b) * n + row;
  } else if (f < 4) {     // y faces: plane (x, z)
    at = ((size_t)a * n + row) * n + b;
  } else {                // x faces: plane (y, z)
    at = ((size_t)row * n + a) * n + b;
  }
  real cin = cdensi;
  if (kGridLLS) cin = cin + lc3[at] * path;
  else if (s.use_lls) cin = cin + s.lcol * path;
  return cin + nd3[at] * (path * s.dr);
}


// Whether face f's value at plane cell (a, b) of shell d is that cube
// cell's final column (face_ownership_masks): z faces own their whole
// live square, y faces the cells with |b - c| < d, x faces those with
// |a - c| < d and |b - c| < d.  No owned cell is a wedge-fixup cell.
__device__ __forceinline__ bool window_owned(int f, int a, int b, int c,
                                             int d) {
  const int ata = abs(a - c), atb = abs(b - c);
  return f < 2 ? true : f < 4 ? atb < d : (ata < d && atb < d);
}

// The cluster form's wedge fixups of face f at shell d, in face-priority
// order z > y > x (the cells and values of march_window_shell's switch),
// from the siblings' shell-d planes pz, mz, py, my (distributed shared
// memory; shell d's plane at offset (d & 1) * n * n): y faces take their
// columns b = c+d and M = c-d from z; x faces the same from z, then their
// rows a = c+d and M (off those columns) from y.  Threads tid of nt split
// the square's lo..hi.  No fixup reads a cell that a fixup writes.
__device__ __forceinline__ void window_fixups(
    real* cur, const real* pz, const real* mz, const real* py,
    const real* my, int f, int n, int c, int d, int lo, int hi, int tid,
    int nt) {
  if (f < 2) return;
  const bool hp = c + d < n;
  const int P = hp ? c + d : c + d - n, M = c - d;
  const int k = (d & 1) * n * n;
  for (int t = lo + tid; t <= hi; t += nt) {
    if (f == 2) {
      if (hp) cur[t * n + P] = pz[k + t * n + P];
      cur[t * n + M] = mz[k + t * n + P];
    } else if (f == 3) {
      if (hp) cur[t * n + P] = pz[k + t * n + M];
      cur[t * n + M] = mz[k + t * n + M];
    } else {
      const int r = f == 4 ? P : M;
      if (hp) cur[t * n + P] = pz[k + r * n + t];
      cur[t * n + M] = mz[k + r * n + t];
      if (!((hp && t == P) || t == M)) {
        if (hp) cur[P * n + t] = py[k + r * n + t];
        cur[M * n + t] = my[k + r * n + t];
      }
    }
  }
}

}  // namespace
