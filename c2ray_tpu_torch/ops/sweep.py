"""Causal wavefront ray sweep, PyTorch port of c2ray_tpu/ops/sweep.py
(the full-cube sweep, full-radius or radius-capped, and the windowed
many-source sweep).

The reference's per-source short-characteristics ray trace
(evolve_source.F90 + evolve_point.F90:83-299 + column_density.f90:29-293)
becomes a Chebyshev-shell wavefront: cells at Chebyshev distance d from
the source depend only on cells at distance < d, so shell d is one
parallel step.  A shell's surface is six faces (dominant axis +/-, with
the reference's z >= y >= x tie-breaking); each face is an (N,N) plane in
the source-centred frame whose four interpolation corners are shifted
copies of the previous shell's plane.  Only the column densities are
causal: the rates come afterwards in one vectorized pass (_rate_pass).

This module holds the plain torch versions.  The march here reads its
face planes straight from the grid-frame neutral-density cube at rows
(s_ax +- d) mod N (march_columns) or from per-source centred windows at
rows c +- d (march_windows) - the same reads as the Pallas marches
(sweep_pallas.compute_columns_pallas_grid / compute_columns_pallas) and
the CUDA kernel (ops/sweep_cuda.py) - and where the JAX code builds
mirrored or transposed copies of a plane to apply the wedge fixups, it
indexes the one row or column it needs.

Units (float32-safe): photon rates in S_star photons/s, geometry in cell
units; rate_scale = S_star/dr^3 converts to physical per-atom rates.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as const
from ..config import RunConfig
from .launches import mark
from .tables import RadTables, photoion_rates, photoion_rates_lls_fused

SQRT2 = float(np.sqrt(2.0))
SQRT3 = float(np.sqrt(3.0))
FOURPI = 4.0 * np.pi

# The 6 shell faces: (dominant axis, sign, bound_sub_a, bound_sub_b), in
# the order [z+, z-, y+, y-, x+, x-].  Transverse plane dims: z faces
# (x, y), y faces (x, z), x faces (y, z).
_FACES = (
    (2, +1, 0, 0), (2, -1, 0, 0),
    (1, +1, 0, 1), (1, -1, 0, 1),
    (0, +1, 1, 1), (0, -1, 1, 1),
)

# kernel batch cap: the consume kernel keeps 2 * 8 warp partials per
# source in shared memory
MAX_BATCH = 256


class SweepScalars(NamedTuple):
    """Per-step scalars as Python floats, rounded to the working dtype
    (the JAX twin carries them as 0-d device arrays of that dtype).  The
    device loop's captured graph holds them as one-element float64
    tensors on the card instead, which the kernels read at launch
    (sweep_cuda.step_scalar) and the plain ops take as operands."""

    dr: float            # proper cell size [cm]
    rate_scale: float    # S_star / dr^3
    lls_coldens: float   # LLS column density per cell [cm^-2] (type 1)
    rmax2_cells: float   # squared LLS type-3 barrier radius [cells]


def sweep_scalars(cfg: RunConfig, dr_proper: float, lls_coldens: float = 0.0,
                  rmax_cells: float = 0.0) -> SweepScalars:
    """The scalars as Evolve3D.evolve3d builds them, each rounded once to
    cfg's dtype."""
    cast = cfg.np_dtype
    vol = float(dr_proper) ** 3
    return SweepScalars(float(cast(dr_proper)),
                        float(cast(cfg.sed.s_star / vol)),
                        float(cast(lls_coldens)),
                        float(cast(rmax_cells * rmax_cells)))


class SweepResult(NamedTuple):
    phih: torch.Tensor          # per-neutral-atom photoionization rate [1/s]
    phiheat: torch.Tensor       # photo-heating rate (0-d zero: isothermal)
    photon_loss: torch.Tensor   # photons/s escaping the traced region
    lls_loss: torch.Tensor      # photons/s absorbed by LLS fog
    coldensh_out: torch.Tensor  # outgoing column densities


def roll3(a: torch.Tensor, shifts) -> torch.Tensor:
    """Periodic roll of a 3D field by per-axis integer shifts."""
    return torch.roll(a, shifts=tuple(int(s) for s in shifts), dims=(0, 1, 2))


def neutral_density(cfg: RunConfig, ndens: torch.Tensor,
                    xh_av1: torch.Tensor) -> torch.Tensor:
    """ndhi = max(1 - max(x_av, eps), eps) * n, the epsilon-clamped
    time-averaged neutral density (evolve_point.F90:137-142).  Under
    compressed storage xh_av1 is the signed min-fraction form and the
    neutral side decodes tail-exactly."""
    eps = cfg.epsilon
    if cfg.compressed_xfrac:
        xh0 = torch.where(xh_av1 >= 0,
                          1.0 - torch.clamp(xh_av1, min=eps), -xh_av1)
        return torch.clamp(xh0, min=eps) * ndens
    return torch.clamp(1.0 - torch.clamp(xh_av1, min=eps), min=eps) * ndens


def face_ownership_masks(n: int, c: int):
    """Cell ownership of the shell cube's surface in _FACES order with
    z > y > x priority (column_density.f90's octant wedge rules as a
    disjoint partition), as (n,n,n) numpy masks in the centred frame."""
    o = np.arange(n) - c
    oi = o[:, None, None]
    oj = o[None, :, None]
    ok = o[None, None, :]
    ai, aj, ak = abs(oi), abs(oj), abs(ok)
    return [
        (ok > 0) & (ok >= ai) & (ok >= aj),
        (ok < 0) & (-ok >= ai) & (-ok >= aj),
        (oj > 0) & (oj >= ai) & (oj > ak),
        (oj < 0) & (-oj >= ai) & (-oj > ak),
        (oi > 0) & (oi > aj) & (oi > ak),
        (oi < 0) & (-oi > aj) & (-oi > ak),
    ]


def _wavefront_plane_update(prev: torch.Tensor, ndhi_p: torch.Tensor, lcol,
                            d: int, cfg: RunConfig, dr: float,
                            n: int) -> torch.Tensor:
    """Shell d's six face planes (..., 6, N, N) from the previous shell's,
    wedge-fixed so each face's plane is valid on its full |t| <= d read
    extent (c2ray_tpu.ops.sweep._wavefront_plane_update).

    The wedge fixups copy shell-cube edge cells, which the higher-priority
    face owns, into the other faces' planes: single rows and columns of
    the sibling planes of the same shell, indexed directly.  The "+d" row
    index wraps mod n, as the reference's mirror permutation does (seen
    only at d = c for even n).
    """
    c = n // 2
    dtype, dev = prev.dtype, prev.device
    sigma = const.SIGMA_HI_AT_ION_FREQ
    df = torch.tensor(float(d), dtype=dtype)
    inv_d = 1.0 / df

    it = torch.arange(n, device=dev) - c
    ta = it.to(dtype)[:, None]
    tb = it.to(dtype)[None, :]
    pos_a = (it >= 0)[:, None]
    pos_b = (it >= 0)[None, :]

    def shift_toward_source(x, dim, pos_mask):
        up = torch.roll(x, 1, dims=dim)
        dn = torch.roll(x, -1, dims=dim)
        return torch.where(pos_mask, up, dn)

    c4 = prev
    c3 = shift_toward_source(prev, -2, pos_a)
    c2 = shift_toward_source(prev, -1, pos_b)
    c1 = shift_toward_source(c3, -1, pos_b)

    f_a = torch.clamp((df - torch.abs(ta)) * inv_d, 0.0, 1.0)
    f_b = torch.clamp((df - torch.abs(tb)) * inv_d, 0.0, 1.0)
    s1 = (1.0 - f_a) * (1.0 - f_b)
    s2 = f_a * (1.0 - f_b)
    s3 = (1.0 - f_a) * f_b
    s4 = f_a * f_b

    def wf(cd):
        """weightf = 1/max(0.6, cd*sigma). column_density.f90:276-293."""
        return 1.0 / torch.clamp(cd * sigma, min=0.6)

    w1 = s1 * wf(c1)
    w2 = s2 * wf(c2)
    w3 = s3 * wf(c3)
    w4 = s4 * wf(c4)
    cdensi = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) / (w1 + w2 + w3 + w4)

    if d == 1:
        # diagonal corrections on shell 1 (column_density.f90:152-158)
        one = np.abs(np.arange(n) - c) == 1
        a1, b1 = one[:, None], one[None, :]
        diag = np.where(a1 & b1, SQRT3, np.where(a1 | b1, SQRT2, 1.0))
        cdensi = cdensi * torch.as_tensor(diag, dtype=dtype, device=dev)

    path = torch.sqrt((ta * ta + tb * tb) * (inv_d * inv_d) + 1.0)
    coldensh_in = cdensi
    if cfg.use_lls and cfg.type_of_lls in (1, 2):
        coldensh_in = coldensh_in + lcol * path
    newp = coldensh_in + ndhi_p * (path * dr)

    # ---- wedge fixups (edge cells owned by the higher-priority face) ----
    hp = c + d < n        # the |t| = +d row/column lies inside the plane
    p = (c + d) % n       # wrapped "+d" index
    m = c - d
    pz, mz = newp[..., 0, :, :], newp[..., 1, :, :]
    py = newp[..., 2, :, :].clone()
    my = newp[..., 3, :, :].clone()
    px = newp[..., 4, :, :].clone()
    mx = newp[..., 5, :, :].clone()
    # y planes: their |oz| = d columns are z-plane cells
    py[..., :, m] = mz[..., :, p]
    my[..., :, m] = mz[..., :, m]
    if hp:
        py[..., :, c + d] = pz[..., :, c + d]
        my[..., :, c + d] = pz[..., :, m]
    # x planes: |oy| = d rows from the fixed y planes ...
    px[..., m, :] = my[..., p, :]
    mx[..., m, :] = my[..., m, :]
    if hp:
        px[..., c + d, :] = py[..., p, :]
        mx[..., c + d, :] = py[..., m, :]
    # ... then |oz| = d columns from the transposed z planes (z has top
    # priority, so these overwrite the cube corners)
    px[..., :, m] = mz[..., p, :]
    mx[..., :, m] = mz[..., m, :]
    if hp:
        px[..., :, c + d] = pz[..., p, :]
        mx[..., :, c + d] = pz[..., m, :]
    return torch.stack([pz, mz, py, my, px, mx], dim=-3)


def _commit_shell(out: torch.Tensor, planes: torch.Tensor, d: int,
                  n: int) -> None:
    """Write shell d's owned cells of the (B, 6, N, N) planes into the
    centred (B, N, N, N) cube in place (the per-shell form of the JAX
    _unstage_faces; ownership as face_ownership_masks)."""
    c = n // 2
    pos_max = n - 1 - c
    it = torch.abs(torch.arange(n, device=out.device) - c)
    le_a = (it <= d)[:, None]
    le_b = (it <= d)[None, :]
    lt_a = (it < d)[:, None]
    lt_b = (it < d)[None, :]
    own = (le_a & le_b, le_a & lt_b, lt_a & lt_b)
    for f, (ax, s, _, _) in enumerate(_FACES):
        if s > 0 and d > pos_max:
            continue
        row = c + s * d
        idx = [slice(None)] * 4
        idx[1 + ax] = row
        idx = tuple(idx)
        out[idx] = torch.where(own[f // 2], planes[:, f], out[idx])


def _march(cfg: RunConfig, face_planes, cdo0: torch.Tensor, n: int,
           sc: SweepScalars, max_shell: int,
           lls_planes=None) -> torch.Tensor:
    """Shells 1..min(max_shell, N/2) of the march from the per-shell face
    planes face_planes(d) -> (B, 6, N, N); cells beyond the last shell
    stay zero.  lls_planes(d), where given, are the per-cell LLS columns
    of the same face planes (grid LLS); else each cell adds the scalar
    sc.lls_coldens."""
    c = n // 2
    b = cdo0.shape[0]
    prev = torch.zeros((b, 6, n, n), dtype=cdo0.dtype, device=cdo0.device)
    prev[:, :, c, c] = cdo0[:, None]
    out = torch.zeros((b, n, n, n), dtype=cdo0.dtype, device=cdo0.device)
    for d in range(1, min(max_shell, c) + 1):
        lcol = lls_planes(d) if lls_planes is not None else sc.lls_coldens
        prev = _wavefront_plane_update(prev, face_planes(d), lcol, d, cfg,
                                       sc.dr, n)
        _commit_shell(out, prev, d, n)
    out[:, c, c, c] = cdo0
    return out


def march_columns(cfg: RunConfig, ndhi: torch.Tensor,
                  srcpos_b: torch.Tensor, sc: SweepScalars,
                  max_shell: int,
                  lls: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column march for a batch of sources from the SHARED grid-frame
    neutral density: (N,N,N) + (B,3) -> (B,N,N,N) source-centred
    coldensh_out (the layout of the JAX compute_columns_pallas_grid).

    Face f's plane at shell d is the grid plane at row (s_ax + sign*d)
    mod N, re-centred on the source in its two transverse axes.  A grid
    LLS cube lls (N,N,N) is read through the same planes
    (LLS.F90:199-210)."""
    n = ndhi.shape[0]
    c = n // 2
    dev = ndhi.device
    pos = srcpos_b.to(device=dev, dtype=torch.int64)
    ar = torch.arange(n, device=dev)
    g = [(ar[None, :] + pos[:, ax, None] - c) % n for ax in range(3)]

    def planes_of(cube):
        def face_planes(d):
            planes = []
            for ax, s, _, _ in _FACES:
                row = ((pos[:, ax] + s * d) % n)[:, None, None]
                if ax == 2:
                    planes.append(cube[g[0][:, :, None], g[1][:, None, :],
                                       row])
                elif ax == 1:
                    planes.append(cube[g[0][:, :, None], row,
                                       g[2][:, None, :]])
                else:
                    planes.append(cube[row, g[1][:, :, None],
                                       g[2][:, None, :]])
            return torch.stack(planes, dim=1)
        return face_planes

    cdo0 = ndhi[pos[:, 0], pos[:, 1], pos[:, 2]] * (0.5 * sc.dr)
    return _march(cfg, planes_of(ndhi), cdo0, n, sc, max_shell,
                  planes_of(lls) if lls is not None else None)


def march_windows(cfg: RunConfig, wins: torch.Tensor, sc: SweepScalars,
                  max_shell: int,
                  lls_wins: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column march on a batch of source-centred cubes: (B,p,p,p) ->
    (B,p,p,p) coldensh_out (the JAX compute_columns_pallas on windows, or
    the vmapped compute_columns_facemajor).  Face f's plane at shell d is
    the cube's plane at row c + sign*d (mod p, which wraps only for even p
    at d = p/2); the grid LLS windows lls_wins (B,p,p,p), where given,
    through the same planes."""
    n = wins.shape[-1]
    c = n // 2

    def planes_of(cube):
        def face_planes(d):
            hi, lo = (c + d) % n, c - d
            return torch.stack([cube[:, :, :, hi], cube[:, :, :, lo],
                                cube[:, :, hi, :], cube[:, :, lo, :],
                                cube[:, hi, :, :], cube[:, lo, :, :]], dim=1)
        return face_planes

    cdo0 = wins[:, c, c, c] * (0.5 * sc.dr)
    return _march(cfg, planes_of(wins), cdo0, n, sc, max_shell,
                  planes_of(lls_wins) if lls_wins is not None else None)


def compute_columns_facemajor(cfg: RunConfig, ndhi_c: torch.Tensor,
                              sc: SweepScalars, lls_c: Optional[torch.Tensor],
                              max_shell: int) -> torch.Tensor:
    """coldensh_out of one source on its centred cube (the JAX
    compute_columns_facemajor): the march with the source at the centre,
    with the centred grid LLS cube lls_c where given."""
    return march_windows(cfg, ndhi_c[None], sc, max_shell,
                         lls_c[None] if lls_c is not None else None)[0]


def _rate_pass(cfg: RunConfig, tables: RadTables, cdo: torch.Tensor,
               ndhi_c: torch.Tensor, nflux, sc: SweepScalars, lls_c,
               max_shell: int, nflux_xray=None,
               row_ci: Optional[torch.Tensor] = None) -> SweepResult:
    """Vectorized rate deposition from the completed column-density field
    of one source, all fields centred on it (evolve_point.F90:151-295):
    coldensh_in = coldensh_out - cell column, shell-volume dilution, the
    max_coldensh / R_max stops, photon-conserving rates, per-atom rates,
    and the boundary and LLS photon-loss tallies.  nflux_xray, where
    given and cfg.sed.use_xray_sed, adds the X-ray sources' power-law
    photons (radiation_photoionrates.F90:126-174).

    The fields may carry leading batch dimensions (a batch of windows, as
    the JAX windowed_batch vmaps this function); nflux (and nflux_xray)
    then broadcast against them, e.g. as (B, 1, 1, 1), and the losses
    come back per window.

    row_ci: (m,) centred-frame indices of axis 0's rows, for a grid slab
    (the domain layouts, parallel/domain.py): the fields then carry m
    rows whose centred identity is row_ci (slab_rows).  None: all n."""
    n = cdo.shape[-1]
    c = n // 2
    pos_max = n - 1 - c
    dtype, dev = cdo.dtype, cdo.device

    o = torch.arange(n, device=dev) - c
    oi = (o[:, None, None] if row_ci is None
          else (row_ci.to(device=dev, dtype=o.dtype) - c)[:, None, None])
    oj = o[None, :, None]
    ok = o[None, None, :]
    cheb = torch.maximum(torch.maximum(oi.abs(), oj.abs()), ok.abs())
    is_src = cheb == 0

    dom = cheb.to(dtype)
    safe_d = torch.clamp(dom, min=1.0)
    fi, fj, fk = oi.to(dtype), oj.to(dtype), ok.to(dtype)
    dist2 = fi * fi + fj * fj + fk * fk
    t2 = dist2 - dom * dom
    path = torch.sqrt(t2 / (safe_d * safe_d) + 1.0)
    path = torch.where(is_src, 0.5, path)           # evolve_point.F90:155
    vol_ph = FOURPI * dist2 * path
    vol_ph = torch.where(is_src, 1.0, vol_ph)       # evolve_point.F90:160

    colcell = ndhi_c * (path * sc.dr)
    coldensh_in = torch.clamp(cdo - colcell, min=0.0)

    active = cheb <= max_shell
    stop = coldensh_in > cfg.max_coldensh           # evolve_point.F90:201
    if cfg.use_lls and cfg.type_of_lls == 3:
        stop = stop | (dist2 > sc.rmax2_cells)      # evolve_point.F90:191

    lls_cell = None
    if cfg.use_lls and cfg.type_of_lls in (1, 2):
        # photons absorbed by the LLS fog: the spectral gap between the
        # pre-LLS and post-LLS incoming columns (see the JAX twin)
        lcol = lls_c if lls_c is not None else sc.lls_coldens
        cold_pre = torch.clamp(coldensh_in - lcol * path, min=0.0)
        phi, lls_cell = photoion_rates_lls_fused(
            cfg, tables, coldensh_in, cdo, vol_ph, nflux, cold_pre,
            nflux_xray)
    else:
        phi = photoion_rates(cfg, tables, coldensh_in, cdo, vol_ph, nflux,
                             nflux_xray)
    live = active & ~stop
    gamma = torch.where(live, phi.photo_cell * sc.rate_scale / ndhi_c, 0.0)
    heat = (torch.where(live, phi.heat, 0.0) * sc.rate_scale
            if not cfg.isothermal
            else torch.zeros((), dtype=dtype, device=dev))

    # boundary-of-trace loss (evolve_point.F90:290-295)
    p_lim = min(max_shell, pos_max)
    q_lim = min(max_shell, c)
    bnd = ((oi == p_lim) | (oi == -q_lim) | (oj == p_lim) | (oj == -q_lim)
           | (ok == p_lim) | (ok == -q_lim))
    cells = (-3, -2, -1)
    loss = torch.sum(torch.where(live & bnd, phi.photo_out / vol_ph, 0.0),
                     dim=cells)

    lls_loss = torch.zeros(loss.shape, dtype=dtype, device=dev)
    if lls_cell is not None:
        lls_loss = torch.sum(torch.where(live, lls_cell, 0.0), dim=cells)
    return SweepResult(gamma, heat, loss, lls_loss, cdo)


def sweep_single_source(cfg: RunConfig, tables: RadTables,
                        ndhi_c: torch.Tensor, nflux, sc: SweepScalars,
                        lls_c: Optional[torch.Tensor] = None,
                        max_shell: Optional[int] = None,
                        nflux_xray=None) -> SweepResult:
    """Ray-trace one source over its source-centred grid (do_source,
    evolve_source.F90:58-221): the wavefront to max_shell, then the rate
    deposition and loss tallies."""
    n = cfg.mesh[0]
    c = n // 2
    if max_shell is None:
        max_shell = cfg.max_shell if cfg.max_shell is not None else c
    max_shell = min(max_shell, min(c, cfg.max_subbox))
    cdo = compute_columns_facemajor(cfg, ndhi_c, sc, lls_c, max_shell)
    return _rate_pass(cfg, tables, cdo, ndhi_c, nflux, sc, lls_c, max_shell,
                      nflux_xray=nflux_xray)


def wrap_pad(field: torch.Tensor, radius: int) -> torch.Tensor:
    """The r-wide periodic pad of an (N,N,N) field, (N+2r)^3."""
    n = field.shape[0]
    idx = (torch.arange(n + 2 * radius, device=field.device) - radius) % n
    return field[idx][:, idx][:, :, idx]


def windowed_prepass(cfg: RunConfig, ndens: torch.Tensor,
                     xh_av1: torch.Tensor, radius: int) -> torch.Tensor:
    """The neutral density and its r-wide periodic pad, (N+2r)^3: the
    window of half-width r around grid cell q is then the (2r+1)^3 block
    of the padded field with corner q (the JAX windowed_prepass, without
    the TPU lane margins).  A grid LLS cube takes the same pad, with
    wrap_pad (the JAX prepass returns both)."""
    return wrap_pad(neutral_density(cfg, ndens, xh_av1), radius)


def check_window_positions(srcpos: np.ndarray, n: int) -> None:
    """Window corners are the source cells themselves, so every position
    must lie in [0, n): the gather and the scatter-add index the padded
    field without a wrap."""
    srcpos = np.asarray(srcpos)
    if srcpos.size and (srcpos.min() < 0 or srcpos.max() >= n):
        raise ValueError(f"source positions must lie in [0, {n}) for "
                         "windowed sweeps")


def windowed_batch(cfg: RunConfig, tables: RadTables, ndhi_pad: torch.Tensor,
                   pos: torch.Tensor, nf: torch.Tensor, sc: SweepScalars,
                   radius: int, acc_pad: torch.Tensor,
                   heat_pad: Optional[torch.Tensor] = None,
                   lls_pad: Optional[torch.Tensor] = None,
                   nfx: Optional[torch.Tensor] = None):
    """Sweep one batch of (2r+1)^3 windows and scatter-add their rates
    into the padded accumulator, in place (the JAX windowed_batch on its
    block-DMA path).  Gather (K4), the window sweep (sweep_cuda.
    window_sweep: the march and the rate pass on the window's own (p,p,p)
    mesh in one launch) and scatter-add (K5) are the kernels on a CUDA
    device, their plain versions on the CPU; where the window sweep does
    not fit (sweep_cuda.window_sweep_fits: larger windows, float64 at r =
    64) the march (K3) and the rate pass (K2w, sweep_cuda.window_rates)
    run one after the other, with the same phih bits.  A non-isothermal
    cfg also scatter-adds the heating rates into heat_pad (a second K5
    call), which it requires.  With a padded grid LLS field lls_pad (the
    wrap_pad of the LLS cube) a second K4 call gathers its windows, which
    the march and the rate pass read; nfx, the X-ray fluxes, go to the
    rate pass.

    pos: (B, 3) int32 grid cells in [0, n); nf, nfx: (B,) fluxes (zero
    entries pad a partial batch and add exactly zero).
    Returns (photon_loss_sum, lls_loss_sum, per_window_loss)."""
    from .sweep_cuda import (compute_columns_windows, window_rates,
                             window_sweep, window_sweep_fits)
    from .window_cuda import window_gather, window_scatter_add

    if not cfg.isothermal and heat_pad is None:
        raise ValueError("a non-isothermal windowed batch needs heat_pad")
    r = int(radius)
    p = 2 * r + 1
    cfgw = cfg.replace(mesh=(p, p, p))
    wins = window_gather(ndhi_pad, pos, r)
    lwins = window_gather(lls_pad, pos, r) if lls_pad is not None else None
    if window_sweep_fits(cfgw, tables, wins, lwins, nfx):
        res = window_sweep(cfgw, tables, wins, nf, sc, r, lls_wins=lwins,
                           nfx=nfx)
    else:
        cdo = compute_columns_windows(cfgw, wins, sc, r, lls_wins=lwins)
        res = window_rates(cfgw, tables, cdo, wins, nf, sc, r,
                           lls_wins=lwins, nfx=nfx)
        del cdo
    window_scatter_add(acc_pad, res.phih, pos)
    if not cfg.isothermal:
        window_scatter_add(heat_pad, res.phiheat, pos)
    return res.loss_sum, res.lls_loss_sum, res.loss


def _pad_batch(srcpos: torch.Tensor, nflux: torch.Tensor, b: int,
               nflux_xray: Optional[torch.Tensor] = None):
    """Pad the source arrays (and the X-ray fluxes, where given) with
    zero-flux sources at cell 0 to a whole number of batches of b."""
    s = int(srcpos.shape[0])
    pad = -(-s // b) * b - s
    if pad:
        srcpos = torch.cat([srcpos, srcpos.new_zeros((pad, 3))])
        nflux = torch.cat([nflux, nflux.new_zeros((pad,))])
        if nflux_xray is not None:
            nflux_xray = torch.cat([nflux_xray, nflux_xray.new_zeros((pad,))])
    return srcpos, nflux, nflux_xray


def raytrace_windowed(cfg: RunConfig, tables: RadTables,
                      ndens: torch.Tensor, xh_av1: torch.Tensor,
                      srcpos: torch.Tensor, nflux: torch.Tensor,
                      sc: SweepScalars, radius: int = 8,
                      lls_grid: Optional[torch.Tensor] = None,
                      nflux_xray: Optional[torch.Tensor] = None):
    """Windowed multi-source sweep, O(r^3) per source (the JAX
    raytrace_windowed): each source is swept inside its (2r+1)^3 window
    of the periodically padded neutral density, in batches of
    cfg.source_batch windows; the rates scatter-add into one padded
    accumulator whose r-wide ring folds back mod N once per call.  The
    window boundary is the max_shell boundary, so the escaping-photon
    tally is the reference's subbox-face loss (evolve_point.F90:290-295).
    A grid LLS cube lls_grid takes the same pad and its own gather; the
    X-ray fluxes nflux_xray pad with zeros as the fluxes do.

    Requires 2*radius+1 <= N.  Returns (phih, phiheat, photon_loss,
    lls_loss, per_source_loss) as device tensors, without a host sync."""
    from .window_cuda import fold_padded_acc, padded_acc_shape

    n = cfg.mesh[0]
    r = int(radius)
    if 2 * r + 1 > n:
        raise ValueError(f"window of radius {r} does not fit in {n}^3")
    dtype, dev = ndens.dtype, ndens.device
    ndhi_pad = windowed_prepass(cfg, ndens, xh_av1, r)
    lls_pad = (wrap_pad(lls_grid.to(device=dev, dtype=dtype), r)
               if lls_grid is not None else None)
    s = int(srcpos.shape[0])
    b = max(1, min(cfg.source_batch, s))
    srcpos, nflux, nfx = _pad_batch(
        srcpos.to(device=dev, dtype=torch.int32),
        nflux.to(device=dev, dtype=dtype), b,
        nflux_xray.to(device=dev, dtype=dtype)
        if nflux_xray is not None else None)
    acc = torch.zeros(padded_acc_shape(n, r), dtype=dtype, device=dev)
    hacc = (torch.zeros(padded_acc_shape(n, r), dtype=dtype, device=dev)
            if not cfg.isothermal else None)
    loss = torch.zeros((), dtype=dtype, device=dev)
    lls_loss = torch.zeros((), dtype=dtype, device=dev)
    per_src = []
    for i in range(0, srcpos.shape[0], b):
        lo, ll, per_win = windowed_batch(
            cfg, tables, ndhi_pad, srcpos[i:i + b], nflux[i:i + b], sc, r,
            acc, hacc, lls_pad=lls_pad,
            nfx=nfx[i:i + b] if nfx is not None else None)
        loss = loss + lo
        lls_loss = lls_loss + ll
        per_src.append(per_win)
    heat = (fold_padded_acc(hacc, n, r) if hacc is not None
            else torch.zeros((), dtype=dtype, device=dev))
    return (fold_padded_acc(acc, n, r), heat, loss, lls_loss,
            torch.cat(per_src)[:s])


def slab_rows(n: int, m: int, x0: int, src_x: int) -> torch.Tensor:
    """Centred-frame row indices of grid slab [x0, x0+m) for a source at
    grid row src_x (the JAX slab_rows)."""
    return (x0 + n // 2 - src_x + torch.arange(m)) % n


def _slab_rate_pass(cfg: RunConfig, tables: RadTables, cdo: torch.Tensor,
                    ndhi: torch.Tensor, lls: Optional[torch.Tensor],
                    pos: torch.Tensor, nflux: torch.Tensor, sc: SweepScalars,
                    d_sweep: int, slab, nfx: Optional[torch.Tensor]):
    """The rate pass of a batch of sources on grid rows [x0, x0+m) only,
    one source at a time in plain torch (the JAX slab path takes the XLA
    rate pass, not the consume kernel, sweep.py:1159): each source's
    centred column cube cdo[i] is cut to the slab's rows, the grid-frame
    fields to the slab and centred on axes 1 and 2.  -> (phih, phiheat)
    summed over the batch in grid order on axes 1, 2 (m rows), and the
    (B,) boundary and LLS losses."""
    n = cdo.shape[-1]
    c = n // 2
    x0, m = slab
    rows = torch.arange(x0, x0 + m, device=ndhi.device)
    phih = heat = None
    losses, lls_losses = [], []
    for i, (px, py, pz) in enumerate(pos.tolist()):
        row_ci = slab_rows(n, m, x0, px).to(cdo.device)
        sh = (c - py, c - pz)
        nd_c = torch.roll(ndhi[rows], sh, dims=(1, 2))
        lc = (torch.roll(lls[rows], sh, dims=(1, 2)) if lls is not None
              else None)
        res = _rate_pass(cfg, tables, cdo[i][row_ci], nd_c, nflux[i], sc, lc,
                         d_sweep,
                         nflux_xray=nfx[i] if nfx is not None else None,
                         row_ci=row_ci)
        back = (py - c, pz - c)
        ph = torch.roll(res.phih, back, dims=(1, 2))
        phih = ph if phih is None else phih + ph
        if not cfg.isothermal:
            he = torch.roll(res.phiheat, back, dims=(1, 2))
            heat = he if heat is None else heat + he
        losses.append(res.photon_loss)
        lls_losses.append(res.lls_loss)
    return phih, heat, torch.stack(losses), torch.stack(lls_losses)


def raytrace_all_sources(cfg: RunConfig, tables: RadTables,
                         ndens: torch.Tensor, xh_av1: torch.Tensor,
                         srcpos: torch.Tensor, nflux: torch.Tensor,
                         sc: SweepScalars,
                         lls_grid: Optional[torch.Tensor] = None,
                         max_shell: Optional[int] = None,
                         nflux_xray: Optional[torch.Tensor] = None,
                         slab=None):
    """Sweep every source and accumulate the global rate grid
    (pass_all_sources, evolve.F90:444-495).

    With an explicit max_shell whose window fits in the grid (2r+1 <=
    N-1) and cfg.window_sweep, the sweep is windowed (raytrace_windowed),
    as in the JAX twin.  Otherwise it is the full-cube sweep to d_sweep
    shells: sources go in batches of cfg.source_batch (capped by the same
    ~1 GiB staging bound as the JAX twin, and by MAX_BATCH); each batch
    runs the column march (sweep_cuda.compute_columns_grid) and the fused
    rate deposition (sweep_cuda.consume_rates) - the hand-written kernels
    on a CUDA device, their plain versions on the CPU.  Each batch's
    march and rate pass, and the work before them, end in phase marks of
    the loop's clock (launches.mark; nothing outside a traced loop).

    srcpos: (S, 3) 0-based cell positions; nflux: (S,) in S_star units;
    nflux_xray: (S,) X-ray fluxes in pl_s_star units, or None; lls_grid:
    the (N,N,N) grid LLS columns (type 2), or None.
    slab: (x0, m), the grid rows of the dom layout (parallel/domain.py):
    the march stays full-cube, the rate pass runs on the m rows only, in
    plain torch on every device (_slab_rate_pass), and the rate grids
    come back with m rows.

    Returns (phih, phiheat, photon_loss, lls_loss, per_source_loss) as
    tensors on the device, without a host sync; phiheat is a 0-d zero
    when cfg is isothermal.
    """
    from .sweep_cuda import compute_columns_grid, consume_rates

    n = cfg.mesh[0]
    c = n // 2
    dtype, dev = ndens.dtype, ndens.device
    d_sweep = max_shell
    if d_sweep is None:
        d_sweep = cfg.max_shell if cfg.max_shell is not None else c
    d_sweep = min(d_sweep, min(c, cfg.max_subbox))
    # windowed dispatch: per-source work O(r^3), not O(N^3) (the
    # reference's subbox rationale, evolve_source.F90:128-212)
    if (slab is None and cfg.window_sweep and max_shell is not None
            and 2 * d_sweep + 1 <= n - 1):
        return raytrace_windowed(cfg, tables, ndens, xh_av1, srcpos, nflux,
                                 sc, radius=d_sweep, lls_grid=lls_grid,
                                 nflux_xray=nflux_xray)

    s = int(srcpos.shape[0])
    itemsize = 4 if dtype == torch.float32 else 8
    b_mem = max(1, (1 << 30) // (n * n * n * itemsize))
    b = max(1, min(cfg.source_batch, s, b_mem, MAX_BATCH))
    srcpos, nflux, nfx = _pad_batch(
        srcpos.to(device=dev, dtype=torch.int32),
        nflux.to(device=dev, dtype=dtype), b,
        nflux_xray.to(device=dev, dtype=dtype)
        if nflux_xray is not None else None)

    ndhi = neutral_density(cfg, ndens, xh_av1)
    lls = (lls_grid.to(device=dev, dtype=dtype) if lls_grid is not None
           else None)
    rows = n if slab is None else slab[1]
    phih = torch.zeros((rows, n, n), dtype=dtype, device=dev)
    heat = (torch.zeros((rows, n, n), dtype=dtype, device=dev)
            if not cfg.isothermal
            else torch.zeros((), dtype=dtype, device=dev))
    loss = torch.zeros((), dtype=dtype, device=dev)
    lls_loss = torch.zeros((), dtype=dtype, device=dev)
    per_src = []
    for i in range(0, srcpos.shape[0], b):
        pos_b = srcpos[i:i + b]
        nf_b = nflux[i:i + b]
        nfx_b = nfx[i:i + b] if nfx is not None else None
        mark("sweep_glue")
        cdo_b = compute_columns_grid(cfg, ndhi, pos_b, sc, d_sweep, lls=lls)
        mark("march")
        if slab is not None:
            ph, he, lo, ll = _slab_rate_pass(cfg, tables, cdo_b, ndhi, lls,
                                             pos_b, nf_b, sc, d_sweep, slab,
                                             nfx_b)
        else:
            ph, he, lo, ll = consume_rates(
                cfg, tables, cdo_b, ndhi, pos_b, nf_b, sc, d_sweep,
                lls_grid=lls, nfx_b=nfx_b)
        mark("consume")
        del cdo_b     # free this batch's cube before the next is made
        phih = phih + ph
        if he is not None:
            heat = heat + he
        loss = loss + torch.sum(lo)
        lls_loss = lls_loss + torch.sum(ll)
        per_src.append(lo)
    return phih, heat, loss, lls_loss, torch.cat(per_src)[:s]
