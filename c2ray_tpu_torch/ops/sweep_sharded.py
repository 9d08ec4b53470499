"""The halo-exchange causal march on a grid slab: PyTorch port of
c2ray_tpu/ops/sweep_sharded.py (the halo layout's march).

The face-major wavefront recast for a grid split into x-slabs over the
ranks of the dom ring: every O(N^3) field, the march state included,
lives as an (m, N, N) slab, so meshes larger than one card's memory fit.

  * The z+/z-/y+/y- face planes have grid x as their first axis, so each
    rank holds the m-row strip of them that overlaps its slab.  The
    causal shift toward the source along x needs ONE halo row from each
    x-neighbour per shell; the shifts along the other axis, the weights
    and the y-plane wedge fixups are strip-local.
  * The x+/x- face planes at shell d are the single grid rows src_x +- d,
    owned by one rank.  Their update reads the previous x plane and rows
    of the owner's strips; ownership advances one row per shell, so the
    plane passes to the same or the adjacent rank.

Per shell: one ring exchange each way (RankGrid.ring_exchange: the halo
rows and the x plane, merged), as in the JAX package.  Ownership is known
on the host (source and slab rows are Python integers), so a rank skips
the x-plane work of rows it does not own, where the JAX program computes
it and masks it out; the owned cells get the same arithmetic.

The march is plain torch on every device, as the JAX package runs it in
XLA (there is no Pallas kernel of it).  The rank grid counts its ring
exchanges and the bytes they move (RankGrid.stats).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants as const
from ..config import RunConfig
from .sweep import SQRT2, SQRT3, SweepScalars

def _interp(c1, c2, c3, c4, ta, tb, d: int, dtype):
    """The short-characteristics corner interpolation in the shell frame
    (column_density.f90:108-267 in closed form; the JAX _interp)."""
    sigma = const.SIGMA_HI_AT_ION_FREQ
    df = torch.tensor(float(d), dtype=dtype)       # a host scalar
    inv_d = 1.0 / df
    f_a = torch.clamp((df - torch.abs(ta)) * inv_d, 0.0, 1.0)
    f_b = torch.clamp((df - torch.abs(tb)) * inv_d, 0.0, 1.0)
    s1 = (1.0 - f_a) * (1.0 - f_b)
    s2 = f_a * (1.0 - f_b)
    s3 = (1.0 - f_a) * f_b
    s4 = f_a * f_b

    def wf(cd):
        return 1.0 / torch.clamp(cd * sigma, min=0.6)

    w1 = s1 * wf(c1)
    w2 = s2 * wf(c2)
    w3 = s3 * wf(c3)
    w4 = s4 * wf(c4)
    cdensi = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) / (w1 + w2 + w3 + w4)
    path = torch.sqrt((ta * ta + tb * tb) * (inv_d * inv_d) + 1.0)
    return cdensi, path


def _diag_fix(cdensi, d: int, abs_a1, abs_b1, dtype):
    """Shell-1 sqrt(2)/sqrt(3) diagonal corrections
    (column_density.f90:152-158)."""
    if d != 1:
        return cdensi
    one = torch.ones((), dtype=dtype, device=cdensi.device)
    diag = torch.where(abs_a1 & abs_b1, one * SQRT3,
                       torch.where(abs_a1 | abs_b1, one * SQRT2, one))
    return cdensi * diag


def _strip_planes(slab: torch.Tensor, d: int) -> torch.Tensor:
    """Shell d's strip planes (B, 4, m, N) of faces (z+, z-, y+, y-) from
    (B, m, N, N) slabs whose axes 1, 2 are centred on their sources, rows
    clamped at the edges as the JAX _stage_strips does."""
    n = slab.shape[-1]
    c = n // 2
    dp, dm = min(c + d, n - 1), max(c - d, 0)
    return torch.stack([slab[..., dp], slab[..., dm], slab[..., dp, :],
                        slab[..., dm, :]], dim=1)


def _strip_update(prev, halo_below, halo_above, ndhi_p, lcol, d: int,
                  cfg: RunConfig, dr: float, ox: torch.Tensor, n: int):
    """Advance the 4 strip faces (z+, z-, y+, y-) one shell.

    prev: (B, 4, m, N) previous planes of B sources; halo_below/above:
    (B, 4, N) rows r0-1 and r0+m from the x-neighbours; ox: (B, m)
    centred x offsets of the slab's rows from each source."""
    dtype, dev = prev.dtype, prev.device
    c = n // 2
    ta = ox.to(dtype)[:, None, :, None]
    itb = torch.arange(n, device=dev) - c
    tb = itb.to(dtype)
    pos_a = (ox >= 0)[:, None, :, None]
    pos_b = itb >= 0

    # the causal shift toward the source along x: rows with ox >= 0 read
    # the grid row below, ox < 0 the row above; the halo rows supply the
    # slab's edges (the ring is the grid's periodicity)
    read_below = torch.cat([halo_below[:, :, None, :], prev[:, :, :-1]], 2)
    read_above = torch.cat([prev[:, :, 1:], halo_above[:, :, None, :]], 2)
    c3 = torch.where(pos_a, read_below, read_above)

    def shift_b(x):
        return torch.where(pos_b, torch.roll(x, 1, -1), torch.roll(x, -1, -1))

    c4 = prev
    c2 = shift_b(prev)
    c1 = shift_b(c3)
    cdensi, path = _interp(c1, c2, c3, c4, ta, tb, d, dtype)
    cdensi = _diag_fix(cdensi, d, (torch.abs(ox) == 1)[:, None, :, None],
                       torch.abs(itb) == 1, dtype)
    coldensh_in = cdensi
    if cfg.use_lls and cfg.type_of_lls in (1, 2):
        coldensh_in = coldensh_in + lcol * path
    newp = coldensh_in + ndhi_p * (path * dr)

    # y-plane wedge fixups: the |oz| = d columns come from the z planes of
    # the same x row (the mirror b -> 2c - b, mod n)
    on_pb = itb == d
    on_mb = itb == -d
    mirror = (2 * c - torch.arange(n, device=dev)) % n
    pz, mz = newp[:, 0], newp[:, 1]
    py = torch.where(on_pb, pz, torch.where(on_mb, mz[..., mirror],
                                            newp[:, 2]))
    my = torch.where(on_pb, pz[..., mirror], torch.where(on_mb, mz,
                                                         newp[:, 3]))
    return torch.stack([pz, mz, py, my], dim=1)


def _xplane_update(prev, ndhi_plane, lcol_plane, d: int, cfg: RunConfig,
                   dr: float, rows4, n: int):
    """Advance x-face planes (B, N, N) (axes: centred y, centred z) one
    shell.  rows4: (B, 4, N) the owner's strip rows at each plane's grid
    row (pz, mz, py, my, wedge-fixed): the y rows give the |oy| = d rows,
    then the z rows the |oz| = d columns (z has the top priority)."""
    dtype, dev = prev.dtype, prev.device
    c = n // 2
    it = torch.arange(n, device=dev) - c
    ita, itb = it[:, None], it[None, :]
    ta, tb = ita.to(dtype), itb.to(dtype)
    pos_a, pos_b = ita >= 0, itb >= 0

    def shift(x, axis, pos):
        return torch.where(pos, torch.roll(x, 1, axis),
                           torch.roll(x, -1, axis))

    c4 = prev
    c3 = shift(prev, -2, pos_a)
    c2 = shift(prev, -1, pos_b)
    c1 = shift(c3, -1, pos_b)
    cdensi, path = _interp(c1, c2, c3, c4, ta, tb, d, dtype)
    cdensi = _diag_fix(cdensi, d, torch.abs(ita) == 1, torch.abs(itb) == 1,
                       dtype)
    coldensh_in = cdensi
    if cfg.use_lls and cfg.type_of_lls in (1, 2):
        coldensh_in = coldensh_in + lcol_plane * path
    newp = coldensh_in + ndhi_plane * (path * dr)

    pz_r, mz_r, py_r, my_r = (rows4[:, k] for k in range(4))
    newp = torch.where(ita == d, py_r[:, None, :], newp)
    newp = torch.where(ita == -d, my_r[:, None, :], newp)
    newp = torch.where(itb == d, pz_r[:, :, None], newp)
    newp = torch.where(itb == -d, mz_r[:, :, None], newp)
    return newp


def _commit_strips(out: torch.Tensor, planes: torch.Tensor, d: int,
                   d_max: int, ox: torch.Tensor) -> None:
    """Write shell d's owned z- and y-face cells of the (B, 4, m, N) strip
    planes into the (B, m, N, N) slabs in place (the per-shell form of
    the JAX _unstage_strips: z faces own dz >= |ox|, |oy|; y faces own
    dy >= |ox| and dy > |oz|; the z face writes zeros where it does not
    own, the y face keeps the cell)."""
    n = out.shape[-1]
    c = n // 2
    axo = torch.abs(ox)[:, :, None]                   # (B, m, 1)
    ot = torch.abs(torch.arange(n, device=out.device) - c)
    own_z = (d >= axo) & (d >= ot)
    own_y = (d >= axo) & (d > ot)
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    sides = []
    if d <= min(d_max, n - 1 - c):
        sides.append((c + d, 0, 2))
    if d <= min(d_max, c):
        sides.append((c - d, 1, 3))
    for row, fz, _ in sides:
        out[..., row] = torch.where(own_z, planes[:, fz], zero)
    for row, _, fy in sides:
        out[..., row, :] = torch.where(own_y, planes[:, fy],
                                       out[..., row, :])


def compute_columns_slab(cfg: RunConfig, ndhi_slab: torch.Tensor,
                         sc: SweepScalars, lls_slab: Optional[torch.Tensor],
                         max_shell: int, src_x, r0: int,
                         grid) -> torch.Tensor:
    """The halo-exchange march of a batch of sources over this rank's slab.

    ndhi_slab: (B, m, N, N) slabs of the neutral density, one per source,
    axes 1, 2 centred on it (rolled by c - src_{y,z}), axis 0 the grid
    rows [r0, r0+m).  lls_slab: the grid LLS columns, the same way, or
    None.  src_x: the sources' grid rows.  grid: the layout's RankGrid
    (its dom ring).  One ring exchange a shell carries the whole batch.
    -> the (B, m, N, N) coldensh_out slabs, axes 1, 2 centred."""
    b, m, n = ndhi_slab.shape[0], ndhi_slab.shape[1], ndhi_slab.shape[-1]
    c = n // 2
    dtype, dev = ndhi_slab.dtype, ndhi_slab.device
    use_lls_grid = (lls_slab is not None and cfg.use_lls
                    and cfg.type_of_lls in (1, 2))
    scalar_lls = sc.lls_coldens
    src_x = [int(x) for x in src_x]

    rows = torch.arange(r0, r0 + m, device=dev)
    ox = (rows[None, :] - torch.as_tensor(src_x, device=dev)[:, None]
          + c) % n - c                                          # (B, m)

    # what is known on the host (which rank owns which row) goes to the
    # device once, before the shells: the shell loop then waits for the
    # card only in its ring exchange
    shells = range(1, max_shell + 1)
    keep_px = torch.as_tensor([[(x + d - 1 - r0) % n < m for x in src_x]
                               for d in shells], device=dev)
    keep_mx = torch.as_tensor([[(x - (d - 1) - r0) % n < m for x in src_x]
                               for d in shells], device=dev)
    lsrc = [(x - r0) % n for x in src_x]
    spans, flat = {}, []        # (shell, sign) -> its (owners, rows)
    for key, lrow in [((0, 0), lsrc)] + [
            ((d, sign), [(x + sign * d - r0) % n for x in src_x])
            for d in shells for sign in (1, -1)]:
        sel = [i for i in range(b) if lrow[i] < m]
        if sel:
            spans[key] = (len(flat), len(sel))
            flat += sel + [lrow[i] for i in sel]
    flat = torch.as_tensor(flat, dtype=torch.long, device=dev)

    def owners(key):
        """(batch entries, their local rows) whose row `key` names lies
        in this slab, or None."""
        if key not in spans:
            return None
        o, k = spans[key]
        return flat[o:o + k], flat[o + k:o + 2 * k]

    # the source cell: a half-cell column (evolve_point.F90:151-160), on
    # the rank that owns its row; another rank takes the x planes from
    # its neighbours before it owns one, so its seed is never read
    strips = torch.zeros((b, 4, m, n), dtype=dtype, device=dev)
    px = torch.zeros((b, n, n), dtype=dtype, device=dev)
    cdo = torch.zeros((b, m, n, n), dtype=dtype, device=dev)
    out = torch.zeros((b, m, n, n), dtype=dtype, device=dev)
    seed = owners((0, 0))
    if seed is not None:
        own, lr = seed
        cdo0 = ndhi_slab[own, lr, c, c] * (0.5 * sc.dr)
        strips[own, :, lr, c] = cdo0[:, None]
        px[own, c, c] = cdo0
        cdo[own, lr, c, c] = cdo0
    mx = px.clone()
    it = torch.arange(n, device=dev) - c
    for d in range(1, max_shell + 1):
        # one ring exchange each way: the halo rows for the strip shift
        # and the x planes' hand-over
        recv_up, recv_dn = grid.ring_exchange(
            torch.cat([strips[:, :, -1, :], px], 1),
            torch.cat([strips[:, :, 0, :], mx], 1))
        halo_below, px_from_dn = recv_up[:, :4], recv_up[:, 4:]
        halo_above, mx_from_up = recv_dn[:, :4], recv_dn[:, 4:]
        px = torch.where(keep_px[d - 1][:, None, None], px, px_from_dn)
        mx = torch.where(keep_mx[d - 1][:, None, None], mx, mx_from_up)

        lcol = _strip_planes(lls_slab, d) if use_lls_grid else scalar_lls
        strips = _strip_update(strips, halo_below, halo_above,
                               _strip_planes(ndhi_slab, d), lcol, d, cfg,
                               sc.dr, ox, n)
        _commit_strips(out, strips, d, max_shell, ox)

        # the x planes: owner rows src_x +- d (at d = c the +d row aliases
        # the -d row, which belongs to x-)
        interior = (torch.abs(it)[:, None] < d) & (torch.abs(it)[None, :] < d)
        for sign in (1, -1):
            mine = owners((d, sign))
            if mine is None:
                continue
            sel, lr = mine
            lc = lls_slab[sel, lr] if use_lls_grid else scalar_lls
            planes = px if sign > 0 else mx
            new = _xplane_update(planes[sel], ndhi_slab[sel, lr], lc, d, cfg,
                                 sc.dr, strips[sel, :, lr], n)
            planes[sel] = new
            if sign > 0 and (d + c) % n - c != d:
                continue
            cdo[sel, lr] = torch.where(interior, new, cdo[sel, lr])
    return cdo + out
