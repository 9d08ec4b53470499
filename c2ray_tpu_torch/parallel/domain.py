"""Domain (grid) decomposition: the dom and halo layouts, the port of
c2ray_tpu/parallel/domain.py.  The ranks form an (n_src, n_dom) grid
(multihost.RankGrid); the dom axis cuts the grid into x-slabs of m = n /
n_dom rows, rank d holding rows [d m, d m + m), and the src axis deals
the sources.

  domain_sharded_raytracer  the dom layout's sweep: the march (K1) runs
                            on the whole cube on every rank, the rate
                            pass on the rank's slab only (plain torch, as
                            in the JAX package), and the rate grids stay
                            slabs.
  halo_sharded_raytracer    the halo layout's sweep: every O(N^3) field
                            is a slab, and the march itself runs on the
                            slab with a ring exchange per shell
                            (ops/sweep_sharded.py).
  sharded_chemistry         the chemistry of the rank's slab; the dom
                            layout all-gathers its results (its state is
                            whole on every rank), the halo layout keeps
                            them as slabs.
  WindowedHaloSweeper       the adaptive windowed buckets on the halo
                            layout's slabs: K4 and K5 on a padded slab
                            (m+2r, n+2r, n+2r), K3 on the windows.

Every global quantity is summed over the ranks (RankGrid.sum, an
all_reduce): the loss tallies, the per-source losses and, where the sources
are dealt over the src axis, the rate slabs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RunConfig
from ..ops.chemistry import global_chemistry
from ..ops.sweep import SweepScalars, raytrace_all_sources
from ..ops.tables import RadTables
from .source_shard import deal_block, pack_sum, sum_results


def slab_rows_of(grid, n: int):
    """(x0, m): the grid rows of this rank's slab."""
    if n % grid.n_dom:
        raise ValueError(f"mesh {n} not divisible by {grid.n_dom} domain "
                         "ranks")
    m = n // grid.n_dom
    return grid.dom * m, m


def domain_sharded_raytracer(grid):
    """The dom layout's raytracer (raytrace_all_sources signature): the
    march on the whole cube, replicated over dom (K1 on the card), the
    rate pass on the rank's slab (raytrace_all_sources(slab=)), the
    sources dealt over src.  -> phih (and phiheat) as (m, n, n) slabs."""

    def raytracer(cfg: RunConfig, tables: RadTables, ndens, xh_av1,
                  srcpos, nflux, sc: SweepScalars, lls_grid=None,
                  max_shell=None, nflux_xray=None):
        pos, nf, nfx, lo, total = deal_block(grid, "src", srcpos, nflux,
                                             nflux_xray)
        res = raytrace_all_sources(
            cfg, tables, ndens, xh_av1, pos, nf, sc, lls_grid=lls_grid,
            max_shell=max_shell, nflux_xray=nfx,
            slab=slab_rows_of(grid, cfg.mesh[0]))
        # the scalars and per-source losses over every rank (a source's
        # slab partials add over dom, the src blocks sit apart), the rate
        # slabs over src
        return sum_results(grid, cfg, res, lo, total, int(srcpos.shape[0]),
                           "all", "src")

    return raytracer


def halo_sharded_raytracer(grid):
    """The halo layout's raytracer: ndens, xh_av1 and lls_grid are the
    rank's (m, n, n) slabs; each source of the rank's src block is
    marched over the slab with the ring exchanges of
    ops.sweep_sharded.compute_columns_slab and its rates deposited on the
    slab (the JAX halo_sharded_raytracer, which marches one source at a
    time; here a batch of cfg.source_batch shares each shell's ring
    exchange, the same arithmetic per source).  -> phih (and phiheat) as
    slabs."""
    from ..ops.sweep import _rate_pass, neutral_density, slab_rows
    from ..ops.sweep_sharded import compute_columns_slab

    def raytracer(cfg: RunConfig, tables: RadTables, ndens, xh_av1,
                  srcpos, nflux, sc: SweepScalars, lls_grid=None,
                  max_shell=None, nflux_xray=None):
        n = cfg.mesh[0]
        c = n // 2
        r0, m = slab_rows_of(grid, n)
        d_sweep = max_shell
        if d_sweep is None:
            d_sweep = cfg.max_shell if cfg.max_shell is not None else c
        d_sweep = min(d_sweep, min(c, cfg.max_subbox))
        s = int(srcpos.shape[0])
        pos, nf, nfx, lo, total = deal_block(grid, "src", srcpos, nflux,
                                             nflux_xray)
        ndhi_s = neutral_density(cfg, ndens, xh_av1)
        dtype, dev = ndhi_s.dtype, ndhi_s.device
        phih = torch.zeros((m, n, n), dtype=dtype, device=dev)
        heat = (torch.zeros_like(phih) if not cfg.isothermal
                else torch.zeros((), dtype=dtype, device=dev))
        loss = torch.zeros((), dtype=dtype, device=dev)
        lls_loss = torch.zeros((), dtype=dtype, device=dev)
        per = []
        # the march in batches of cfg.source_batch sources (one ring
        # exchange a shell for the batch), bounded like the full-cube
        # sweep's staging; the rate pass one source at a time, in order
        itemsize = 4 if dtype == torch.float32 else 8
        b_mem = max(1, (1 << 30) // (m * n * n * itemsize))
        b = max(1, min(cfg.source_batch, b_mem, int(pos.shape[0])))
        pos_l = pos.tolist()

        def centred(field, py, pz):
            return torch.roll(field, (c - py, c - pz), dims=(1, 2))

        for i0 in range(0, len(pos_l), b):
            batch = pos_l[i0:i0 + b]
            ndhi_c = torch.stack([centred(ndhi_s, py, pz)
                                  for _, py, pz in batch])
            lls_c = (torch.stack([centred(lls_grid, py, pz)
                                  for _, py, pz in batch])
                     if lls_grid is not None else None)
            cdo = compute_columns_slab(cfg, ndhi_c, sc, lls_c, d_sweep,
                                       [px for px, _, _ in batch], r0, grid)
            for j, (px, py, pz) in enumerate(batch):
                i = i0 + j
                res = _rate_pass(
                    cfg, tables, cdo[j], ndhi_c[j], nf[i], sc,
                    lls_c[j] if lls_c is not None else None, d_sweep,
                    nflux_xray=nfx[i] if nfx is not None else None,
                    row_ci=slab_rows(n, m, r0, px))
                back = (py - c, pz - c)
                phih = phih + torch.roll(res.phih, back, dims=(1, 2))
                if not cfg.isothermal:
                    heat = heat + torch.roll(res.phiheat, back, dims=(1, 2))
                loss = loss + res.photon_loss
                lls_loss = lls_loss + res.lls_loss
                per.append(res.photon_loss)
            del cdo, ndhi_c, lls_c
        per = (torch.stack(per) if per
               else torch.zeros(0, dtype=dtype, device=dev))
        return sum_results(grid, cfg, (phih, heat, loss, lls_loss, per),
                           lo, total, s, "all", "src")

    return raytracer


def sharded_chemistry(grid, gather: bool):
    """A global_chemistry drop-in for the rank's slab (the JAX
    sharded_chemistry): whole-cube inputs are cut to the slab's rows, the
    non-convergence count is summed and the iteration count maxed over
    dom; gather=True (the dom layout, whose state is whole on every rank)
    all-gathers the iterates over dom, gather=False (halo) keeps slabs.
    Each slab's chemistry loop runs to its own convergence, as each
    shard's does in the JAX package; a cell's result does not depend on
    the others, so the slabs hold the serial run's bits."""

    def chem(cfg: RunConfig, dt, ndens, xh1_old, xh1_intermed, xh1_av,
             phih, phiheat=None, temper_current=None, temper_av=None,
             clumping=1.0, cool=None, cosmo_cool_coeff=0.0,
             photon_loss_rate=0.0):
        n = cfg.mesh[0]
        x0, m = slab_rows_of(grid, n)

        def cut(x):
            if isinstance(x, torch.Tensor) and x.dim() == 3 \
                    and x.shape[0] == n and m != n:
                return x[x0:x0 + m]
            return x

        res = global_chemistry(cfg, dt, cut(ndens), cut(xh1_old),
                               cut(xh1_intermed), cut(xh1_av), phih,
                               cut(phiheat), cut(temper_current),
                               cut(temper_av), cut(clumping), cool,
                               cosmo_cool_coeff,
                               photon_loss_rate=cut(photon_loss_rate))
        conv = grid.sum(res.conv_flag, "dom")
        nit = grid.max(res.n_iterations, "dom")
        res = res._replace(conv_flag=conv, n_iterations=nit)
        if gather and m != n:
            # the kernel's audit covers the slab, the gathered state the
            # whole grid: the tail audits that with grid_counts
            res = res._replace(audit=None)
        if gather and grid.n_dom > 1:
            fields = [f for f in (res.xh1_intermed, res.xh1_av,
                                  res.temper_intermed, res.temper_av)
                      if f is not None]
            whole = [grid.gather(f, "dom") for f in fields]
            if len(whole) == 2:
                whole += [None, None]
            res = res._replace(xh1_intermed=whole[0], xh1_av=whole[1],
                               temper_intermed=whole[2],
                               temper_av=whole[3])
        return res

    return chem


class WindowedHaloSweeper:
    """Windowed O(r^3) bucket sweeps on the halo layout's slabs (the JAX
    WindowedHaloSweeper):

      * each rank halo-extends its slab of the neutral density by r rows
        from both ring neighbours (one ring exchange), then wrap-pads
        axes 1, 2: any window centred in the slab is then a contiguous
        (2r+1)^3 block of the (m+2r, n+2r, n+2r) field (K4 on the slab);
      * the host deals each source to the slab that owns its row, round
        robin over the src axis, so every window is swept once;
      * the rates go into a padded slab accumulator (K5 on the slab);
        at the bucket's end axes 1, 2 fold mod n on the rank and axis 0's
        overflow rows go back to the neighbours (ring_fold, one ring
        exchange);
      * radius <= m (supports); larger buckets take the halo march.

    No field or rate grid is ever whole on a rank."""

    def __init__(self, grid):
        self.grid = grid
        self._cache = {}        # (radius, capacity): buckets swept

    def supports(self, cfg, radius: int) -> bool:
        return radius <= cfg.mesh[0] // self.grid.n_dom

    def halo_extend(self, x: torch.Tensor, r: int) -> torch.Tensor:
        """(m, n, n) slab -> (m+2r, n+2r, n+2r): r rows of the previous
        slab above, r of the next below (the ring is the grid's
        periodicity), then the periodic pad of axes 1, 2."""
        m, n = x.shape[0], x.shape[-1]
        top, bot = self.grid.ring_exchange(x[m - r:], x[:r])
        ext = torch.cat([top, x, bot], 0)
        idx = (torch.arange(n + 2 * r, device=x.device) - r) % n
        return ext[:, idx][:, :, idx]

    def ring_fold(self, acc: torch.Tensor, r: int, m: int) -> torch.Tensor:
        """Axis 0 of a slab accumulator (m+2r, n, n) folded over the
        ring: its first r rows belong to the previous slab's last rows,
        its last r rows to the next slab's first rows."""
        lo, core, hi = acc[:r], acc[r:r + m].clone(), acc[r + m:]
        recv_hi, recv_lo = self.grid.ring_exchange(hi, lo)
        core[m - r:] += recv_lo
        core[:r] += recv_hi
        return core

    def deal(self, pos_np, n: int):
        """The host's dealing of a bucket: -> (L, counts (n_dom*n_src,),
        flat slot of each source); the source of slot (d*n_src + si)*L + k
        is swept by rank (si, d)."""
        grid = self.grid
        m = n // grid.n_dom
        own = np.asarray(pos_np)[:, 0] // m
        slots = {}
        for j, d in enumerate(own.tolist()):
            slots.setdefault(d, []).append(j)
        lmax = max([1] + [-(-len(v) // grid.n_src) for v in slots.values()])
        L = 1 << (lmax - 1).bit_length()
        counts = np.zeros(grid.n_dom * grid.n_src, np.int64)
        flat = np.zeros(len(own), np.int64)
        for d, lst in slots.items():
            for k, j in enumerate(lst):
                blk = d * grid.n_src + k % grid.n_src
                flat[j] = blk * L + k // grid.n_src
                counts[blk] = max(counts[blk], k // grid.n_src + 1)
        return L, counts, flat

    def sweep(self, cfg, tables, radius, ndens, xh_av, lls_grid,
              pos_np, nf_np, nfx_np, sc):
        """Sweep one adaptive bucket; ndens, xh_av, lls_grid are the
        rank's slabs.  -> (phih slab, phiheat, loss, lls_loss, per_src in
        bucket order)."""
        from ..ops.sweep import neutral_density, windowed_batch
        from ..ops.window_cuda import fold_padded_acc, padded_acc_shape

        grid = self.grid
        n = cfg.mesh[0]
        r = int(radius)
        x0, m = slab_rows_of(grid, n)
        dtype, dev = ndens.dtype, ndens.device
        iso = cfg.isothermal
        L, counts, flat = self.deal(pos_np, n)
        key = (r, L)
        self._cache[key] = self._cache.get(key, 0) + 1
        blk = grid.dom * grid.n_src + grid.src
        count = int(counts[blk])
        sb = max(1, cfg.source_batch)
        b = min(L, 1 << (sb.bit_length() - 1))
        cap = -(-count // b) * b
        # this rank's windows in slab coordinates (the window's corner in
        # the extended field), padded to whole batches with zero-flux
        # windows at the slab's first cell, which add exactly zero
        mine = np.where((flat >= blk * L) & (flat < blk * L + L))[0]
        mine = mine[np.argsort(flat[mine])]
        pos = np.zeros((cap, 3), np.int32)
        nf = np.zeros(cap)
        fx = np.zeros(cap)
        pos[:count] = np.asarray(pos_np)[mine] - np.array([x0, 0, 0])
        nf[:count] = np.asarray(nf_np)[mine]
        if nfx_np is not None:
            fx[:count] = np.asarray(nfx_np)[mine]
        pos_t = torch.as_tensor(pos, device=dev)
        nf_t = torch.as_tensor(nf, dtype=dtype, device=dev)
        nfx_t = (torch.as_tensor(fx, dtype=dtype, device=dev)
                 if nfx_np is not None else None)

        ext = self.halo_extend(neutral_density(cfg, ndens, xh_av), r)
        lls_ext = (self.halo_extend(lls_grid, r) if lls_grid is not None
                   else None)
        acc = torch.zeros(padded_acc_shape(n, r, m), dtype=dtype, device=dev)
        hacc = torch.zeros_like(acc) if not iso else None
        loss = torch.zeros((), dtype=dtype, device=dev)
        lls_loss = torch.zeros((), dtype=dtype, device=dev)
        per = torch.zeros(grid.n_dom * grid.n_src * L, dtype=dtype,
                          device=dev)
        parts = []
        for j in range(0, cap, b):
            lo, ll, pw = windowed_batch(
                cfg, tables, ext, pos_t[j:j + b], nf_t[j:j + b], sc, r, acc,
                hacc, lls_pad=lls_ext,
                nfx=nfx_t[j:j + b] if nfx_t is not None else None)
            loss = loss + lo
            lls_loss = lls_loss + ll
            parts.append(pw)
        if parts:
            per[blk * L:blk * L + count] = torch.cat(parts)[:count]
        phih = self.ring_fold(fold_padded_acc(acc, n, r, axes=(1, 2)), r, m)
        heat = (self.ring_fold(fold_padded_acc(hacc, n, r, axes=(1, 2)), r,
                               m)
                if not iso else torch.zeros((), dtype=dtype, device=dev))
        loss, lls_loss, per = pack_sum(grid, "all", [loss, lls_loss, per])
        if grid.n_src > 1:
            out = pack_sum(grid, "src", [phih] + ([heat] if not iso else []))
            phih = out[0]
            heat = out[1] if not iso else heat
        return phih, heat, loss, lls_loss, \
            per[torch.as_tensor(flat, device=dev)]
