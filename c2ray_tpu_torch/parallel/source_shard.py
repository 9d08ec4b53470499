"""Source-sharded ray tracing over ranks: the src layout, the port of
c2ray_tpu/parallel/source_shard.py (the reference's MPI source
distribution, master_slave.F90, with the ALLREDUCE of the rate grids,
evolve.F90:577-616).

Every rank holds the whole grid and sweeps its share of the sources; the
rate grids, the loss tallies and the per-source losses come back summed
over the ranks in ONE collective per call (RankGrid.sum, an all_reduce:
the same bits on every rank).  Load balance comes from the host's
flux-sorted dealing (models/sources.sort_sources_by_flux), as in the JAX
package.

  sharded_raytracer       the raytrace_all_sources signature: each rank
                          runs the full-cube sweep (K1 + K2 on the card)
                          on its contiguous block of the padded sources.
  WindowedShardedSweeper  one adaptive windowed bucket: each rank runs
                          the windowed batches (K4, K3, K5 on the card)
                          on its block of the bucket, at the JAX
                          sweeper's pow2 capacity and batch rule.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RunConfig
from ..ops.sweep import SweepScalars, raytrace_all_sources
from ..ops.tables import RadTables


def pad_sources(srcpos: np.ndarray, nflux: np.ndarray, multiple: int):
    """Pad the source list with zero-flux sources at cell 0 so it deals
    evenly; zero-flux sources add exactly zero rates and losses
    (radiation_photoionrates.F90:126-137).  -> (srcpos, nflux, count)."""
    s = len(nflux)
    pad = (-s) % multiple
    if pad:
        srcpos = np.concatenate([srcpos, np.zeros((pad, 3), srcpos.dtype)])
        nflux = np.concatenate([nflux, np.zeros(pad, nflux.dtype)])
    return srcpos, nflux, s


def _pad_rows(x: torch.Tensor, total: int) -> torch.Tensor:
    """x padded with zero rows to `total` rows."""
    if x.shape[0] == total:
        return x
    return torch.cat([x, x.new_zeros((total - x.shape[0],)
                                     + tuple(x.shape[1:]))])


def pack_sum(grid, axis: str, tensors):
    """The axis's sums of several tensors in one collective: the tensors
    go flat into one vector, which RankGrid.sum all-reduces, and come
    back in their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    out = grid.sum(flat, axis)
    res, k = [], 0
    for t in tensors:
        res.append(out[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return res


def deal_block(grid, axis: str, srcpos, nflux, nflux_xray=None):
    """This rank's contiguous block of the sources dealt over the ranks of
    `axis`, the list padded with zero-flux sources to a multiple of the
    axis's size.  -> (pos, nf, nfx, lo, total): the block, where it
    starts in the padded list, and that list's length."""
    k = grid.size(axis)
    L = -(-int(srcpos.shape[0]) // k)
    lo = grid.index(axis) * L
    total = k * L

    def cut(x):
        return _pad_rows(x, total)[lo:lo + L] if x is not None else None

    return cut(srcpos), cut(nflux), cut(nflux_xray), lo, total


def sum_results(grid, cfg: RunConfig, res, lo: int, total: int, s: int,
                loss_axis: str, rate_axis):
    """Sum a sweep of a deal_block's sources over the ranks: the loss
    tallies and the per-source losses (this rank's block at its place in
    the list, zeros elsewhere, which add exactly) over loss_axis, the
    rate grids over rate_axis (None: they stay this rank's); one
    collective where the two axes are one.  res: raytrace_all_sources's
    (phih, heat, loss, lls_loss, per).  -> the same, per[:s] in list
    order."""
    phih, heat, loss, lls_loss, per = res
    full = per.new_zeros(total)
    full[lo:lo + per.shape[0]] = per
    rates = [phih] + ([heat] if not cfg.isothermal else [])
    if rate_axis == loss_axis:
        out = pack_sum(grid, loss_axis, [loss, lls_loss, full] + rates)
        rates = out[3:]
    else:
        out = pack_sum(grid, loss_axis, [loss, lls_loss, full])
        if rate_axis is not None and grid.size(rate_axis) > 1:
            rates = pack_sum(grid, rate_axis, rates)
    loss, lls_loss, full = out[:3]
    heat = rates[1] if not cfg.isothermal else heat
    return rates[0], heat, loss, lls_loss, full[:s]


def sharded_raytracer(grid, axis: str = "all"):
    """A raytracer with the raytrace_all_sources signature that deals the
    sources over the ranks of `axis` (deal_block) and sums the results
    (sum_results, one collective).  Inject it into Evolve3D
    (raytracer=)."""

    def raytracer(cfg: RunConfig, tables: RadTables, ndens, xh_av1,
                  srcpos, nflux, sc: SweepScalars, lls_grid=None,
                  max_shell=None, nflux_xray=None):
        pos, nf, nfx, lo, total = deal_block(grid, axis, srcpos, nflux,
                                             nflux_xray)
        res = raytrace_all_sources(
            cfg, tables, ndens, xh_av1, pos, nf, sc, lls_grid=lls_grid,
            max_shell=max_shell, nflux_xray=nfx)
        return sum_results(grid, cfg, res, lo, total, int(srcpos.shape[0]),
                           axis, axis)

    return raytracer


class WindowedShardedSweeper:
    """Windowed O(r^3) bucket sweeps with the sources dealt over ranks
    (the JAX WindowedShardedSweeper; master_slave.F90:74-96 with
    evolve_source.F90:128-212): each rank runs the windowed batches
    (gather, march, rate pass, scatter-add) of its block of the bucket
    over the whole grid, and the rate grids, losses and per-source losses
    take one sum per bucket.  `axis` is "all" for the src layout and for
    the dom layout (whose windows never touch its slab structure); rows
    (x0, m), where given, cut the summed rate grids to the dom layout's
    slab.  Inject it into Evolve3D (windowed=)."""

    def __init__(self, grid, axis: str = "all", rows=None):
        self.grid = grid
        self.axis = axis
        self.ndev = grid.size(axis)
        self.rows = rows
        self._cache = {}        # (radius, capacity): buckets swept

    def supports(self, cfg: RunConfig, radius: int) -> bool:
        return True

    def sweep(self, cfg, tables, radius, ndens, xh_av, lls_grid,
              pos_np, nf_np, nfx_np, sc):
        """Sweep one adaptive bucket; -> (phih, phiheat, loss, lls_loss,
        per_src) with per_src[:len(pos_np)] in bucket order."""
        from ..ops.sweep import windowed_batch, windowed_prepass, wrap_pad
        from ..ops.window_cuda import fold_padded_acc, padded_acc_shape

        n = cfg.mesh[0]
        r = int(radius)
        dtype, dev = ndens.dtype, ndens.device
        s = len(nf_np)
        L = -(-s // self.ndev)
        L = 1 << (L - 1).bit_length()     # the pow2 capacity, as in JAX
        i = self.grid.index(self.axis)
        total = self.ndev * L
        count = int(np.clip(s - L * i, 0, L))
        key = (r, L)
        self._cache[key] = self._cache.get(key, 0) + 1
        sb = max(1, cfg.source_batch)
        b = min(L, 1 << (sb.bit_length() - 1))
        nb = -(-count // b)
        # this rank's block, padded to whole batches with zero-flux
        # windows at cell 0, which add exactly zero
        blk = slice(i * L, i * L + count)
        cap = nb * b
        pos = np.zeros((cap, 3), np.int32)
        nf = np.zeros(cap)
        pos[:count] = np.asarray(pos_np)[blk]
        nf[:count] = np.asarray(nf_np)[blk]
        pos_t = torch.as_tensor(pos, device=dev)
        nf_t = torch.as_tensor(nf, dtype=dtype, device=dev)
        nfx_t = None
        if nfx_np is not None:
            fx = np.zeros(cap)
            fx[:count] = np.asarray(nfx_np)[blk]
            nfx_t = torch.as_tensor(fx, dtype=dtype, device=dev)

        iso = cfg.isothermal
        acc = torch.zeros(padded_acc_shape(n, r), dtype=dtype, device=dev)
        hacc = torch.zeros_like(acc) if not iso else None
        loss = torch.zeros((), dtype=dtype, device=dev)
        lls_loss = torch.zeros((), dtype=dtype, device=dev)
        per = torch.zeros(total, dtype=dtype, device=dev)
        if nb:
            ndhi_pad = windowed_prepass(cfg, ndens, xh_av, r)
            lls_pad = (wrap_pad(lls_grid, r) if lls_grid is not None
                       else None)
            parts = []
            for j in range(0, cap, b):
                lo, ll, pw = windowed_batch(
                    cfg, tables, ndhi_pad, pos_t[j:j + b], nf_t[j:j + b],
                    sc, r, acc, hacc, lls_pad=lls_pad,
                    nfx=nfx_t[j:j + b] if nfx_t is not None else None)
                loss = loss + lo
                lls_loss = lls_loss + ll
                parts.append(pw)
            per[i * L:i * L + count] = torch.cat(parts)[:count]
        # the padded accumulators are summed before the fold, as the
        # serial sweep folds one accumulator of all the bucket's windows
        tensors = [acc, loss, lls_loss, per] + ([hacc] if not iso else [])
        out = pack_sum(self.grid, self.axis, tensors)
        phih = fold_padded_acc(out[0], n, r)
        loss, lls_loss, per = out[1:4]
        heat = (fold_padded_acc(out[4], n, r) if not iso
                else torch.zeros((), dtype=dtype, device=dev))
        if self.rows is not None:
            x0, m = self.rows
            phih = phih[x0:x0 + m]
            if not iso:
                heat = heat[x0:x0 + m]
        return phih, heat, loss, lls_loss, per[:s]

