"""evolve3D: the global convergence iteration over sources + chemistry,
PyTorch port of c2ray_tpu/solver.py (evolve.F90:83-281), isothermal and
non-isothermal, with the adaptive subbox-radius sweep of the many-source
regime.

One call evolves the grid over a timestep dt by iterating
[sweep all sources -> global chemistry -> photon audit] until the grid
converges.  Two loops do it, as in the JAX package:

  the device loop (_evolve_device_loop, the JAX twin's lax.while_loop
      program): the iteration's body updates a carry of tensors and
      writes the loop's condition on the device, the per-iteration
      scalars going to a history buffer; on a CUDA device (no parallel
      layout) the body is captured once into a CUDA graph and one launch
      of a conditional WHILE node around it (cuda_graph.WhileGraph) runs
      the whole loop, then ONE device-to-host copy brings back the
      scalars, the history and the per-source losses, and the host
      replays the per-iteration reports, Timings stamps and dump.  On the
      CPU, and under a parallel layout, the same body runs uncaptured,
      with one host read of the condition per iteration.  It is taken
      when device_loop_ok says so (the JAX rule);
  the host loop: each iteration dispatches the sweep and the chemistry
      tail, then makes ONE device-to-host copy of the packed scalars
      [conv_flag, sum_xh1, photon_loss, lls_loss, (h0, h1, rec, coll)]
      and the per-source losses.

Non-isothermally the sweep also
deposits the photo-heating rate, the chemistry integrates the
temperature (ops/thermal.py) and the step commits the last iterate's
temperature (set_final_temperature_point).  LLS runs off or as types 1
(a column per cell), 2 (a column cube, lls_grid) or 3 (the R_max
barrier), and X-ray sources add their power-law photons (nflux_xray).
Under compressed storage (cfg.compressed_xfrac) the iterates hold the
signed min-fraction form; with cfg.add_photon_losses the boundary losses
come back as a per-cell rate.  A dumper writes the double-buffered
iteration dumps, and iter_restart resumes from one (start_from_dump).

Adaptive sweeps (evolve_source.F90:128-212): every source starts at a
Stroemgren-estimated radius on a power-of-two ladder of rungs; rungs whose
(2r+1)^3 window fits in the grid are swept windowed, the top rung over the
full cube, and a source whose escaping photons exceed loss_fraction of its
flux moves one rung up for the next convergence iteration.

Under a parallel layout (parallel/layout.py) the layout's injections
take over: the raytracer (every full-cube sweep, and under a layout every
adaptive bucket the windowed sweeper does not take, in one call at pow2
capacity), the chemistry, the windowed-bucket sweeper and the rate
grids' slab (rate_sharding).  Under the halo layout the state is the
rank's slab, and every sum over the grid (the convergence sum, the
photon audit's counts, the mean density of the initial radii) is summed
over the ranks.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import RunConfig, resolve_device
from .ops.chemistry import global_chemistry
from .ops.photonstats import GridCounts, PhotonStatistics, grid_counts
from .ops.sweep import (SweepScalars, check_window_positions,
                        neutral_density, raytrace_all_sources, sweep_scalars,
                        windowed_batch, windowed_prepass, wrap_pad)
from .ops.tables import RadTables, photoion_rates
from .ops.thermal import CoolingTable
from .state import GridState, xh1_of


class EvolveInfo(NamedTuple):
    niter: int
    conv_flag: int
    converged: bool
    mean_xh1: float
    photon_loss: float       # S_star units
    lls_loss: float          # S_star units
    per_source_loss: np.ndarray
    photon_stats: dict
    phih: Optional[torch.Tensor] = None      # last accumulated rate grid
    phiheat: Optional[torch.Tensor] = None   # last heating grid; None:
                                             # isothermal
    # adaptive sweeps: sources per radius rung in each convergence
    # iteration, as swept (a port-only field; None when not adaptive)
    rungs: Optional[list] = None


def check_supported(cfg: RunConfig, device: torch.device) -> None:
    """Raise NotImplementedError for every option the port does not run:
    LLS types beyond 3, non-cubic meshes, dtypes other than float32 and
    float64, devices other than the CPU and CUDA.  float64 and table
    rates run on both devices."""
    rejected = [
        (cfg.use_lls and cfg.type_of_lls not in (1, 2, 3),
         f"LLS type {cfg.type_of_lls}"),
        # the JAX package asserts a cubic mesh too (ops/sweep.py:812)
        (not (cfg.mesh[0] == cfg.mesh[1] == cfg.mesh[2]), "non-cubic meshes"),
        (cfg.dtype not in ("float32", "float64"), f"dtype {cfg.dtype}"),
        (device.type not in ("cpu", "cuda"), f"device {device}"),
    ]
    for bad, what in rejected:
        if bad:
            raise NotImplementedError(
                f"{what} not ported to c2ray_tpu_torch yet")


class Evolve3D:
    """evolve3D solver for a fixed config + tables on one device.

    device: None means CUDA (and raises when there is none); the tests
    pass "cpu", where the sweep runs its plain PyTorch versions.  cool:
    the cooling table (ops.thermal.setup_cool), which a non-isothermal
    cfg needs.

    The injections of a parallel layout (parallel/layout.LayoutRuntime
    builds them; the JAX twin's arguments):
      raytracer      replaces ops.sweep.raytrace_all_sources, with its
                     signature (parallel/source_shard.sharded_raytracer,
                     parallel/domain.domain_sharded_raytracer,
                     halo_sharded_raytracer);
      chemistry      replaces ops.chemistry.global_chemistry, with its
                     signature (parallel/domain.sharded_chemistry);
      windowed       sweeps the adaptive windowed buckets it supports()
                     (WindowedShardedSweeper, WindowedHaloSweeper);
      rate_sharding  a parallel.layout.SlabSharding: the rate grids are
                     the rank's x-slab, and with .state the state is too.
    """

    def __init__(self, cfg: RunConfig, tables: RadTables, device=None,
                 cool: Optional[CoolingTable] = None, raytracer=None,
                 chemistry=None, windowed=None, rate_sharding=None):
        self.device = resolve_device(device)
        check_supported(cfg, self.device)
        if not cfg.isothermal and cool is None:
            raise ValueError("a non-isothermal Evolve3D needs a cooling "
                             "table: cool=setup_cool(cfg)")
        self.cfg = cfg
        self.tables = RadTables(*[t.to(self.device) if t is not None
                                  else None for t in tables])
        self.cool = (cool._replace(cie_cool=cool.cie_cool.to(self.device))
                     if cool is not None else None)
        # per-timestep cache of padded per-bucket device source arrays,
        # rebuilt only when promotions change the assignment
        self._abucket_cache = (None, {})
        self._custom_raytracer = raytracer is not None
        self._rt = raytracer if raytracer is not None else \
            raytrace_all_sources
        self._chem = chemistry if chemistry is not None else \
            global_chemistry
        self._windowed = windowed
        self._rate_sharding = rate_sharding
        # the device loop's CUDA graphs, one per static signature
        self._loop_cache = {}
        # how the last device-loop step ran (form, iterations, graph
        # launches, host reads, capture seconds, graph nodes); None until
        # one has
        self.last_loop = None

    def _gsum(self, t: torch.Tensor) -> torch.Tensor:
        """Per-rank sums over the state's grid -> sums over the whole grid
        (the identity unless the state is a slab)."""
        if self._rate_sharding is None:
            return t
        return self._rate_sharding.grid_sum(t)

    def _counts(self, ndens, xh1, t_av, clump) -> GridCounts:
        """grid_counts over the whole grid."""
        gc = grid_counts(self.cfg, ndens, xh1, t_av, clump,
                         compressed=self.cfg.compressed_xfrac)
        if self._rate_sharding is None or not self._rate_sharding.state:
            return gc
        return GridCounts(*self._gsum(torch.stack(
            [torch.as_tensor(v, dtype=ndens.dtype, device=ndens.device)
             for v in gc])))

    # ------------------------------------------------------------------
    def _radius_ladder(self):
        n = self.cfg.mesh[0]
        d_max = n // 2
        r = max(2, self.cfg.adaptive_min_shell)
        ladder = []
        while r < d_max:
            ladder.append(r)
            r *= 2
        ladder.append(d_max)
        return ladder

    def _initial_radii(self, nflux_np, ndens_mean, dr, dt):
        """Stroemgren-style initial rung per source (the JAX
        _initial_radii): the isolated-bubble radius, capped at ~the mean
        half-separation of the sources except for the top-decile fluxes,
        snapped up to the ladder.  Leaky sources are promoted by the
        escaping-photon test (evolve_source.F90:128-136)."""
        cfg = self.cfg
        n = cfg.mesh[0]
        ladder = self._radius_ladder()
        s_phys = np.maximum(nflux_np, 1e-300) * cfg.sed.s_star
        r_est = (3.0 * s_phys * dt / (4.0 * np.pi * ndens_mean)) ** (1.0 / 3.0)
        cells = 1.3 * r_est / dr
        num_src = max(1, len(nflux_np))
        spacing_cap = 0.75 * n / num_src ** (1.0 / 3.0)
        capped = np.minimum(cells, max(spacing_cap,
                                       float(cfg.adaptive_min_shell)))
        if num_src > 1:
            exempt = nflux_np >= np.quantile(nflux_np, 0.9)
            cells = np.where(exempt, cells, capped)
        else:
            cells = capped
        assign = np.searchsorted(np.asarray(ladder), cells)
        return np.minimum(assign, len(ladder) - 1).astype(np.int64)

    def _window_chunk_size(self, radius: int) -> int:
        """Windows per batch at this rung: ~source_batch x 17^3 window
        cells per batch, pow2-floored (the JAX _window_chunk_size)."""
        sb = max(1, self.cfg.source_batch)
        c = int(sb * (17 ** 3) / (2 * radius + 1) ** 3)
        c = max(4, min(sb, c))
        return 1 << (c.bit_length() - 1)

    def _full_chunk_size(self) -> int:
        """Sources per full-cube call at the top rung, bounded by its
        staging memory cap (the JAX _full_chunk_size)."""
        n = self.cfg.mesh[0]
        itemsize = 4 if self.cfg.torch_dtype == torch.float32 else 8
        b_mem = max(1, (1 << 30) // (n * n * n * itemsize))
        c = max(1, min(self.cfg.source_batch, b_mem))
        return 1 << (c.bit_length() - 1)

    def _bucket_arrays(self, key, b, cap, idx, srcpos_np, nflux_np,
                       nfx_np=None):
        """Padded device source arrays of one rung, (positions, fluxes,
        X-ray fluxes or None), the fluxes padded with zeros (cached
        across convergence iterations under the assignment key)."""
        ck, store = self._abucket_cache
        if ck != key:
            store = {}
            self._abucket_cache = (key, store)
        hit = store.get((b, cap))
        if hit is not None:
            return hit

        def padded(a, shape):
            out = np.zeros(shape, a.dtype)
            out[:len(idx)] = a[idx]
            return out

        dev, dtype = self.device, self.cfg.torch_dtype
        out = (torch.as_tensor(padded(srcpos_np.astype(np.int32), (cap, 3)),
                               device=dev),
               torch.as_tensor(padded(nflux_np, cap), dtype=dtype, device=dev),
               torch.as_tensor(padded(nfx_np, cap), dtype=dtype, device=dev)
               if nfx_np is not None else None)
        store[(b, cap)] = out
        return out

    def _adaptive_sweep(self, ndens, xh_av, srcpos_np, nflux_np, sc, assign,
                        lls_grid=None, nfx_np=None):
        """Sweep the sources rung by rung (the JAX _adaptive_sweep):
        windowed rungs in fixed-size batches through
        ops.sweep.windowed_batch into one padded accumulator per rung,
        folded into the rate grid at the rung's end; the full-cube rung in
        fixed-size chunks through raytrace_all_sources.  Under a layout the
        windowed sweeper takes the rungs it supports, one call a rung, and
        the injected raytracer every other rung in one call at pow2
        capacity.  Non-isothermally the heating rates go the
        same way into a second accumulator.  A grid LLS cube takes each
        windowed rung's pad and its own gathers; the X-ray fluxes ride
        each rung's bucket arrays, padded with zeros as the fluxes are.
        No host sync: the per-source losses come back as (indices, device
        tensor) pairs for the iteration's one copy.  -> (phih, phiheat,
        photon_loss, lls_loss, pending); phiheat is a 0-d zero when
        isothermal."""
        from .ops.window_cuda import fold_padded_acc, padded_acc_shape

        cfg = self.cfg
        dtype, dev = cfg.torch_dtype, self.device
        n = cfg.mesh[0]
        iso = cfg.isothermal
        shape = ((n, n, n) if self._rate_sharding is None
                 else (self._rate_sharding.rows[1], n, n))
        phih = torch.zeros(shape, dtype=dtype, device=dev)
        heat = torch.zeros(shape if not iso else (), dtype=dtype,
                           device=dev)
        loss = torch.zeros((), dtype=dtype, device=dev)
        lls_loss = torch.zeros((), dtype=dtype, device=dev)
        pending = []
        akey = assign.tobytes()
        for b, radius in enumerate(self._radius_ladder()):
            idx = np.where(assign == b)[0]
            if len(idx) == 0:
                continue
            parts = []
            win_ok = cfg.window_sweep and 2 * radius + 1 <= n - 1
            if self._custom_raytracer:
                if (self._windowed is not None and win_ok
                        and self._windowed.supports(cfg, radius)):
                    ph, he, lo, ll, ps = self._windowed.sweep(
                        cfg, self.tables, radius, ndens, xh_av, lls_grid,
                        srcpos_np[idx], nflux_np[idx],
                        nfx_np[idx] if nfx_np is not None else None, sc)
                else:
                    cap = 1 << (len(idx) - 1).bit_length()
                    pos_p, flux_p, fx_p = self._bucket_arrays(
                        akey, b, cap, idx, srcpos_np, nflux_np, nfx_np)
                    ph, he, lo, ll, ps = self._rt(
                        cfg, self.tables, ndens, xh_av, pos_p, flux_p, sc,
                        lls_grid=lls_grid, max_shell=radius,
                        nflux_xray=fx_p)
                phih = phih + ph
                if not iso:
                    heat = heat + he
                loss = loss + lo
                lls_loss = lls_loss + ll
                parts.append(ps)
            elif win_ok:
                ndhi_pad = windowed_prepass(cfg, ndens, xh_av, radius)
                lls_pad = (wrap_pad(lls_grid, radius)
                           if lls_grid is not None else None)
                chunk = self._window_chunk_size(radius)
                pos_p, flux_p, fx_p = self._bucket_arrays(
                    akey, b, -(-len(idx) // chunk) * chunk, idx, srcpos_np,
                    nflux_np, nfx_np)
                acc = torch.zeros(padded_acc_shape(n, radius), dtype=dtype,
                                  device=dev)
                hacc = torch.zeros_like(acc) if not iso else None
                for i in range(0, pos_p.shape[0], chunk):
                    lo, ll, ps = windowed_batch(
                        cfg, self.tables, ndhi_pad, pos_p[i:i + chunk],
                        flux_p[i:i + chunk], sc, radius, acc, hacc,
                        lls_pad=lls_pad,
                        nfx=fx_p[i:i + chunk] if fx_p is not None else None)
                    loss = loss + lo
                    lls_loss = lls_loss + ll
                    parts.append(ps)
                phih = phih + fold_padded_acc(acc, n, radius)
                if not iso:
                    heat = heat + fold_padded_acc(hacc, n, radius)
            else:
                chunk = self._full_chunk_size()
                pos_p, flux_p, fx_p = self._bucket_arrays(
                    akey, b, -(-len(idx) // chunk) * chunk, idx, srcpos_np,
                    nflux_np, nfx_np)
                for i in range(0, pos_p.shape[0], chunk):
                    ph, he, lo, ll, ps = raytrace_all_sources(
                        cfg, self.tables, ndens, xh_av, pos_p[i:i + chunk],
                        flux_p[i:i + chunk], sc, lls_grid=lls_grid,
                        max_shell=radius,
                        nflux_xray=(fx_p[i:i + chunk] if fx_p is not None
                                    else None))
                    phih = phih + ph
                    if not iso:
                        heat = heat + he
                    loss = loss + lo
                    lls_loss = lls_loss + ll
                    parts.append(ps)
            pending.append((idx, torch.cat(parts)))
        return phih, heat, loss, lls_loss, pending

    def _promote(self, per_src, nflux_np, assign):
        """Escaping photons above loss_fraction of the source's output
        move it one rung up for the next convergence iteration
        (c2ray_parameters.f90:67, evolve_source.F90:128-136)."""
        ladder = self._radius_ladder()
        leaked = per_src > self.cfg.loss_fraction * np.maximum(nflux_np,
                                                               1e-300)
        return np.where(leaked & (assign < len(ladder) - 1),
                        assign + 1, assign)

    def _dense_x1(self, x):
        """The ionized fraction of an iterate (decodes compressed storage)."""
        return xh1_of(x) if self.cfg.compressed_xfrac else x

    def _loss_rate(self, ndens, xh_av, sc, ploss):
        """Boundary losses redistributed as a per-cell per-atom rate, each
        cell absorbing its share through its own column (the reference's
        dormant add_photon_losses block, evolve_point.F90:497-506, with
        photon_loss = photon_loss_all/N^3, evolve.F90:525); zero when
        nothing was lost.  The JAX twin's _lossrate_body."""
        cfg = self.cfg
        ndhi = neutral_density(cfg, ndens, xh_av)
        coldens_cell = ndhi * sc.dr
        phi = photoion_rates(cfg, self.tables, torch.zeros_like(coldens_cell),
                             coldens_cell, torch.ones_like(coldens_cell),
                             ploss / cfg.n_cells)
        rate = phi.photo_cell * sc.rate_scale / ndhi
        return torch.where(ploss > 0.0, rate, torch.zeros_like(rate))

    def _tail(self, dt, ndens, xh1, xh_int, xh_av, phih, clump, ploss, llsl,
              psrc, with_stats: bool, phiheat=None, t_cur=None, t_av=None,
              cosmo_cool_coeff=0.0, sc=None):
        """Loss redistribution (add_photon_losses) + chemistry + audit
        counts + convergence sum, packed with the per-source losses into
        one vector for a single host copy.  Non-isothermally the
        chemistry also integrates the temperature from t_cur under
        phiheat, and the audit takes its time-averaged temperature.  The
        audit is the chemistry kernel's own (its result's audit) where
        the chemistry ran as the kernel, else two grid_counts calls.
        -> (xh_int, xh_av, t_int, t_av, packed); the temperatures are None
        when isothermal."""
        cfg = self.cfg
        loss_rate = (self._loss_rate(ndens, xh_av, sc, ploss)
                     if cfg.add_photon_losses else 0.0)
        chem = self._chem(cfg, dt, ndens, xh1, xh_int, xh_av, phih,
                          phiheat, t_cur, t_av, clump, self.cool,
                          cosmo_cool_coeff, photon_loss_rate=loss_rate)
        sum1 = torch.sum(self._dense_x1(chem.xh1_intermed))
        dl = sum1.dtype
        sums = [sum1]
        if with_stats and chem.audit is not None:
            # the chemistry kernel's audit, taken in its output pass
            sums = torch.cat([sum1.view(1), chem.audit.to(dl)])
        elif with_stats:
            comp = cfg.compressed_xfrac
            ca = grid_counts(cfg, ndens, chem.xh1_intermed, chem.temper_av,
                             clump, compressed=comp)
            cr = grid_counts(cfg, ndens, chem.xh1_av, chem.temper_av, clump,
                             compressed=comp)
            sums += [ca.h0, ca.h1, cr.rec_rate, cr.coll_rate]
        if isinstance(sums, list):
            sums = torch.stack([torch.as_tensor(v, dtype=dl,
                                                device=sum1.device)
                                for v in sums])
        # one sum over the ranks for all of them where the state is a slab
        sums = self._gsum(sums)
        scalars = torch.cat([torch.stack([chem.conv_flag.to(dl), sums[0],
                                          ploss.to(dl), llsl.to(dl)]),
                             sums[1:]])
        packed = torch.cat([scalars, psrc.to(dl)])
        return (chem.xh1_intermed, chem.xh1_av, chem.temper_intermed,
                chem.temper_av, packed)

    # ------------------------------------------------------------------
    # the device-resident convergence loop (the JAX twin's _loop_program,
    # _rt_call and _evolve_device_loop)

    def device_loop_ok(self, use_adaptive: bool, verbose: bool = False,
                       dumper=None, clocks=None) -> bool:
        """Whether evolve3d takes the device loop (the JAX twin's rule,
        c2ray_tpu/solver.py:812-848): cfg.on_device_loop, not adaptive
        (those sweeps re-bucket on the host), not verbose (per-iteration
        prints), no dump due within the next minute (the host loop dumps
        per iteration; decided on the I/O rank and broadcast when there
        are several processes), no Clocks under cfg.timings_fidelity
        (the device loop's stamps are replayed at its end), mesh <= 512.
        The JAX rule's noniso_ok (a TPU worker-fault workaround) is not
        carried over."""
        cfg = self.cfg
        dump_ok = (dumper is None or not getattr(dumper, "enabled", False)
                   or (time.time() - dumper._last_wall)
                   < dumper.interval_s - 60.0)
        if dumper is not None:
            from .parallel import multihost as mh
            if mh.process_count() > 1:
                dump_ok = mh.broadcast_obj(dump_ok if mh.is_io_rank()
                                           else None)
        fidelity_ok = clocks is None or not cfg.timings_fidelity
        return bool(cfg.on_device_loop and not use_adaptive and not verbose
                    and dump_ok and fidelity_ok and cfg.mesh[0] <= 512)

    def _graph_loop(self) -> bool:
        """The device loop's form: a CUDA graph on a CUDA device without
        a parallel layout (gloo's collectives cannot be captured), else
        the same body uncaptured."""
        return (self.device.type == "cuda" and not self._custom_raytracer
                and self._chem is global_chemistry
                and self._rate_sharding is None)

    def _rt_call(self, a, c):
        """The sweep inside the loop body (the JAX _rt_call)."""
        return self._rt(self.cfg, self.tables, a.ndens, c.xh_av, a.srcpos,
                        a.nflux, a.sc, lls_grid=a.lls, nflux_xray=a.nfx)

    def _loop_cond(self, c, crit: int) -> torch.Tensor:
        """The loop's condition on the carry's 0-d tensors, in their dtype
        (the JAX twin's cond, c2ray_tpu/solver.py:508-517): not converged
        and niter <= max_global_iterations."""
        cfg = self.cfg
        cf = cfg.convergence_fraction
        sum1 = c.sum1
        sum0 = float(cfg.n_cells) - sum1
        one = torch.ones_like(sum1)
        rel1 = torch.where(sum1 > 0, torch.abs(sum1 - c.prev1) / sum1, one)
        rel0 = torch.where(sum0 > 0, torch.abs(sum0 - c.prev0) / sum0, one)
        conv = (c.conv < crit) | ((rel1 < cf) & (rel0 < cf))
        return ~conv & (c.niter <= cfg.max_global_iterations)

    def _loop_body(self, a, c) -> None:
        """One convergence iteration on the carry c (the JAX twin's body,
        c2ray_tpu/solver.py:519-546): sweep, tail, the history row, the
        previous iterates (for the dump), then the condition into c.go.
        No host read.  A static carry (the captured form) is updated in
        place, an eager one by rebinding."""
        have_t = not self.cfg.isothermal

        def put(name, value):
            if c.static:
                getattr(c, name).copy_(value)
            else:
                setattr(c, name, value)

        put("prev1", c.sum1)
        put("prev0", float(self.cfg.n_cells) - c.sum1)
        phih, phiheat, ploss, llsl, psrc = self._rt_call(a, c)
        xh_int, xh_av, t_int, t_av, packed = self._tail(
            a.dt, a.ndens, a.xh1, c.xh_int, c.xh_av, phih, a.clump, ploss,
            llsl, psrc, a.with_stats, phiheat, a.t_cur,
            c.t_av if have_t else None, a.coeff, a.sc)
        put("xh_int_p", c.xh_int)
        put("xh_av_p", c.xh_av)
        put("xh_int", xh_int)
        put("xh_av", xh_av)
        if have_t:
            put("t_int_p", c.t_int)
            put("t_av_p", c.t_av)
            put("t_int", t_int)
            put("t_av", t_av)
            put("phiheat", phiheat)
        put("phih", phih)
        put("psrc", packed[a.k:])
        c.hist.index_copy_(0, c.it.view(1).long(),
                           packed[:a.k].view(1, a.k))
        put("sum1", packed[1])
        put("conv", packed[0])
        put("niter", c.niter + 1)
        put("it", c.it + 1)
        put("go", self._loop_cond(c, a.crit))

    def _loop_start(self, c, xh_int, xh_av, t_int, t_av, sum1, conv_flag0,
                    niter0) -> None:
        """Set the carry to the loop's start (the JAX carry0): the
        iterates, the convergence scalars, an empty history; then the
        condition into c.go."""
        cfg = self.cfg
        dl = c.hist.dtype
        big = 2.0 * float(cfg.n_cells)
        start = dict(xh_int=xh_int, xh_av=xh_av, xh_int_p=xh_int,
                     xh_av_p=xh_av, prev1=big, prev0=big, sum1=sum1,
                     conv=float(conv_flag0), niter=int(niter0), it=0)
        if not cfg.isothermal:
            start.update(t_int=t_int, t_av=t_av, t_int_p=t_int, t_av_p=t_av)
        for name, v in start.items():
            if c.static:
                getattr(c, name).copy_(v) if isinstance(v, torch.Tensor) \
                    else getattr(c, name).fill_(v)
            elif isinstance(v, torch.Tensor):
                setattr(c, name, v)
            else:
                setattr(c, name, torch.full(
                    (), v, device=self.device,
                    dtype=torch.int32 if name in ("niter", "it") else dl))
        c.hist.zero_()
        if c.static:
            c.go.copy_(self._loop_cond(c, c.crit))
        else:
            c.go = self._loop_cond(c, c.crit)

    def _loop_carry(self, a, static: bool, template) -> SimpleNamespace:
        """A carry: history, the per-source losses' and rate grids'
        buffers, and (static) every other entry allocated once, for a
        captured body to update in place."""
        cfg = self.cfg
        dl = cfg.torch_dtype
        dev = self.device
        max_rows = cfg.max_global_iterations + 2
        c = SimpleNamespace(
            static=static, crit=a.crit,
            hist=torch.zeros((max_rows, a.k), dtype=dl, device=dev),
            psrc=torch.zeros(a.srcpos.shape[0], dtype=dl, device=dev))
        n = cfg.mesh[0]
        c.phih = torch.zeros((n, n, n), dtype=dl, device=dev)
        c.phiheat = torch.zeros((n, n, n) if not cfg.isothermal else (),
                                dtype=dl, device=dev)
        if static:
            cubes = ["xh_int", "xh_av", "xh_int_p", "xh_av_p"]
            if not cfg.isothermal:
                cubes += ["t_int", "t_av", "t_int_p", "t_av_p"]
            for name in cubes:
                setattr(c, name, torch.empty_like(template))
            for name in ("prev1", "prev0", "sum1", "conv"):
                setattr(c, name, torch.zeros((), dtype=dl, device=dev))
            c.niter = torch.zeros((), dtype=torch.int32, device=dev)
            c.it = torch.zeros((), dtype=torch.int32, device=dev)
            c.go = torch.zeros((), dtype=torch.bool, device=dev)
        return c

    def _run_graph_loop(self, a, xh_int, xh_av, t_int, t_av, sum1,
                        conv_flag0, niter0):
        """The device loop as one launch of a CUDA graph: the body
        captured once per static signature (the JAX twin's key
        (with_stats, have_lls, have_x, have_t)) and what the capture bakes
        in (the source count, dtype and a scalar clumping); a new baked
        value captures anew.  The per-step scalars (dt, the sweep scalars,
        cosmo_cool_coeff) and the inputs go into the graph's static
        buffers before each launch, where the kernels and ops read them.
        A capture's first iteration runs uncaptured, which warms the
        kernels.  -> (carry, info)"""
        from .cuda_graph import WhileGraph

        cfg = self.cfg
        have_t = not cfg.isothermal
        clump_grid = isinstance(a.clump, torch.Tensor)
        key = (a.with_stats, a.lls is not None, a.nfx is not None, have_t)
        baked = (int(a.srcpos.shape[0]), cfg.torch_dtype,
                 tuple(a.clump.shape) if clump_grid else float(a.clump))
        entry = self._loop_cache.get(key)
        if entry is not None and entry.baked != baked:
            if entry.graph is not None:
                entry.graph.close()
            entry = None
        inputs = ("ndens", "xh1", "t_cur", "srcpos", "nflux", "nfx", "lls")
        inputs += ("clump",) if clump_grid else ()
        if entry is None:
            self._loop_cache.pop(key, None)
            st = SimpleNamespace(**vars(a))
            for name in inputs:
                v = getattr(a, name)
                setattr(st, name, v.clone() if v is not None else None)
            # dt, the sweep scalars and cosmo_cool_coeff as float64 on the
            # device: the kernels read them at each replay
            step = torch.zeros(6, dtype=torch.float64, device=self.device)
            st.sc = SweepScalars(*step[:4])
            st.dt, st.coeff = step[4], step[5]
            entry = SimpleNamespace(baked=baked, a=st, step=step,
                                    c=self._loop_carry(st, True, a.xh1),
                                    graph=None)
            self._loop_cache[key] = entry
        else:
            for name in inputs:
                if getattr(a, name) is not None:
                    getattr(entry.a, name).copy_(getattr(a, name))
        entry.step.copy_(torch.tensor(list(a.sc) + [a.dt, a.coeff],
                                      dtype=torch.float64))
        st, c = entry.a, entry.c
        self._loop_start(c, xh_int, xh_av, t_int, t_av, sum1, conv_flag0,
                         niter0)
        info = dict(form="graph", host_reads=0, graph_launches=0,
                    capture_s=0.0, nodes=None, warmup=0)
        if entry.graph is None:
            info["host_reads"] += 1
            if not bool(c.go):
                return c, info
            self._loop_body(st, c)
            info["warmup"] = 1
            entry.graph = WhileGraph(lambda: self._loop_body(st, c), c.go)
            info["capture_s"] = entry.graph.capture_s
        info["nodes"] = entry.graph.nodes
        entry.graph.run()
        info["graph_launches"] = 1
        return c, info

    def _evolve_device_loop(self, ndens, srcpos_t, nflux_t, nfx_t, lls_t,
                            sc, clump, coeff, dt, vol, xh1, xh_int, xh_av,
                            t_cur, t_av, t_int, niter0, conv_flag0, sum1_0,
                            conv_criterion, num_src, total_flux, stats,
                            with_stats, last_stat4, dumper, clocks,
                            photon_loss0, lls_loss0, phih0, phiheat0):
        """The whole timestep's convergence loop on the device, then the
        host's replay of the per-iteration photon reports, Timings stamps
        and the dump (the JAX twin's _evolve_device_loop,
        c2ray_tpu/solver.py:567-667)."""
        cfg = self.cfg
        n_cells = cfg.n_cells
        have_t = not cfg.isothermal
        dl = cfg.torch_dtype
        k = 8 if with_stats else 4
        if sum1_0 is None:
            sum1_dev = self._gsum(torch.sum(self._dense_x1(xh_int)))
        else:
            sum1_dev = torch.full((), sum1_0, dtype=dl, device=self.device)
        a = SimpleNamespace(ndens=ndens, xh1=xh1, t_cur=t_cur, srcpos=srcpos_t,
                            nflux=nflux_t, nfx=nfx_t, lls=lls_t, clump=clump,
                            sc=sc, dt=dt, coeff=coeff, with_stats=with_stats,
                            k=k, crit=int(conv_criterion))
        if self._graph_loop():
            c, info = self._run_graph_loop(a, xh_int, xh_av, t_int, t_av,
                                           sum1_dev, conv_flag0, niter0)
        else:
            c = self._loop_carry(a, False, xh1)
            self._loop_start(c, xh_int, xh_av, t_int, t_av, sum1_dev,
                             conv_flag0, niter0)
            reads = 0
            while True:
                reads += 1
                if not bool(c.go):        # one host read per iteration
                    break
                self._loop_body(a, c)
            info = dict(form="eager", host_reads=reads, graph_launches=0,
                        capture_s=0.0, nodes=None, warmup=0)
        # the one device-to-host copy of the loop's results
        scal = torch.stack([c.sum1, c.conv, c.niter.to(dl), c.it.to(dl),
                            c.prev1, c.prev0])
        got = torch.cat([scal, c.hist.reshape(-1), c.psrc.to(dl)]
                        ).cpu().numpy()
        info["host_reads"] += 1
        sum1 = float(got[0])
        conv_flag = int(got[1])
        niter = int(got[2])
        it_count = int(got[3])
        prev1, prev0 = float(got[4]), float(got[5])
        max_rows = cfg.max_global_iterations + 2
        hist = got[6:6 + max_rows * k].reshape(max_rows, k)
        psrc = got[6 + max_rows * k:].astype(np.float64)
        info["iterations"] = it_count
        self.last_loop = info

        # the host's replay: per-iteration photon reports and Timings
        # stamps, the streams the host loop writes
        last_report = {}
        photon_loss, lls_loss = photon_loss0, lls_loss0
        stat4 = last_stat4

        def apply_stat4(s4):
            stats.calculate(GridCounts(s4[0], s4[1], 0.0, 0.0),
                            GridCounts(0.0, 0.0, s4[2], s4[3]), vol, dt)

        for row in hist[:it_count]:
            photon_loss, lls_loss = float(row[2]), float(row[3])
            if with_stats:
                stat4 = tuple(float(v) for v in row[4:8])
                apply_stat4(stat4)
                last_report = stats.report(dt, photon_loss, lls_loss,
                                           total_flux)
        if clocks is not None:
            for i in range(niter - it_count + 1, niter + 1):
                clocks.stamp(f"Time after iteration {i}")
        # the dump carries the last iteration's pre-chemistry iterates and
        # rate grids, as in the host loop
        if dumper is not None and it_count > 0:
            dumper.maybe_dump(niter, photon_loss, c.phih, c.xh_av_p,
                              c.xh_int_p, c.phiheat if have_t else None,
                              c.t_int_p if have_t else None,
                              c.t_av_p if have_t else None)
        # the final convergence classification (the cond, on the host)
        sum0 = float(n_cells) - sum1
        rel1 = abs(sum1 - prev1) / sum1 if sum1 > 0 else 1.0
        rel0 = abs(sum0 - prev0) / sum0 if sum0 > 0 else 1.0
        converged = conv_flag < conv_criterion or (
            rel1 < cfg.convergence_fraction
            and rel0 < cfg.convergence_fraction)

        # a captured carry is reused by the next step: the results are
        # copies of it
        own = (lambda t: t.clone()) if c.static else (lambda t: t)
        xh_int_f = own(c.xh_int)
        xh_av_f = own(c.xh_av)
        t_int_f = own(c.t_int) if have_t else None
        t_av_f = own(c.t_av) if have_t else t_av
        if it_count > 0:
            phih_f = own(c.phih)
            phiheat_f = own(c.phiheat) if have_t else None
        else:
            phih_f, phiheat_f = phih0, phiheat0
        if stats is not None:
            if stat4 is None:
                stats.calculate(self._counts(ndens, xh_int_f, t_av_f, clump),
                                self._counts(ndens, xh_av_f, t_av_f, clump),
                                vol, dt)
            else:
                apply_stat4(stat4)
            last_report = stats.report(dt, photon_loss, lls_loss, total_flux)
            stats.update_grandtotal(dt, total_flux)
        new_state = GridState(xh1=xh_int_f, temper_current=t_int_f,
                              temper_av=t_av_f if have_t else None,
                              temper_intermed=t_int_f)
        return new_state, EvolveInfo(
            niter=niter, conv_flag=conv_flag, converged=converged,
            mean_xh1=sum1 / n_cells, photon_loss=photon_loss,
            lls_loss=lls_loss, per_source_loss=psrc[:num_src],
            photon_stats=last_report, phih=phih_f,
            phiheat=phiheat_f if have_t else None)

    def evolve3d(self, state: GridState, ndens_proper: torch.Tensor,
                 dr_proper: float, srcpos, nflux, dt: float,
                 clumping=1.0, lls_coldens: float = 0.0,
                 rmax_cells: float = 0.0, lls_grid=None,
                 cosmo_cool_coeff: float = 0.0,
                 stats: Optional[PhotonStatistics] = None,
                 dumper=None, iter_restart: Optional[dict] = None,
                 nflux_xray=None, verbose: bool = False, clocks=None):
        """One global timestep (evolve3D, evolve.F90:83-281); the
        signature is the JAX twin's.  lls_grid: the (N,N,N) LLS column
        cube of type 2 (models.lls.set_lls(...).grid); rmax_cells: type
        3's barrier radius; nflux_xray: (S,) X-ray fluxes in pl_s_star
        units, used when cfg.sed.use_xray_sed.  dumper: a
        utils.checkpoint.IterDumper, offered every iteration's
        post-sweep, pre-chemistry iterates and rate grids
        (evolve.F90:253-266); iter_restart: a dict from IterDumper.load,
        whose pending chemistry pass runs first, with no re-sweep
        (start_from_dump, evolve.F90:154-158, 328-426); clocks: a
        utils.clocks.Clocks, stamped after every iteration
        (evolve.F90:272-273)."""
        cfg = self.cfg
        dev = self.device
        dtype = cfg.torch_dtype
        n_cells = cfg.n_cells
        vol = float(dr_proper) ** 3

        srcpos_np = np.asarray(srcpos, np.int64).reshape(-1, 3)
        nflux_np = np.asarray(nflux, np.float64).reshape(-1)
        num_src = int(srcpos_np.shape[0])
        # auto: adaptive subbox radii in the many-source regime
        # (evolve_source.F90:128-136)
        use_adaptive = (cfg.adaptive_sweep if cfg.adaptive_sweep is not None
                        else num_src >= cfg.adaptive_auto_min_sources)
        radius_assign = None            # adaptive rung per source (per step)
        rungs = [] if use_adaptive else None
        if use_adaptive:
            check_window_positions(srcpos_np, cfg.mesh[0])
            # a new timestep (new catalog) invalidates the bucket arrays
            self._abucket_cache = (None, {})
        srcpos_t = torch.as_tensor(srcpos_np, dtype=torch.int32, device=dev)
        nflux_t = torch.as_tensor(nflux_np, dtype=dtype, device=dev)
        use_xray = cfg.sed.use_xray_sed and nflux_xray is not None
        nfx_np = (np.asarray(nflux_xray, np.float64).reshape(-1)
                  if use_xray else None)
        nfx_t = (torch.as_tensor(nfx_np, dtype=dtype, device=dev)
                 if use_xray else None)
        lls_t = (torch.as_tensor(lls_grid, dtype=dtype, device=dev)
                 if lls_grid is not None else None)
        sc = sweep_scalars(cfg, dr_proper, lls_coldens, rmax_cells)
        # rounded once to the working dtype, as the JAX twin's device scalar
        coeff = float(cfg.np_dtype(cosmo_cool_coeff))
        clump = (torch.as_tensor(clumping, device=dev).to(dtype)
                 if isinstance(clumping, (torch.Tensor, np.ndarray))
                 else clumping)
        ndens = ndens_proper.to(device=dev, dtype=dtype)

        if stats is not None:
            stats.state_before(self._counts(ndens, state.xh1,
                                            state.temper_av, clump), vol)

        xh1 = state.xh1
        # temperatures (None when isothermal): the step-initial current
        # one, and the average and end-of-step iterates
        t_cur, t_av, t_int = (state.temper_current, state.temper_av,
                              state.temper_intermed)
        # the iterates start from the step-initial state
        # (evolve.F90:140-153), or from an iteration dump (:154-158)
        if iter_restart is not None:
            def restored(key):
                x = np.asarray(iter_restart[key])
                rs = self._rate_sharding
                # a whole dump cube -> this rank's rows: the state's under
                # halo, the rate grids' under dom and halo
                if rs is not None and x.shape[0] != rs.rows[1] and (
                        rs.state or key in ("phih", "phiheat")):
                    x = x[rs.rows[0]:rs.rows[0] + rs.rows[1]]
                return torch.as_tensor(x, device=dev).to(dtype)
            xh_av = restored("xh_av")
            xh_int = restored("xh_intermed")
            niter = int(iter_restart["niter"])
            if not cfg.isothermal and "temper" in iter_restart:
                t_int = restored("temper")
            if not cfg.isothermal and "temper_av" in iter_restart:
                t_av = restored("temper_av")
        else:
            xh_av = xh1
            xh_int = xh1
            niter = 0
        conv_flag = n_cells
        prev_sum1 = 2.0 * n_cells
        prev_sum0 = 2.0 * n_cells
        # conv_criterion (evolve.F90:162-163)
        conv_criterion = min(int(cfg.convergence_fraction * n_cells),
                             (num_src - 1) // 3)

        photon_loss = 0.0
        lls_loss = 0.0
        per_src_loss = np.zeros(num_src)
        converged = False
        last_report = {}
        last_stat4 = None
        # the initial radii, the promotions and total_flux read the stellar
        # fluxes alone, as in the JAX twin (X-ray photons are not counted
        # there): keep it so
        total_flux = float(nflux_np.sum())
        phih = phiheat = None
        with_stats = stats is not None
        sum1 = None

        def apply_stat4(s4):
            stats.calculate(GridCounts(s4[0], s4[1], 0.0, 0.0),
                            GridCounts(0.0, 0.0, s4[2], s4[3]), vol, dt)

        # the pending global pass of a resumed step: the dump was written
        # after the sweep, before the chemistry (evolve.F90:253-269), so
        # the restored rates go straight into the chemistry, no re-sweep
        if iter_restart is not None and "phih" in iter_restart:
            phih = restored("phih")
            if not cfg.isothermal and "phiheat" in iter_restart:
                phiheat = restored("phiheat")
            photon_loss = float(iter_restart["photon_loss"])
            zero = torch.zeros((), dtype=dtype, device=dev)
            xh_int, xh_av, t_int_d, t_av_d, packed = self._tail(
                dt, ndens, state.xh1, xh_int, xh_av, phih, clump,
                torch.tensor(photon_loss, dtype=dtype, device=dev), zero,
                torch.zeros(0, dtype=dtype, device=dev), with_stats, phiheat, t_cur, t_av, coeff, sc)
            if not cfg.isothermal:
                t_int, t_av = t_int_d, t_av_d
            got = packed.cpu().numpy()
            conv_flag = int(got[0])
            sum1 = float(got[1])
            if with_stats:
                last_stat4 = tuple(float(v) for v in got[4:8])
                apply_stat4(last_stat4)
                last_report = stats.report(dt, photon_loss, lls_loss,
                                           total_flux)

        # the device-resident loop where the JAX rule takes it; the
        # pending pass of a resumed step has run first
        if self.device_loop_ok(use_adaptive, verbose, dumper, clocks):
            return self._evolve_device_loop(
                ndens, srcpos_t, nflux_t, nfx_t, lls_t, sc, clump, coeff, dt,
                vol, xh1, xh_int, xh_av, t_cur, t_av, t_int, niter,
                conv_flag, sum1, conv_criterion, num_src, total_flux, stats,
                with_stats, last_stat4, dumper, clocks, photon_loss,
                lls_loss, phih, phiheat)

        while True:
            # convergence tests (evolve.F90:179-233)
            if sum1 is None:
                sum1 = float(self._gsum(torch.sum(self._dense_x1(xh_int))))
            sum0 = float(n_cells) - sum1
            rel1 = abs(sum1 - prev_sum1) / sum1 if sum1 > 0.0 else 1.0
            rel0 = abs(sum0 - prev_sum0) / sum0 if sum0 > 0.0 else 1.0
            if verbose:
                print(f"  iter {niter}: conv_flag={conv_flag} "
                      f"rel_change=({rel1:.2e},{rel0:.2e}) "
                      f"mean_x={sum1 / n_cells:.4e}")
            if conv_flag < conv_criterion or (
                    rel1 < cfg.convergence_fraction
                    and rel0 < cfg.convergence_fraction):
                xh1 = xh_int
                # set_final_temperature_point (temperature_module.F90:173-183)
                t_cur = t_int
                converged = True
                break
            if niter > cfg.max_global_iterations:
                # commit the best available iterate, flagged unconverged
                xh1 = xh_int
                t_cur = t_int
                break

            prev_sum1, prev_sum0 = sum1, sum0
            niter += 1

            if use_adaptive:
                if radius_assign is None:
                    mean = (torch.mean(ndens) if self._rate_sharding is None
                            or not self._rate_sharding.state
                            else self._gsum(torch.sum(ndens)) / n_cells)
                    radius_assign = self._initial_radii(
                        nflux_np, float(mean), float(dr_proper), dt)
                rungs.append(np.bincount(
                    radius_assign,
                    minlength=len(self._radius_ladder())).tolist())
                phih, phiheat, ploss_d, llsl_d, pending = \
                    self._adaptive_sweep(ndens, xh_av, srcpos_np, nflux_np,
                                         sc, radius_assign, lls_t, nfx_np)
                psrc_d = torch.cat([ps for _, ps in pending])
            else:
                phih, phiheat, ploss_d, llsl_d, psrc_d = self._rt(
                    cfg, self.tables, ndens, xh_av, srcpos_t, nflux_t, sc,
                    lls_grid=lls_t, nflux_xray=nfx_t)
            # the pre-chemistry iterates, for the iteration dump
            pre = (xh_av, xh_int, t_int, t_av)
            xh_int, xh_av, t_int_d, t_av_d, packed = self._tail(
                dt, ndens, state.xh1, xh_int, xh_av, phih, clump, ploss_d,
                llsl_d, psrc_d, with_stats, phiheat, t_cur, t_av, coeff, sc)
            if not cfg.isothermal:
                t_int, t_av = t_int_d, t_av_d

            got = packed.cpu().numpy()      # the one blocking copy
            conv_flag = int(got[0])
            sum1 = float(got[1])
            photon_loss = float(got[2])
            lls_loss = float(got[3])
            k = 4
            if with_stats:
                last_stat4 = tuple(float(v) for v in got[4:8])
                k = 8
            if use_adaptive:
                per_src_loss = np.zeros(num_src)
                for idx, ps in pending:
                    m = int(ps.shape[0])
                    per_src_loss[idx] = got[k:k + m][:len(idx)]
                    k += m
                radius_assign = self._promote(per_src_loss, nflux_np,
                                              radius_assign)
            else:
                per_src_loss = got[k:k + num_src].astype(np.float64)

            # the wall-clock-driven double-buffered dump of the post-sweep,
            # pre-chemistry iterates and rate grids (evolve.F90:253-266),
            # so a resume re-enters at the pending global pass
            if dumper is not None:
                iso = cfg.isothermal
                dumper.maybe_dump(niter, photon_loss, phih, pre[0], pre[1],
                                  None if iso else phiheat,
                                  None if iso else pre[2],
                                  None if iso else pre[3])
            if with_stats:
                apply_stat4(last_stat4)
                last_report = stats.report(dt, photon_loss, lls_loss,
                                           total_flux)
            if clocks is not None:
                clocks.stamp(f"Time after iteration {niter}")

        # end-of-step statistics (evolve.F90:277-279)
        if stats is not None:
            if last_stat4 is None:
                stats.calculate(self._counts(ndens, xh1, t_av, clump),
                                self._counts(ndens, xh_av, t_av, clump),
                                vol, dt)
            else:
                apply_stat4(last_stat4)
            last_report = stats.report(dt, photon_loss, lls_loss, total_flux)
            stats.update_grandtotal(dt, total_flux)

        new_state = GridState(xh1=xh1, temper_current=t_cur, temper_av=t_av,
                              temper_intermed=t_int)
        info = EvolveInfo(
            niter=niter, conv_flag=conv_flag, converged=converged,
            mean_xh1=sum1 / n_cells, photon_loss=photon_loss,
            lls_loss=lls_loss, per_source_loss=per_src_loss,
            photon_stats=last_report, phih=phih,
            phiheat=phiheat if not cfg.isothermal else None, rungs=rungs)
        return new_state, info
