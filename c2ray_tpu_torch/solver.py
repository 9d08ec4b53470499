"""evolve3D: the global convergence iteration over sources + chemistry,
PyTorch port of c2ray_tpu/solver.py (evolve.F90:83-281), isothermal path,
with the adaptive subbox-radius sweep of the many-source regime.

One call evolves the grid over a timestep dt by iterating
[sweep all sources -> global chemistry -> photon audit] until the grid
converges.  The host drives the loop: each iteration dispatches the sweep
and the chemistry tail, then makes ONE device-to-host copy of the packed
scalars [conv_flag, sum_xh1, photon_loss, lls_loss, (h0, h1, rec, coll)]
and the per-source losses.  The JAX package's device-resident
lax.while_loop has no counterpart yet.

Adaptive sweeps (evolve_source.F90:128-212): every source starts at a
Stroemgren-estimated radius on a power-of-two ladder of rungs; rungs whose
(2r+1)^3 window fits in the grid are swept windowed, the top rung over the
full cube, and a source whose escaping photons exceed loss_fraction of its
flux moves one rung up for the next convergence iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import RunConfig, resolve_device
from .ops.chemistry import global_chemistry
from .ops.photonstats import GridCounts, PhotonStatistics, grid_counts
from .ops.sweep import (check_window_positions, raytrace_all_sources,
                        sweep_scalars, windowed_batch, windowed_prepass)
from .ops.tables import RadTables, use_expsum
from .state import GridState


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
    phiheat: Optional[torch.Tensor] = None   # None: isothermal
    # adaptive sweeps: sources per radius rung in each convergence
    # iteration, as swept (a port-only field; None when not adaptive)
    rungs: Optional[list] = None


def check_supported(cfg: RunConfig, device: torch.device) -> None:
    """Raise NotImplementedError for every option outside this slice of
    the port (each is listed as work still to port in ROADMAP.md)."""
    rejected = [
        (not cfg.isothermal, "non-isothermal runs"),
        (cfg.use_lls and cfg.type_of_lls != 1,
         f"LLS type {cfg.type_of_lls} (only LLS off or type 1)"),
        (cfg.sed.use_xray_sed, "X-ray sources"),
        (cfg.compressed_xfrac, "compressed_xfrac storage"),
        (cfg.add_photon_losses, "add_photon_losses"),
        (not (cfg.mesh[0] == cfg.mesh[1] == cfg.mesh[2]), "non-cubic meshes"),
        (cfg.dtype not in ("float32", "float64"), f"dtype {cfg.dtype}"),
        (device.type == "cuda" and cfg.dtype != "float32",
         "float64 on CUDA (the kernels are float32)"),
        (device.type == "cuda" and not use_expsum(cfg, cfg.torch_dtype),
         f"rate_eval={cfg.rate_eval!r} on CUDA (table rates run on the CPU)"),
        (device.type not in ("cpu", "cuda"), f"device {device}"),
    ]
    for bad, what in rejected:
        if bad:
            raise NotImplementedError(
                f"{what} not ported to c2ray_tpu_torch yet")


class Evolve3D:
    """evolve3D solver for a fixed config + tables on one device.

    device: None means CUDA (and raises when there is none); the tests
    pass "cpu", where the sweep runs its plain PyTorch versions.
    """

    def __init__(self, cfg: RunConfig, tables: RadTables, device=None):
        self.device = resolve_device(device)
        check_supported(cfg, self.device)
        self.cfg = cfg
        self.tables = RadTables(*[t.to(self.device) if t is not None
                                  else None for t in tables])
        # per-timestep cache of padded per-bucket device source arrays,
        # rebuilt only when promotions change the assignment
        self._abucket_cache = (None, {})

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

    def _bucket_arrays(self, key, b, cap, idx, srcpos_np, nflux_np):
        """Padded device source arrays of one rung (cached across
        convergence iterations under the assignment key)."""
        ck, store = self._abucket_cache
        if ck != key:
            store = {}
            self._abucket_cache = (key, store)
        hit = store.get((b, cap))
        if hit is not None:
            return hit
        pos_p = np.zeros((cap, 3), np.int32)
        flux_p = np.zeros(cap)
        pos_p[:len(idx)] = srcpos_np[idx]
        flux_p[:len(idx)] = nflux_np[idx]
        out = (torch.as_tensor(pos_p, device=self.device),
               torch.as_tensor(flux_p, dtype=self.cfg.torch_dtype,
                               device=self.device))
        store[(b, cap)] = out
        return out

    def _adaptive_sweep(self, ndens, xh_av, srcpos_np, nflux_np, sc, assign):
        """Sweep the sources rung by rung (the JAX _adaptive_sweep without
        its injected-raytracer branches): windowed rungs in fixed-size
        batches through ops.sweep.windowed_batch into one padded
        accumulator per rung, folded into the rate grid at the rung's end;
        the full-cube rung in fixed-size chunks through
        raytrace_all_sources.  No host sync: the per-source losses come
        back as (indices, device tensor) pairs for the iteration's one
        copy."""
        from .ops.window_cuda import fold_padded_acc, padded_acc_shape

        cfg = self.cfg
        dtype, dev = cfg.torch_dtype, self.device
        n = cfg.mesh[0]
        phih = torch.zeros((n, n, n), dtype=dtype, device=dev)
        loss = torch.zeros((), dtype=dtype, device=dev)
        lls_loss = torch.zeros((), dtype=dtype, device=dev)
        pending = []
        akey = assign.tobytes()
        for b, radius in enumerate(self._radius_ladder()):
            idx = np.where(assign == b)[0]
            if len(idx) == 0:
                continue
            parts = []
            if cfg.window_sweep and 2 * radius + 1 <= n - 1:
                ndhi_pad = windowed_prepass(cfg, ndens, xh_av, radius)
                chunk = self._window_chunk_size(radius)
                pos_p, flux_p = self._bucket_arrays(
                    akey, b, -(-len(idx) // chunk) * chunk, idx, srcpos_np,
                    nflux_np)
                acc = torch.zeros(padded_acc_shape(n, radius), dtype=dtype,
                                  device=dev)
                for i in range(0, pos_p.shape[0], chunk):
                    lo, ll, ps = windowed_batch(
                        cfg, self.tables, ndhi_pad, pos_p[i:i + chunk],
                        flux_p[i:i + chunk], sc, radius, acc)
                    loss = loss + lo
                    lls_loss = lls_loss + ll
                    parts.append(ps)
                phih = phih + fold_padded_acc(acc, n, radius)
            else:
                chunk = self._full_chunk_size()
                pos_p, flux_p = self._bucket_arrays(
                    akey, b, -(-len(idx) // chunk) * chunk, idx, srcpos_np,
                    nflux_np)
                for i in range(0, pos_p.shape[0], chunk):
                    ph, _, lo, ll, ps = raytrace_all_sources(
                        cfg, self.tables, ndens, xh_av, pos_p[i:i + chunk],
                        flux_p[i:i + chunk], sc, max_shell=radius)
                    phih = phih + ph
                    loss = loss + lo
                    lls_loss = lls_loss + ll
                    parts.append(ps)
            pending.append((idx, torch.cat(parts)))
        return phih, loss, lls_loss, pending

    def _promote(self, per_src, nflux_np, assign):
        """Escaping photons above loss_fraction of the source's output
        move it one rung up for the next convergence iteration
        (c2ray_parameters.f90:67, evolve_source.F90:128-136)."""
        ladder = self._radius_ladder()
        leaked = per_src > self.cfg.loss_fraction * np.maximum(nflux_np,
                                                               1e-300)
        return np.where(leaked & (assign < len(ladder) - 1),
                        assign + 1, assign)

    def _tail(self, dt, ndens, xh1, xh_int, xh_av, phih, clump, ploss, llsl,
              psrc, with_stats: bool):
        """Chemistry + audit counts + convergence sum, packed with the
        per-source losses into one vector for a single host copy."""
        cfg = self.cfg
        chem = global_chemistry(cfg, dt, ndens, xh1, xh_int, xh_av, phih,
                                clumping=clump)
        sum1 = torch.sum(chem.xh1_intermed)
        dl = sum1.dtype
        scalars = [chem.conv_flag.to(dl), sum1, ploss.to(dl), llsl.to(dl)]
        if with_stats:
            ca = grid_counts(cfg, ndens, chem.xh1_intermed, None, clump)
            cr = grid_counts(cfg, ndens, chem.xh1_av, None, clump)
            scalars += [ca.h0, ca.h1, cr.rec_rate, cr.coll_rate]
        packed = torch.cat([torch.stack(scalars), psrc.to(dl)])
        return chem.xh1_intermed, chem.xh1_av, packed

    def evolve3d(self, state: GridState, ndens_proper: torch.Tensor,
                 dr_proper: float, srcpos, nflux, dt: float,
                 clumping=1.0, lls_coldens: float = 0.0,
                 rmax_cells: float = 0.0, lls_grid=None,
                 cosmo_cool_coeff: float = 0.0,
                 stats: Optional[PhotonStatistics] = None,
                 dumper=None, iter_restart: Optional[dict] = None,
                 nflux_xray=None, verbose: bool = False, clocks=None):
        """One global timestep (evolve3D, evolve.F90:83-281).  The
        signature is the JAX twin's; lls_grid, nflux_xray, dumper,
        iter_restart and clocks accept only None in this slice."""
        cfg = self.cfg
        for val, what in ((lls_grid, "lls_grid"), (nflux_xray, "nflux_xray"),
                          (dumper, "dumper"), (iter_restart, "iter_restart"),
                          (clocks, "clocks")):
            if val is not None:
                raise NotImplementedError(
                    f"{what} is not ported to c2ray_tpu_torch yet")
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
        sc = sweep_scalars(cfg, dr_proper, lls_coldens, rmax_cells)
        clump = (clumping.to(device=dev, dtype=dtype)
                 if isinstance(clumping, torch.Tensor) else clumping)
        ndens = ndens_proper.to(device=dev, dtype=dtype)

        if stats is not None:
            stats.state_before(grid_counts(cfg, ndens, state.xh1, None,
                                           clump), vol)

        xh1 = state.xh1
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
        total_flux = float(nflux_np.sum())
        phih = None
        with_stats = stats is not None
        sum1 = None

        def apply_stat4(s4):
            stats.calculate(GridCounts(s4[0], s4[1], 0.0, 0.0),
                            GridCounts(0.0, 0.0, s4[2], s4[3]), vol, dt)

        while True:
            # convergence tests (evolve.F90:179-233)
            if sum1 is None:
                sum1 = float(torch.sum(xh_int))
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
                converged = True
                break
            if niter > cfg.max_global_iterations:
                # commit the best available iterate, flagged unconverged
                xh1 = xh_int
                break

            prev_sum1, prev_sum0 = sum1, sum0
            niter += 1

            if use_adaptive:
                if radius_assign is None:
                    radius_assign = self._initial_radii(
                        nflux_np, float(torch.mean(ndens)), float(dr_proper),
                        dt)
                rungs.append(np.bincount(
                    radius_assign,
                    minlength=len(self._radius_ladder())).tolist())
                phih, ploss_d, llsl_d, pending = self._adaptive_sweep(
                    ndens, xh_av, srcpos_np, nflux_np, sc, radius_assign)
                psrc_d = torch.cat([ps for _, ps in pending])
            else:
                phih, _, ploss_d, llsl_d, psrc_d = raytrace_all_sources(
                    cfg, self.tables, ndens, xh_av, srcpos_t, nflux_t, sc)
            xh_int, xh_av, packed = self._tail(
                dt, ndens, state.xh1, xh_int, xh_av, phih, clump, ploss_d,
                llsl_d, psrc_d, with_stats)

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

            if with_stats:
                apply_stat4(last_stat4)
                last_report = stats.report(dt, photon_loss, lls_loss,
                                           total_flux)

        # end-of-step statistics (evolve.F90:277-279)
        if stats is not None:
            if last_stat4 is None:
                ca = grid_counts(cfg, ndens, xh1, None, clump)
                cr = grid_counts(cfg, ndens, xh_av, None, clump)
                stats.calculate(ca, cr, vol, dt)
            else:
                apply_stat4(last_stat4)
            last_report = stats.report(dt, photon_loss, lls_loss, total_flux)
            stats.update_grandtotal(dt, total_flux)

        new_state = GridState(xh1=xh1)
        info = EvolveInfo(
            niter=niter, conv_flag=conv_flag, converged=converged,
            mean_xh1=sum1 / n_cells, photon_loss=photon_loss,
            lls_loss=lls_loss, per_source_loss=per_src_loss,
            photon_stats=last_report, phih=phih, phiheat=None, rungs=rungs)
        return new_state, info
