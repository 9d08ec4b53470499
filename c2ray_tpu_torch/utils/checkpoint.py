"""Checkpoint and resume: the reference's three restart mechanisms
(PyTorch port of c2ray_tpu/utils/checkpoint.py, one process).

  1. Slice restart: resume at a redshift-slice boundary from the run's
     own xfrac3D_<z>.bin (+ Temper3D) outputs (C2Ray.F90:234-237,
     ionfractions_module.F90:56-120, temperature_module.F90:75-130).
  2. Mid-slice restart: the same at an intermediate output redshift
     (C2Ray.F90:238-253).
  3. Iteration restart: resume inside evolve3D's convergence loop from
     double-buffered dumps written every 15 wall-clock minutes
     (evolve.F90:253-266, 285-426; iterdump{1,2}.npz, with the JAX
     twin's keys, so a dump either package wrote resumes in the other).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..config import RunConfig, resolve_device
from ..models.nbody import fortran_f6_3
from ..state import GridState
from .io_fortran import read_sm3d, read_sm3d_slab

# dump cadence (evolve.F90:259-266, clocks.f90:35)
DUMP_INTERVAL_S = 15 * 60


def load_slice_restart(cfg: RunConfig, results_dir: str, zred: float,
                       device=None, rows=None) -> GridState:
    """xfrac_restart_init + temperature_restart_init equivalents, on
    `device` (None: CUDA).  rows: (x0, m) reads grid rows [x0, x0+m)
    only (a halo-layout slab, the JAX _restart_sharded)."""
    dev = resolve_device(device)
    zs = fortran_f6_3(zred)

    def read(name, dtype):
        path = os.path.join(results_dir, f"{name}_{zs}.bin")
        if rows is None:
            return read_sm3d(path, dtype, expect_mesh=cfg.mesh)
        return read_sm3d_slab(path, dtype, cfg.mesh, *rows)

    xh1 = read("xfrac3D", np.float64)
    if cfg.compressed_xfrac:
        # encode the float64 cube BEFORE the cast to the working dtype so
        # the x_HI tail survives; a saturated cell stores +1.0, not -0.0
        # (see state.compress_xh)
        xh1 = np.where(xh1 <= 0.5, xh1,
                       np.where(xh1 < 1.0, -(1.0 - xh1), 1.0))
    xh1 = torch.from_numpy(xh1.astype(cfg.np_dtype)).to(dev)
    if cfg.isothermal:
        return GridState(xh1=xh1)
    t = read("Temper3D", np.float32)
    t = torch.from_numpy(t.astype(cfg.np_dtype)).to(dev)
    return GridState(xh1=xh1, temper_current=t, temper_av=t,
                     temper_intermed=t)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@dataclass
class IterDumper:
    """Double-buffered iteration-state dumps (write_iteration_dump /
    start_from_dump, evolve.F90:285-426)."""

    dump_dir: str = "./"
    interval_s: float = DUMP_INTERVAL_S
    # False on every rank but the I/O rank: the reference writes the dump
    # on rank 0 only (evolve.F90:258-265)
    enabled: bool = True
    # a parallel.layout.LayoutRuntime whose slabs the dump gathers: the
    # gathers are collectives, so rank 0's wall-clock decision is
    # broadcast and every rank joins them
    layout: Optional[object] = None
    _ndump: int = 0
    _last_wall: float = field(default_factory=time.time)

    def maybe_dump(self, niter: int, photon_loss: float, phih, xh_av,
                   xh_intermed, phiheat=None, temper=None,
                   temper_av=None) -> Optional[str]:
        """Dump if more than interval_s wall-clock seconds have passed
        since the last dump (or since the dumper was made)."""
        now = time.time()
        if self._collective():
            from ..parallel import multihost as mh
            if not mh.broadcast_obj(now - self._last_wall >= self.interval_s
                                    if mh.is_io_rank() else None):
                return None
        elif not self.enabled or now - self._last_wall < self.interval_s:
            return None
        self._last_wall = now
        return self.dump(niter, photon_loss, phih, xh_av, xh_intermed,
                         phiheat, temper, temper_av)

    def dump(self, niter, photon_loss, phih, xh_av, xh_intermed,
             phiheat=None, temper=None, temper_av=None) -> str:
        """Write the next of iterdump1/2.npz (through a temporary file, so
        a crash mid-write leaves the other dump valid)."""
        self._ndump += 1
        name = "iterdump2.npz" if self._ndump % 2 == 0 else "iterdump1.npz"
        path = os.path.join(self.dump_dir, name)

        def host(x):
            return _host(self.layout.whole(x) if self.layout is not None
                         else x)

        data = dict(niter=niter, photon_loss=photon_loss, phih=host(phih),
                    xh_av=host(xh_av), xh_intermed=host(xh_intermed))
        for key, val in (("phiheat", phiheat), ("temper", temper),
                         ("temper_av", temper_av)):
            if val is not None:
                data[key] = host(val)
        if not self.enabled:
            return None           # joined the gathers; rank 0 writes
        tmp = path + ".tmp.npz"   # the .npz suffix keeps np.savez's name
        np.savez(tmp, **data)
        os.replace(tmp, path)
        return path

    def _collective(self) -> bool:
        """True when the dump's gathers are collectives (slabs)."""
        lay = self.layout
        return (lay is not None and lay.grid is not None
                and lay.rows is not None and lay.grid.n_dom > 1)

    @staticmethod
    def load(dump_dir: str, which: int = 1) -> dict:
        """start_from_dump: which selects iterdump1/2 (restart flag 1/2,
        evolve.F90:354-362)."""
        path = os.path.join(dump_dir, f"iterdump{which}.npz")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
