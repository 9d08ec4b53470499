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
from .io_fortran import read_sm3d

# dump cadence (evolve.F90:259-266, clocks.f90:35)
DUMP_INTERVAL_S = 15 * 60


def load_slice_restart(cfg: RunConfig, results_dir: str, zred: float,
                       device=None) -> GridState:
    """xfrac_restart_init + temperature_restart_init equivalents, on
    `device` (None: CUDA)."""
    dev = resolve_device(device)
    zs = fortran_f6_3(zred)
    xh1 = read_sm3d(os.path.join(results_dir, f"xfrac3D_{zs}.bin"),
                    np.float64, expect_mesh=cfg.mesh)
    if cfg.compressed_xfrac:
        # encode the float64 cube BEFORE the cast to the working dtype so
        # the x_HI tail survives; a saturated cell stores +1.0, not -0.0
        # (see state.compress_xh)
        xh1 = np.where(xh1 <= 0.5, xh1,
                       np.where(xh1 < 1.0, -(1.0 - xh1), 1.0))
    xh1 = torch.from_numpy(xh1.astype(cfg.np_dtype)).to(dev)
    if cfg.isothermal:
        return GridState(xh1=xh1)
    t = read_sm3d(os.path.join(results_dir, f"Temper3D_{zs}.bin"),
                  np.float32, expect_mesh=cfg.mesh)
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
    _ndump: int = 0
    _last_wall: float = field(default_factory=time.time)

    def maybe_dump(self, niter: int, photon_loss: float, phih, xh_av,
                   xh_intermed, phiheat=None, temper=None,
                   temper_av=None) -> Optional[str]:
        """Dump if more than interval_s wall-clock seconds have passed
        since the last dump (or since the dumper was made)."""
        now = time.time()
        if now - self._last_wall < self.interval_s:
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
        data = dict(niter=niter, photon_loss=photon_loss, phih=_host(phih),
                    xh_av=_host(xh_av), xh_intermed=_host(xh_intermed))
        for key, val in (("phiheat", phiheat), ("temper", temper),
                         ("temper_av", temper_av)):
            if val is not None:
                data[key] = _host(val)
        tmp = path + ".tmp.npz"   # the .npz suffix keeps np.savez's name
        np.savez(tmp, **data)
        os.replace(tmp, path)
        return path

    @staticmethod
    def load(dump_dir: str, which: int = 1) -> dict:
        """start_from_dump: which selects iterdump1/2 (restart flag 1/2,
        evolve.F90:354-362)."""
        path = os.path.join(dump_dir, f"iterdump{which}.npz")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
