"""Photon conservation statistics, PyTorch port of
c2ray_tpu/ops/photonstats.py (photonstatistics.F90).

The device computes only unit-safe normalized reductions (float32 would
overflow on cgs totals ~1e68); the host assembles physical totals in
float64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Union

import torch

from .. import constants as const
from ..config import RunConfig
from .doric import electrondens


class GridCounts(NamedTuple):
    """Device reductions, per unit cell volume (multiply by vol on host)."""

    h0: torch.Tensor          # sum of n * x_HI over cells
    h1: torch.Tensor          # sum of n * x_HII over cells
    rec_rate: torch.Tensor    # sum of recombination rates
    coll_rate: torch.Tensor   # sum of collisional ionization rates


def grid_counts(cfg: RunConfig, ndens, xh1, temper_av=None,
                clumping: Union[float, torch.Tensor] = 1.0,
                compressed: bool = False) -> GridCounts:
    """Neutral/ionized atom counts and total recombination/collision
    rates (photonstatistics.F90:104-185), with doric's rate formulas.
    compressed: xh1 is the signed compressed form (state.compress_xh),
    both sides decoded natively so the neutral tail keeps its stored
    precision."""
    if compressed:
        from ..state import xh0_of, xh1_of
        x1 = xh1_of(xh1)
        x0 = xh0_of(xh1)
    else:
        x1 = xh1
        x0 = 1.0 - xh1
    h0 = torch.sum(ndens * x0)
    h1 = torch.sum(ndens * x1)
    if temper_av is None:
        t = cfg.initial_temperature
        brech = clumping * const.BH00 * (t / 1e4) ** const.ALBPOW
        # 0-d device fills, not copies from the host (the device loop
        # captures this)
        acol = const.COLH0 * torch.sqrt(
            torch.full((), t, dtype=ndens.dtype, device=ndens.device)
        ) * torch.exp(torch.full((), -const.TEMPH0 / t, dtype=ndens.dtype,
                                 device=ndens.device))
    else:
        brech = clumping * const.BH00 * (temper_av / 1e4) ** const.ALBPOW
        acol = (const.COLH0 * torch.sqrt(temper_av)
                * torch.exp(-const.TEMPH0 / temper_av))
    ne = electrondens(ndens, x1)
    rec = torch.sum(ndens * x1 * ne * brech)
    coll = torch.sum(ndens * x0 * ne * acol)
    return GridCounts(h0, h1, rec, coll)


@dataclass
class PhotonStatistics:
    """Host-side accumulator mirroring module photonstatistics, in
    physical photon counts (float64).  photonstatistics.F90:39-66,
    :222-293."""

    cfg: RunConfig
    do_photonstatistics: bool = True
    h0_before: float = 0.0
    h1_before: float = 0.0
    h0_after: float = 0.0
    h1_after: float = 0.0
    totrec: float = 0.0
    totcollisions: float = 0.0
    dh0: float = 0.0
    total_ion: float = 0.0
    grtotal_ion: float = 0.0
    grtotal_src: float = 0.0
    photon_cons: float = 1.0
    total_photon_loss: float = 0.0
    total_lls_loss: float = 0.0
    totalsrc: float = 0.0

    def state_before(self, counts: GridCounts, vol: float) -> None:
        """photonstatistics.F90:104-132."""
        self.h0_before = float(counts.h0) * vol
        self.h1_before = float(counts.h1) * vol

    def calculate(self, counts_after: GridCounts, rate_counts: GridCounts,
                  vol: float, dt: float) -> None:
        """calculate_photon_statistics (photonstatistics.F90:82-99,
        190-228): counts_after from the end-of-step state, rate_counts
        (recombination/collision totals) from the time-averaged state."""
        self.h0_after = float(counts_after.h0) * vol
        self.h1_after = float(counts_after.h1) * vol
        self.totrec = float(rate_counts.rec_rate) * vol * dt
        self.totcollisions = float(rate_counts.coll_rate) * vol * dt
        self.dh0 = self.h0_before - self.h0_after
        self.total_ion = self.totrec + self.dh0

    def report(self, dt: float, photon_loss: float, lls_loss: float,
               total_flux_s_star: float) -> dict:
        """report_photonstatistics (photonstatistics.F90:254-281); the
        losses and the flux are in S_star photon-rate units."""
        s_star = self.cfg.sed.s_star
        self.total_photon_loss = photon_loss * s_star * dt
        self.total_lls_loss = lls_loss * s_star * dt
        self.totalsrc = total_flux_s_star * s_star * dt
        lls_count = self.total_lls_loss
        if self.totalsrc > 0.0:
            self.photon_cons = (self.total_ion + lls_count
                                - self.totcollisions) / self.totalsrc
        else:
            self.photon_cons = 1.0
        ti = self.total_ion if self.total_ion != 0.0 else 1.0
        return {
            "total_ion": self.total_ion,
            "totalsrc": self.totalsrc,
            "photon_cons": self.photon_cons,
            "frac_new_ion": self.dh0 / ti,
            "frac_rec": self.totrec / ti,
            "frac_lls_loss": lls_count / self.totalsrc if self.totalsrc else 0.0,
            "frac_photon_loss": (self.total_photon_loss / self.totalsrc
                                 if self.totalsrc else 0.0),
            "frac_coll": self.totcollisions / ti,
            "h1_before": self.h1_before,
            "h1_after": self.h1_after,
        }

    def update_grandtotal(self, dt: float, total_flux_s_star: float) -> None:
        """photonstatistics.F90:286-293."""
        self.grtotal_src += total_flux_s_star * self.cfg.sed.s_star * dt
        self.grtotal_ion += self.total_ion - self.totcollisions
