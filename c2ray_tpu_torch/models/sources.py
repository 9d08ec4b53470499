"""Source catalogs and UV luminosity models.

Host-side (numpy) copy of c2ray_tpu/models/sources.py (sourceprops.F90):
reading per-redshift halo source lists, applying the suppression
criterion (low-mass sources in ionized cells), and converting halo
masses to normalized ionizing photon rates under one of the 8 UV models
(sourceprops.F90:697-722).

Positions in source files are 1-based (sourceprops.F90:375-378); the
catalog stores 0-based grid indices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import constants as const
from ..config import RunConfig

# UV model ids (sourceprops.F90:697-722)
UV_MODELS = {
    0: "Iliev et al",
    1: "Fixed N_gamma",
    2: "Fixed Ndot_gamma",
    3: "Iliev et al partial supp.",
    4: "Gradual supp.",
    5: "Collapsed fraction growth",
    6: "Luminosity function",
    7: "Test",
}

# source-file column indices (0-based here; sourceprops.F90:49-51)
HMACH = 3
LMACH = 4
LMACH_SUPPR = 5

# maximum fraction of banked photons released per slice
# (sourceprops.F90:54)
CUMULATIVE_FRACTION_MAX = 0.15


@dataclass
class SourceCatalog:
    """Active sources for one redshift slice."""

    srcpos: np.ndarray           # (S,3) int32, 0-based grid positions
    normflux_stellar: np.ndarray  # (S,) photon rates in S_star units
    normflux_xray: np.ndarray     # (S,) X-ray rates in S_star units

    @property
    def num_src(self) -> int:
        return len(self.normflux_stellar)

    @property
    def total_flux(self) -> float:
        return float(np.sum(self.normflux_stellar))


def read_source_file(path: str, ncolumns: int = 5) -> np.ndarray:
    """Read a source list: first line = count, then `ncolumns` floats per
    line (count_or_read_in_sources, sourceprops.F90:292-325, in one
    pass).  Short rows are padded with zeros, blank lines read as zero
    rows and Fortran D exponents (1.0D+05) are understood: the parse of
    the JAX twin's python reader, value for value."""
    def _f(v: str) -> float:
        try:
            return float(v)
        except ValueError:   # Fortran D exponents (1.0D+05)
            return float(v.replace("D", "e").replace("d", "e"))

    with open(path) as f:
        n = int(f.readline().split()[0])
        rows = np.zeros((n, ncolumns))
        for i in range(n):
            vals = [_f(v) for v in f.readline().split()]
            rows[i, :len(vals)] = vals[:ncolumns]
    return rows


@dataclass
class SourceModel:
    """Stateful source-model pipeline (module sourceprops equivalent).

    Carries the cumulative-photon bank of the Fixed N_gamma model
    (sourceprops.F90:66-68) and the previous-slice halo masses of the
    collapsed-fraction-growth model (:80-90) across slices.
    """

    cfg: RunConfig
    uv_model: str = "Test"
    m_grid: float = 0.0            # mean mass per grid cell (nbody adapter)
    n_box: int = 1
    uv_array: Optional[np.ndarray] = None  # per-slice photon budgets (models 1,2)
    cumulative_uv: float = 0.0
    mass_ach_previous: float = 0.0
    # statistics of the last load (for logs/parity outputs)
    num_supprble: int = 0
    num_supprsd: int = 0
    num_massive: int = 0

    @classmethod
    def from_recipe(cls, cfg: RunConfig, recipe: int, **kw) -> "SourceModel":
        return cls(cfg=cfg, uv_model=UV_MODELS[recipe], **kw)

    # ------------------------------------------------------------------
    def _mass_from_models(self, rows: np.ndarray,
                          suppress: np.ndarray) -> np.ndarray:
        """Weighted source mass per row (mass_from_source_models,
        sourceprops.F90:490-548)."""
        cfg = self.cfg
        hm = rows[:, HMACH]
        lm = rows[:, LMACH]
        model = self.uv_model
        if model == "Iliev et al":
            f_lm = np.where(suppress, 0.0, cfg.phot_per_atom[1])
            return hm * cfg.phot_per_atom[0] + lm * f_lm
        if model == "Iliev et al partial supp.":
            f_lm = np.where(suppress, cfg.phot_per_atom[0], cfg.phot_per_atom[1])
            return hm * cfg.phot_per_atom[0] + lm * f_lm
        if model == "Gradual supp.":
            with np.errstate(invalid="ignore", divide="ignore"):
                grad = np.where(lm > 0, rows[:, LMACH_SUPPR] / np.maximum(lm, 1e-300), 0.0)
            f_lm = np.where(suppress, cfg.phot_per_atom[1] * grad,
                            cfg.phot_per_atom[1])
            return hm * cfg.phot_per_atom[0] + lm * f_lm
        if model == "Collapsed fraction growth":
            f_lm = np.where(suppress, 0.0, cfg.zeta[1])
            return hm * cfg.zeta[0] + lm * f_lm
        # default (incl. "Fixed N_gamma"/"Fixed Ndot_gamma"/"Luminosity
        # function"): plain halo mass (sourceprops.F90:543-544)
        return hm

    # ------------------------------------------------------------------
    def load(self, rows: np.ndarray, xh1: np.ndarray, nz: int,
             lifetime: float, dt_slice: Optional[float] = None) -> SourceCatalog:
        """Apply the source recipe to raw source-file rows.

        Args:
          rows:     (N0, >=5) array read by read_source_file.
          xh1:      current ionized-fraction grid (suppression criterion),
                    a tensor on any device or a numpy array.
          nz:       redshift-slice index (0-based) for uv_array models.
          lifetime: source lifetime / timestep used to convert masses to
                    luminosities (lifetime2 arg of source_properties).
          dt_slice: time between slices (Collapsed fraction growth model).

        Reference: source_properties + count_or_read_in_sources +
        assign_uv_luminosities (sourceprops.F90:103-209,259-470,552-634).
        """
        cfg = self.cfg
        pos1 = rows[:, 0:3].astype(np.int64)     # 1-based in the files
        pos0 = pos1 - 1

        if self.uv_model == "Test":
            # raw photon rates from columns 4 (stellar) and 5 (X-ray)
            # (sourceprops.F90:364-366,379-381,627-631)
            weighted = rows[:, 3:].sum(axis=1)
            active = weighted > 0.0
            return SourceCatalog(
                srcpos=pos0[active].astype(np.int32),
                normflux_stellar=rows[active, 3] / cfg.sed.s_star,
                normflux_xray=rows[active, 4] / cfg.sed.pl_s_star,
            )

        # suppression: low-mass sources in ionized cells
        # (suppression_criterion, sourceprops.F90:474-486).  Index first:
        # on a device tensor the gather runs there and only num_src values
        # come to the host
        x_at_src = _gather_cells(xh1, pos0)
        suppress = x_at_src > cfg.still_neutral
        self.num_massive = int(np.sum(rows[:, HMACH] > 0))
        self.num_supprble = int(np.sum(rows[:, LMACH] > 0))
        self.num_supprsd = int(np.sum((rows[:, LMACH] > 0) & suppress))
        mass_hmach = float(rows[:, HMACH].sum())
        mass_lmach = float(rows[:, LMACH].sum())
        mass_ach = mass_hmach + mass_lmach

        weighted = self._mass_from_models(rows, suppress)
        if self.uv_model == "Collapsed fraction growth":
            dmass = mass_ach - self.mass_ach_previous
            weighted = weighted * (dmass / mass_ach if mass_ach > 0 else 0.0)
            self.mass_ach_previous = mass_ach

        active = weighted > 0.0
        srcpos = pos0[active].astype(np.int32)
        w = weighted[active]

        # mass -> luminosity (assign_uv_luminosities, :552-634)
        model = self.uv_model
        if model in ("Iliev et al", "Iliev et al partial supp.",
                     "Gradual supp.", "Collapsed fraction growth"):
            interval = dt_slice if model == "Collapsed fraction growth" else lifetime
            # Luminosity_from_mass (sourceprops.F90:638-661):
            # S = f*M [grid masses] * M_grid * Omega_B/Omega0 / m_p / dt / S_star
            cosmo = cfg.cosmo
            flux = (w * self.m_grid * cosmo.omega_b / (cosmo.omega0 * const.M_P)
                    / (interval * cfg.sed.s_star))
        elif model == "Fixed N_gamma":
            budget = self._uv_budget(nz)
            if budget is None:
                flux = np.zeros_like(w)
            else:
                frac = min(CUMULATIVE_FRACTION_MAX,
                           self.cumulative_uv / budget if budget > 0 else 0.0)
                total = w.sum()
                flux = ((1.0 + frac) * budget / lifetime
                        * w / (total * cfg.sed.s_star))
                self.cumulative_uv = max(0.0, self.cumulative_uv - frac * budget)
        elif model == "Fixed Ndot_gamma":
            budget = self._uv_budget(nz)
            if budget is None:
                flux = np.zeros_like(w)
            else:
                flux = budget * w / (w.sum() * cfg.sed.s_star)
        elif model == "Luminosity function":
            # The reference's menu offers this model but implements no mass
            # or luminosity recipe for it: it falls through both select
            # blocks (sourceprops.F90:543-544,576-632), leaving raw halo
            # masses as "fluxes".  Reproduced for parity.
            flux = w
        else:
            raise NotImplementedError(f"UV model {model!r}")

        return SourceCatalog(srcpos=srcpos, normflux_stellar=flux,
                             normflux_xray=np.zeros_like(flux))

    def _uv_budget(self, nz: int) -> Optional[float]:
        if self.uv_array is None or nz >= len(self.uv_array):
            return None
        return float(self.uv_array[nz])

    def bank_photons(self, nz: int) -> None:
        """No active sources this slice: bank the budget
        (sourceprops.F90:199-207)."""
        if self.uv_model == "Fixed N_gamma" and self.uv_array is not None \
                and nz < len(self.uv_array):
            self.cumulative_uv += float(self.uv_array[nz])


def _gather_cells(grid, pos0: np.ndarray) -> np.ndarray:
    """grid[pos0[:, 0], pos0[:, 1], pos0[:, 2]] on the host (a grid held
    as slabs, parallel.layout.SlabView, reads its cells collectively)."""
    import torch
    if hasattr(grid, "cells"):
        return grid.cells(pos0)
    if isinstance(grid, torch.Tensor):
        idx = torch.as_tensor(pos0, dtype=torch.long, device=grid.device)
        return grid[idx[:, 0], idx[:, 1], idx[:, 2]].cpu().numpy()
    return np.asarray(grid)[pos0[:, 0], pos0[:, 1], pos0[:, 2]]


def read_uv_file(path: str, recipe: int) -> np.ndarray:
    """Per-slice UV photon budgets for the fixed-budget models.

    Reference: source_properties_ini, sourceprops.F90:727-753.  First
    line = slice count; model 1 ("Fixed N_gamma") lines are
    (z, N_source_nosupp, N_source_supp, N_gamma_nosupp, uv); model 2
    ("Fixed Ndot_gamma") lines are (z, uv).
    """
    col = 4 if recipe == 1 else 1
    with open(path) as f:
        n = int(f.readline().split()[0])
        uv = np.zeros(n)
        for i in range(n):
            uv[i] = float(f.readline().split()[col])
    return uv


def write_suppressed_source_list(path: str, cat: SourceCatalog) -> None:
    """Record the post-suppression source list so a restart reproduces
    the same suppression (sourceprops.F90:434-450; format '3i4,f15.5',
    positions 1-based)."""
    with open(path, "w") as f:
        f.write(f" {cat.num_src}\n")
        for i in range(cat.num_src):
            x, y, z = (int(v) + 1 for v in cat.srcpos[i])
            flux = float(cat.normflux_stellar[i])
            if max(x, y, z) <= 999 and flux < 1e8:
                # byte-identical to the reference's '(3i4,f15.5)'
                f.write(f"{x:4d}{y:4d}{z:4d}{flux:15.5f}\n")
            else:
                # out of the Fortran edit descriptor's range (mesh >=
                # 1000 or flux >= 1e8 would MERGE fields and break the
                # read-back - a latent reference bug): emit explicit
                # separators instead
                f.write(f"{x} {y} {z} {flux:.5f}\n")


def read_suppressed_source_list(path: str) -> SourceCatalog:
    """Read back a saved post-suppression list (sourceprops.F90:452-466)."""
    with open(path) as f:
        n = int(f.readline().split()[0])
        pos = np.zeros((n, 3), np.int32)
        flux = np.zeros(n)
        for i in range(n):
            vals = f.readline().split()
            pos[i] = [int(float(v)) - 1 for v in vals[:3]]
            flux[i] = float(vals[3])
    return SourceCatalog(srcpos=pos, normflux_stellar=flux,
                         normflux_xray=np.zeros(n))


def sort_sources_by_flux(cat: SourceCatalog) -> SourceCatalog:
    """Deterministic load-balancing order: big sources first, dealt
    round-robin across shards.  Replaces the reference's dynamic
    master-slave farm (master_slave.F90:124-330) - see SURVEY.md 7.3.5."""
    order = np.argsort(-cat.normflux_stellar, kind="stable")
    return SourceCatalog(cat.srcpos[order], cat.normflux_stellar[order],
                         cat.normflux_xray[order])
