"""Grid state containers and problem initialization (PyTorch port of
c2ray_tpu/state.py).

The comoving density and cell size are the invariant base state; proper
(physical) values are derived per step from the current redshift
(cosmology.F90:161-193 cosmo_evol, without mutation).  Under compressed
ionization-fraction storage (cfg.compressed_xfrac) xh1 holds the signed
min-fraction form (compress_xh); xh1_of and xh0_of decode it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import constants as const
from .config import RunConfig, resolve_device


class GridState(NamedTuple):
    """Prognostic fields, (N,N,N) tensors at the config dtype.

    xh1:      H ionized fraction at the last completed step (xh); the
              compressed form (compress_xh) under cfg.compressed_xfrac.
    temper_*: temperature states; None when isothermal.
    """

    xh1: torch.Tensor
    temper_current: Optional[torch.Tensor] = None
    temper_av: Optional[torch.Tensor] = None
    temper_intermed: Optional[torch.Tensor] = None


# compressed ionization-fraction storage (the reference's compressed/
# variant, compressed/README:1-13): store the SMALLER of (x_HI, x_HII),
# the sign saying which (negative: x_HI is stored), so both tails keep
# full float precision in float32.

def compress_xh(xh1: torch.Tensor,
                xh0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode (x_HII [, x_HI]) into the signed compressed form; pass the
    natively computed neutral fraction when there is one (the chemistry
    does).  A saturated cell (x_HI == 0) stores +1.0, not -0.0: IEEE
    -0.0 >= 0 holds, so -0.0 would decode as fully neutral."""
    if xh0 is None:
        xh0 = 1.0 - xh1
    return torch.where(xh1 <= 0.5, xh1,
                       torch.where(xh0 > 0.0, -xh0, torch.ones_like(xh1)))


def xh1_of(xc: torch.Tensor) -> torch.Tensor:
    """Ionized fraction from the compressed form (tail-exact for x <= 0.5)."""
    return torch.where(xc >= 0, xc, 1.0 + xc)


def xh0_of(xc: torch.Tensor) -> torch.Tensor:
    """Neutral fraction from the compressed form (tail-exact for
    x_HI <= 0.5)."""
    return torch.where(xc >= 0, 1.0 - xc, -xc)


class MaterialState(NamedTuple):
    """Non-prognostic material fields: the comoving number density and
    optional per-cell clumping and LLS grids (None => scalar models)."""

    ndens_comoving: torch.Tensor
    clumping_grid: Optional[torch.Tensor] = None
    lls_grid: Optional[torch.Tensor] = None


def initial_state(cfg: RunConfig, device=None) -> GridState:
    """Initial ionization (RECFAST 2e-4, ionfractions_module.F90:41-50)
    and temperature (initial_temperature)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    xh1 = torch.full(cfg.mesh, cfg.initial_xh, dtype=dt, device=dev)
    if cfg.compressed_xfrac:
        xh1 = compress_xh(xh1)
    if cfg.isothermal:
        return GridState(xh1=xh1)
    t = torch.full(cfg.mesh, cfg.initial_temperature, dtype=dt, device=dev)
    return GridState(xh1=xh1, temper_current=t, temper_av=t,
                     temper_intermed=t)


def mean_baryon_density(cfg: RunConfig, redshift: float) -> float:
    """Proper mean (H+He) number density at `redshift`
    (density_module.F90:129-147)."""
    c = cfg.cosmo
    return (c.rho_crit_0 * c.omega_b / (const.MU * const.M_P)
            * (1.0 + redshift) ** 3)


def uniform_material(cfg: RunConfig, device=None) -> MaterialState:
    """Test-problem material: uniform density at the comoving mean."""
    c = cfg.cosmo
    n0 = c.rho_crit_0 * c.omega_b / (const.MU * const.M_P)
    nd = torch.full(cfg.mesh, n0, dtype=cfg.torch_dtype,
                    device=resolve_device(device))
    return MaterialState(ndens_comoving=nd)


def proper_fields(cfg: RunConfig, mat: MaterialState, redshift: float):
    """(ndens_proper, dr_proper, vol_proper) at a redshift; comoving
    values as they are for non-cosmological runs."""
    zp1 = 1.0 + redshift if cfg.cosmological else 1.0
    # the factor is rounded to the working dtype first, as in the JAX twin
    ndens = mat.ndens_comoving * float(cfg.np_dtype(zp1**3))
    dr = cfg.dr_comoving / zp1
    return ndens, dr, dr**3
