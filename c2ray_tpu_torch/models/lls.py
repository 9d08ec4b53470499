"""Lyman-limit system (LLS) absorption models, port of
c2ray_tpu/models/lls.py (LLS.F90): the mean-free-path models and the
per-redshift setup of LLS types 1 (a homogeneous extra column per cell),
2 (a position-dependent column per cell, from a grid of LLS cross
sections) and 3 (a hard spherical barrier at R_max).  set_lls runs on
the host in numpy, as in the JAX package; set_lls_device makes the
type-2 grid from a torch tensor on its own device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as const
from ..config import RunConfig

# typical optical depth of one mean free path and its column (LLS.F90:76-77)
OPDEPTH_LL = 1.0
N_1 = OPDEPTH_LL / const.SIGMA_HI_AT_ION_FREQ

# do not let the mfp drop below these (LLS.F90:85-86)
LIMIT_MFP_PMPC = 0.2
LIMIT_MFP_CMPC = 1.0


class MfpModel(NamedTuple):
    """mfp(z) = A * ((1+z)/(1+z_ref))^yz  [proper Mpc]. LLS.F90:68-103."""

    reference: str
    a_lls: float
    z_ref: float
    yz_lls: float


def mfp_models(h: float) -> dict:
    """The 5 models (LLS_model 1..5); A scales with h (LLS.F90:89-103)."""
    return {
        1: MfpModel("W14 mfp std", 37.0 / (h / 0.7), 4.0, -5.4),
        2: MfpModel("W14 mfp low", 35.0 / (h / 0.7), 4.0, -5.8),
        3: MfpModel("W14 mfp high", 39.0 / (h / 0.7), 4.0, -5.0),
        4: MfpModel("constant proper mfp", 1.0, 4.0, 0.0),
        5: MfpModel("constant comoving mfp", 10.0, 0.0, -1.0),
    }


@dataclass
class LLSState:
    """Per-step LLS quantities fed to the sweep."""

    coldensh_lls: float = 0.0   # column density per cell [cm^-2] (types 1,2)
    mfp_pmpc: float = 0.0       # diagnostic
    r_max_cells: float = 0.0    # barrier radius in cell units (type 3)
    grid: Optional[object] = None   # per-cell columns (type 2): the
                                    # lls_grid that evolve3d takes


def _mfp_pmpc(cfg: RunConfig, zred: float) -> float:
    """The model mean free path [proper Mpc], without the comoving floor."""
    m = mfp_models(cfg.cosmo.h)[cfg.lls_model]
    return m.a_lls * ((1.0 + zred) / (1.0 + m.z_ref)) ** m.yz_lls


def set_lls(cfg: RunConfig, zred: float, dr_proper: float,
            lls_grid=None) -> LLSState:
    """Per-redshift LLS setup (set_LLS, LLS.F90:167-195).  dr_proper:
    proper cell size [cm]; lls_grid: type 2's cube of normalized LLS
    cross sections (a unit mean free path in proper Mpc), on the host."""
    if not cfg.use_lls:
        return LLSState()
    if cfg.type_of_lls == 1:
        mfp_pmpc = max(_mfp_pmpc(cfg, zred), LIMIT_MFP_CMPC / (1.0 + zred))
        n_lls = dr_proper / (mfp_pmpc * const.MPC)
        return LLSState(coldensh_lls=N_1 * n_lls, mfp_pmpc=mfp_pmpc)
    if cfg.type_of_lls == 3:
        # hard barrier: R_max comoving Mpc -> proper, in cell units
        # (LLS.F90:151-158,186)
        r_max_cm = cfg.r_max_cmpc * const.MPC / (1.0 + zred)
        return LLSState(r_max_cells=r_max_cm / dr_proper)
    if cfg.type_of_lls == 2:
        if lls_grid is None:
            raise ValueError("type_of_lls=2 requires an LLS grid")
        # read_LLS_grid's conversion (LLS.F90:269-300): scale to the model
        # mfp (no floor in this branch), zero the grid when the mfp falls
        # below the comoving limit, else turn the per-cell covering
        # fractions into column densities
        mfp_pmpc = _mfp_pmpc(cfg, zred)
        g = np.asarray(lls_grid, np.float64) / mfp_pmpc
        if mfp_pmpc < LIMIT_MFP_CMPC / (1.0 + zred):
            g = np.zeros_like(g)
        else:
            g = g * (const.MPC / dr_proper) ** 2 * N_1
        return LLSState(coldensh_lls=float(np.mean(g)), mfp_pmpc=mfp_pmpc,
                        grid=g)
    return LLSState()


def set_lls_device(cfg: RunConfig, zred: float, dr_proper: float,
                   lls_grid: torch.Tensor) -> LLSState:
    """Type-2 LLS setup on a device tensor: set_lls's type-2 arithmetic,
    elementwise on the cross-section cube in its own dtype and on its own
    device (the JAX set_lls_device)."""
    if not (cfg.use_lls and cfg.type_of_lls == 2):
        raise ValueError("set_lls_device is the type-2 LLS setup")
    mfp_pmpc = _mfp_pmpc(cfg, zred)
    if mfp_pmpc < LIMIT_MFP_CMPC / (1.0 + zred):
        return LLSState(coldensh_lls=0.0, mfp_pmpc=mfp_pmpc,
                        grid=torch.zeros_like(lls_grid))
    scale = (1.0 / mfp_pmpc) * (const.MPC / dr_proper) ** 2 * N_1
    # the scale rounded once to the grid's dtype, as the JAX twin does
    g = lls_grid * torch.tensor(scale, dtype=lls_grid.dtype,
                                device=lls_grid.device)
    return LLSState(coldensh_lls=float(torch.mean(g)), mfp_pmpc=mfp_pmpc,
                    grid=g)
