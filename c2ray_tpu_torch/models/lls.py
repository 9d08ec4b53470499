"""Lyman-limit system (LLS) absorption models, port of
c2ray_tpu/models/lls.py (LLS.F90): the mean-free-path models and the
per-redshift setup of LLS types 1 (a homogeneous extra column per cell)
and 3 (a hard spherical barrier at R_max).  Host numpy, as in the JAX
package.  Type 2 (a position-dependent grid) is not ported yet and
raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

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

    coldensh_lls: float = 0.0   # column density per cell [cm^-2] (type 1)
    mfp_pmpc: float = 0.0       # diagnostic
    r_max_cells: float = 0.0    # barrier radius in cell units (type 3)


def set_lls(cfg: RunConfig, zred: float, dr_proper: float) -> LLSState:
    """Per-redshift LLS setup (set_LLS, LLS.F90:167-195) for LLS off and
    types 1 and 3.  dr_proper: proper cell size [cm]."""
    if not cfg.use_lls:
        return LLSState()
    if cfg.type_of_lls == 1:
        m = mfp_models(cfg.cosmo.h)[cfg.lls_model]
        mfp_pmpc = m.a_lls * ((1.0 + zred) / (1.0 + m.z_ref)) ** m.yz_lls
        mfp_pmpc = max(mfp_pmpc, LIMIT_MFP_CMPC / (1.0 + zred))
        n_lls = dr_proper / (mfp_pmpc * const.MPC)
        return LLSState(coldensh_lls=N_1 * n_lls, mfp_pmpc=mfp_pmpc)
    if cfg.type_of_lls == 3:
        # hard barrier: R_max comoving Mpc -> proper, in cell units
        # (LLS.F90:151-158,186)
        r_max_cm = cfg.r_max_cmpc * const.MPC / (1.0 + zred)
        return LLSState(r_max_cells=r_max_cm / dr_proper)
    if cfg.type_of_lls == 2:
        raise NotImplementedError(
            "LLS type 2 (a grid) is not ported to c2ray_tpu_torch yet")
    return LLSState()
