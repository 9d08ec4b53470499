"""The chemistry pass's hand-written CUDA kernel (csrc/chemistry.cu).

The counterpart of what XLA fuses out of c2ray_tpu/ops/chemistry.py::
global_chemistry and, non-isothermally, c2ray_tpu/ops/thermal.py::
_thermal_core: the masked while loops over the grid become one thread
per cell that iterates its own doric passes and thermal substeps in
registers, so the pass makes no host round trip and a CUDA graph can
capture it.  ops/chemistry.global_chemistry calls global_chemistry_cuda
for CUDA tensors; its plain version is
ops/chemistry.global_chemistry_reference.

The kernel follows the plain version's torch ops cell by cell, so its
outputs are bitwise those of the plain version on the card.  The
isothermal rates are computed here once with the plain version's own
ops and passed in.  Builds: float32 and float64 (the tensors' dtype),
each with an isothermal and a heat instance and their compressed-storage
forms; LAUNCHES (launches.LaunchCounts) counts launches by build key:
"chemistry", "chemistry_heat", "chemistry_f64", "chemistry_f64_heat".
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from .. import constants as const
from ..config import RunConfig
from .chemistry import ChemistryResult
from .doric import recombination_rates
from .launches import LaunchCounts
from .sweep_cuda import _DTYPES, Build, _build_key, _check_cuda, _check_rc, \
    _entry, step_scalar
from .tables import LOG10_E
from .thermal import TEMPPOINTS, CoolingTable

# the kernel's int64 counters, in csrc/chemistry.cu's Counter order:
# non-converged cells (conv_flag), the most passes of a cell
# (n_iterations), passes summed over the cells, thermal substeps summed
# over cells and passes, the most substeps of a cell in one pass
COUNTERS = ("conv_flag", "max_passes", "passes", "substeps",
            "max_substeps")

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_NUM_SCALARS = 19
_SIGNATURES = {
    "chemistry": ("chemistry", "c2r_chemistry",
                  [_vp, _vp, _vp, _vp, _vp, _vp, _i, _vp, _i, _vp, _vp, _i,
                   _vp, _vp, _vp, _vp, ctypes.POINTER(ctypes.c_double), _vp,
                   _vp, _ll,
                   _i, _i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp]),
    # blocks of the cell launch: the size of its counters' partials
    "chemistry_blocks": ("chemistry", "c2r_chemistry_blocks", [_ll]),
}


def build_for(dtype, heat: bool) -> Build:
    """The build that runs the pass on tensors of `dtype`, isothermal or
    with heat."""
    return _build_key("chemistry", dtype, heat=heat)


LAUNCHES = LaunchCounts([build_for(d, h).key for d in _DTYPES
                         for h in (False, True)])


def _operand(name, x, like: torch.Tensor):
    """A clumping or loss-rate operand: a Python number -> (None, 0,
    value); a 0-d or grid tensor on like's device and dtype -> (tensor,
    stride, 0.0)."""
    if not isinstance(x, torch.Tensor):
        return None, 0, float(x)
    _check_cuda(name, x, like.dtype)
    if x.device != like.device:
        raise ValueError(f"{name} is on {x.device}, ndens on {like.device}")
    if x.numel() == 1:
        return x, 0, 0.0
    if x.shape != like.shape:
        raise ValueError(f"{name} must be 0-d or of shape "
                         f"{tuple(like.shape)}, got {tuple(x.shape)}")
    return x, 1, 0.0


def global_chemistry_cuda(cfg: RunConfig, dt, ndens: torch.Tensor,
                          xh1_old: torch.Tensor, xh1_intermed: torch.Tensor,
                          xh1_av: torch.Tensor, phih: torch.Tensor,
                          phiheat=None, temper_current=None, temper_av=None,
                          clumping: Union[float, torch.Tensor] = 1.0,
                          cool: Optional[CoolingTable] = None,
                          cosmo_cool_coeff=0.0,
                          photon_loss_rate: Union[float,
                                                  torch.Tensor] = 0.0,
                          max_subcycles: int = 10000) -> ChemistryResult:
    """global_chemistry on CUDA tensors, one kernel launch (the
    arguments are global_chemistry's).  dt and cosmo_cool_coeff are
    Python numbers or one-element float64 tensors on the card, which the
    kernel reads at launch (sweep_cuda.step_scalar); clumping and
    photon_loss_rate a number, a 0-d tensor or a grid of ndens' shape.
    The result's counters hold the kernel's COUNTERS."""
    res = _chemistry(cfg, dt, ndens, xh1_old, xh1_intermed, xh1_av, phih,
                     phiheat, temper_current, temper_av, clumping, cool,
                     cosmo_cool_coeff, photon_loss_rate, max_subcycles)
    LAUNCHES.add(build_for(ndens.dtype, not cfg.isothermal).key, 1,
                 ndens.device)
    return res


def _chemistry(cfg: RunConfig, dt, ndens, xh1_old, xh1_intermed, xh1_av,
               phih, phiheat, temper_current, temper_av, clumping, cool,
               cosmo_cool_coeff, photon_loss_rate, max_subcycles,
               defines=()) -> ChemistryResult:
    """Launch the kernel (the build of ndens' dtype, with the timing
    `defines` added, none by default)."""
    heat = not cfg.isothermal
    dtype, dev = ndens.dtype, ndens.device
    dt, dt_p = step_scalar("dt", dt, dev)
    coeff, coeff_p = step_scalar("cosmo_cool_coeff", cosmo_cool_coeff, dev)
    if heat and (cool is None or phiheat is None or temper_current is None
                 or temper_av is None):
        raise ValueError("non-isothermal chemistry needs cool, phiheat, "
                         "temper_current and temper_av")
    build = build_for(dtype, heat)
    grids = [("ndens", ndens), ("xh1_old", xh1_old),
             ("xh1_intermed", xh1_intermed), ("xh1_av", xh1_av),
             ("phih", phih)]
    if heat:
        grids += [("phiheat", phiheat), ("temper_current", temper_current),
                  ("temper_av", temper_av)]
    for name, t in grids:
        _check_cuda(name, t, dtype, ndens.shape)
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, ndens on {dev}")
    loss, loss_stride, loss_scalar = _operand("photon_loss_rate",
                                              photon_loss_rate, ndens)
    brech = acol = clump = None
    brech_stride = clump_stride = 0
    clump_bh = 0.0
    if heat:
        clump, clump_stride, c = _operand("clumping", clumping, ndens)
        if clump is None:
            clump_bh = c * const.BH00     # the plain version's Python product
        cie = cool.cie_cool
        _check_cuda("cool.cie_cool", cie, dtype, (TEMPPOINTS,))
        if cie.device != dev:
            raise ValueError(f"cool.cie_cool is on {cie.device}")
    else:
        # the plain version hoists the isothermal rates out of its loop:
        # the same ops, on the device
        t0 = torch.full((), cfg.initial_temperature, dtype=dtype, device=dev)
        brech, acol = recombination_rates(t0, clumping)
        brech, brech_stride, _ = _operand("recombination rate",
                                          brech.contiguous(), ndens)
        cie = None
    # csrc/chemistry.cu's Scalar order
    scalars = (ctypes.c_double * _NUM_SCALARS)(
        dt, cfg.epsilon, cfg.minimum_fractional_change,
        cfg.minimum_fraction_of_atoms, loss_scalar, clump_bh, const.BH00,
        const.ALBPOW, const.COLH0, const.TEMPH0, const.ABU_C, const.K_B,
        const.GAMMA1, LOG10_E, cool.mintemp if heat else 0.0,
        cool.dtemp if heat else 1.0, cfg.minitemp, cfg.relative_denergy,
        coeff)
    out_int = torch.empty_like(ndens)
    out_av = torch.empty_like(ndens)
    out_tint = torch.empty_like(ndens) if heat else None
    out_tav = torch.empty_like(ndens) if heat else None
    counters = torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    defines = build.defines + tuple(defines)
    lib, fn = _entry("chemistry", _SIGNATURES, defines)
    blocks = _entry("chemistry_blocks", _SIGNATURES, defines)[1]
    blocks.restype = _ll
    partial = torch.empty(len(COUNTERS) * max(1, blocks(ndens.numel())),
                          dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(ptr(ndens), ptr(xh1_old), ptr(xh1_intermed), ptr(xh1_av),
            ptr(phih), ptr(loss), loss_stride, ptr(brech), brech_stride,
            ptr(acol), ptr(clump), clump_stride, ptr(phiheat),
            ptr(temper_current), ptr(temper_av), ptr(cie), scalars, dt_p,
            coeff_p, ndens.numel(), cfg.max_chemistry_iterations,
            int(max_subcycles), int(heat), int(cfg.compressed_xfrac),
            ptr(out_int), ptr(out_av), ptr(out_tint), ptr(out_tav),
            ptr(counters), ptr(partial), stream)
    _check_rc(lib, rc, "chemistry")
    return ChemistryResult(out_int, out_av, out_tint, out_tav,
                           counters[0].to(torch.int32),
                           counters[1].to(torch.int32), counters)
