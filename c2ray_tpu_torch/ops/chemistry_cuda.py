"""The chemistry pass's hand-written CUDA kernel (csrc/chemistry.cu).

The counterpart of what XLA fuses out of c2ray_tpu/ops/chemistry.py::
global_chemistry and, non-isothermally, c2ray_tpu/ops/thermal.py::
_thermal_core: the masked while loops over the grid become one
persistent launch in which each thread runs its cells' doric passes and
thermal substeps in registers, one cell after another, so the pass makes
no host round trip and a CUDA graph can capture it.
ops/chemistry.global_chemistry calls global_chemistry_cuda for CUDA
tensors; its plain version is ops/chemistry.global_chemistry_reference.

The kernel follows the plain version's torch ops cell by cell, so its
outputs are bitwise those of the plain version on the card.  The
isothermal rates are computed here once with the plain version's own
ops and passed in.  The kernel also takes the solver tail's photon audit
(its two ops/photonstats.grid_counts calls) as each cell finishes: the
result's `audit`, whose plain version is audit_reference, and whose
arithmetic per cell audit_terms writes out in torch.  Builds: float32
and float64 (the tensors' dtype), each with an isothermal and a heat
instance, their compressed-storage forms and forms with and without the
audit; LAUNCHES (launches.LaunchCounts) counts the kernel launches, one
per call, by build key: "chemistry", "chemistry_heat", "chemistry_f64",
"chemistry_f64_heat".
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
from .photonstats import grid_counts
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
# the audit's sums, in csrc/chemistry.cu's Audit order
AUDIT = ("h0", "h1", "rec_rate", "coll_rate")

_NUM_SCALARS = 23
_SIGNATURES = {
    "chemistry": ("chemistry", "c2r_chemistry",
                  [_vp, _vp, _vp, _vp, _vp, _vp, _i, _vp, _i, _vp, _vp, _i,
                   _vp, _vp, _vp, _vp, ctypes.POINTER(ctypes.c_double), _vp,
                   _vp, _ll,
                   _i, _i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                   ctypes.POINTER(ctypes.c_int), _vp]),
    # the partials' length per quantity: the most blocks of a launch
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


def audit_scalars(cfg: RunConfig, clumping) -> tuple:
    """The isothermal audit's rates as grid_counts takes them, Python
    floats: the recombination rate of a scalar clumping (clumping * BH00 *
    (T / 1e4) ** ALBPOW; 0.0 for a clumping tensor), (T / 1e4) ** ALBPOW,
    T and -TEMPH0 / T at T = cfg.initial_temperature."""
    t = cfg.initial_temperature
    pw = (t / 1e4) ** const.ALBPOW
    brech = (0.0 if isinstance(clumping, torch.Tensor)
             else clumping * const.BH00 * pw)
    return brech, pw, t, -const.TEMPH0 / t


def audit_reference(cfg: RunConfig, ndens: torch.Tensor,
                    xh1_intermed: torch.Tensor, xh1_av: torch.Tensor,
                    temper_av: Optional[torch.Tensor] = None,
                    clumping: Union[float, torch.Tensor] = 1.0
                    ) -> torch.Tensor:
    """Plain version of the kernel's audit: the solver tail's two
    grid_counts calls -> (4,) [h0, h1 of xh1_intermed; rec_rate,
    coll_rate of xh1_av under temper_av, or the initial temperature when
    it is None]."""
    comp = cfg.compressed_xfrac
    ca = grid_counts(cfg, ndens, xh1_intermed, temper_av, clumping,
                     compressed=comp)
    cr = grid_counts(cfg, ndens, xh1_av, temper_av, clumping,
                     compressed=comp)
    return torch.stack([ca.h0, ca.h1, cr.rec_rate, cr.coll_rate])


def audit_terms(cfg: RunConfig, ndens: torch.Tensor,
                xh1_intermed: torch.Tensor, xh1_av: torch.Tensor,
                temper_av: Optional[torch.Tensor] = None,
                clumping: Union[float, torch.Tensor] = 1.0
                ) -> torch.Tensor:
    """The kernel's audit terms of each cell, in torch: (4, *ndens.shape)
    in ndens' dtype, [nd x0, nd x1 of xh1_intermed; (nd x1) ne brech,
    (nd x0) ne acol of xh1_av], from the scalars and in the order of
    operations the kernel takes (audit_scalars; the heat build's rates at
    temper_av, as ops/doric.recombination_rates).  Their float64 sums are
    the kernel's audit up to the order of the sum."""
    from ..state import xh0_of, xh1_of

    def split(x):
        if cfg.compressed_xfrac:
            return xh1_of(x), xh0_of(x)
        return x, 1.0 - x

    x1i, x0i = split(xh1_intermed)
    x1a, x0a = split(xh1_av)
    if temper_av is not None:
        brech, acol = recombination_rates(temper_av, clumping)
    else:
        s_brech, pw, t, neg_t = audit_scalars(cfg, clumping)
        brech = (clumping * const.BH00 * pw
                 if isinstance(clumping, torch.Tensor) else s_brech)
        full = dict(dtype=ndens.dtype, device=ndens.device)
        acol = const.COLH0 * torch.sqrt(torch.full((), t, **full)) \
            * torch.exp(torch.full((), neg_t, **full))
    ne = ndens * (x1a + const.ABU_C)
    return torch.stack([ndens * x0i, ndens * x1i, ndens * x1a * ne * brech,
                        ndens * x0a * ne * acol])


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
    """global_chemistry on CUDA tensors, one kernel launch (the arguments
    are global_chemistry's).  dt and cosmo_cool_coeff are Python numbers
    or one-element float64 tensors on the card, which the kernel reads at
    launch (sweep_cuda.step_scalar);
    clumping and photon_loss_rate a number, a 0-d tensor or a grid of
    ndens' shape.  The result's counters hold the kernel's COUNTERS, its
    audit the photon audit's AUDIT sums."""
    return _chemistry(cfg, dt, ndens, xh1_old, xh1_intermed, xh1_av, phih,
                      phiheat, temper_current, temper_av, clumping, cool,
                      cosmo_cool_coeff, photon_loss_rate, max_subcycles,
                      count=True)


def _chemistry(cfg: RunConfig, dt, ndens, xh1_old, xh1_intermed, xh1_av,
               phih, phiheat, temper_current, temper_av, clumping, cool,
               cosmo_cool_coeff, photon_loss_rate, max_subcycles,
               defines=(), audit=True, count=False) -> ChemistryResult:
    """Launch the kernel (the build of ndens' dtype, with the timing
    `defines` added, none by default), with the photon audit unless
    audit is False (its result's audit then None); count: add the kernel
    launches the C entry reports to LAUNCHES."""
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
    brech = acol = None
    brech_stride = 0
    clump_bh = 0.0
    clump, clump_stride, c = _operand("clumping", clumping, ndens)
    if heat:
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
        coeff, *audit_scalars(cfg, clumping))
    out_int = torch.empty_like(ndens)
    out_av = torch.empty_like(ndens)
    out_tint = torch.empty_like(ndens) if heat else None
    out_tav = torch.empty_like(ndens) if heat else None
    # the kernel writes every counter and audit sum: no zero fill
    counters = torch.empty(len(COUNTERS), dtype=torch.int64, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    defines = build.defines + tuple(defines)
    lib, fn = _entry("chemistry", _SIGNATURES, defines)
    blocks = _entry("chemistry_blocks", _SIGNATURES, defines)[1]
    blocks.restype = _ll
    nblocks = blocks(ndens.numel())
    if nblocks < 1:
        raise RuntimeError("chemistry kernel: no CUDA device to size its "
                           "scratch")
    partial = torch.empty(len(COUNTERS) * nblocks, dtype=torch.int64,
                          device=dev)
    audit_out = (torch.empty(len(AUDIT), dtype=dtype, device=dev) if audit
                 else None)
    apartial = (torch.empty(len(AUDIT) * nblocks, dtype=torch.float64,
                            device=dev) if audit else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = ctypes.c_int(0)
    rc = fn(ptr(ndens), ptr(xh1_old), ptr(xh1_intermed), ptr(xh1_av),
            ptr(phih), ptr(loss), loss_stride, ptr(brech), brech_stride,
            ptr(acol), ptr(clump), clump_stride, ptr(phiheat),
            ptr(temper_current), ptr(temper_av), ptr(cie), scalars, dt_p,
            coeff_p, ndens.numel(), cfg.max_chemistry_iterations,
            int(max_subcycles), int(heat), int(cfg.compressed_xfrac),
            ptr(out_int), ptr(out_av), ptr(out_tint), ptr(out_tav),
            ptr(counters), ptr(partial), ptr(apartial), ptr(audit_out),
            ctypes.byref(launches), stream)
    _check_rc(lib, rc, "chemistry")
    if launches.value == 0:         # an empty grid: nothing launched
        counters.zero_()
        if audit:
            audit_out.zero_()
    if count:
        LAUNCHES.add(build.key, launches.value, dev)
    return ChemistryResult(out_int, out_av, out_tint, out_tav,
                           counters[0].to(torch.int32),
                           counters[1].to(torch.int32), counters, audit_out)
