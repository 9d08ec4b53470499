"""Grid-wide chemistry pass, PyTorch port of c2ray_tpu/ops/chemistry.py
(evolve0D_global + do_chemistry, evolve_point.F90:305-555), isothermal
and non-isothermal.

Each cell iterates the analytic doric update against its time-averaged
electron density, restarting from the step-initial state, until it
converges; converged cells freeze.  Non-isothermally every iteration
also integrates the cell's temperature (ops/thermal.py) from the
step-initial temperature under the photo-heating rate, and the next
iteration's recombination rates follow the time-averaged temperature; as
in the JAX twin (and the reference, whose temperature test compares a
value with itself) only the ionization decides a cell's convergence.

global_chemistry takes the hand-written kernel (ops/chemistry_cuda.py,
csrc/chemistry.cu: one thread per cell runs its own passes and thermal
substeps) for CUDA tensors and the plain version,
global_chemistry_reference, for CPU tensors; it never falls back.

In the plain version the JAX masked lax.while_loop becomes a Python
loop.  Testing `active.any()` costs a device-to-host sync, so the
isothermal loop tests it only every `_SYNC_EVERY` iterations: once every
cell is inactive a pass changes nothing, so the extra passes leave the
outputs bitwise unchanged, and the iteration count is accumulated on the
device from `active.any()` so it stays exact too.  The non-isothermal
loop tests after every iteration: its extra pass would integrate the
temperature of the whole grid again, which costs far more than the
sync.  The 400-iteration cap is exact.  Its 0-d constants are device
fills (torch.full), not copies from the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..config import RunConfig
from .doric import doric, electrondens, recombination_rates
from .thermal import CoolingTable, thermal

_SYNC_EVERY = 4      # inner iterations between host tests of active.any()


class ChemistryResult(NamedTuple):
    xh1_intermed: torch.Tensor   # end-of-step ionized fraction
    xh1_av: torch.Tensor         # time-averaged ionized fraction
    temper_intermed: Optional[torch.Tensor]
    temper_av: Optional[torch.Tensor]
    conv_flag: torch.Tensor      # number of non-converged cells (0-d int)
    n_iterations: torch.Tensor   # inner fixed-point iterations used (0-d)
    # the kernel's int64 counters (chemistry_cuda.COUNTERS); None from
    # the plain version
    counters: Optional[torch.Tensor] = None
    # the kernel's photon audit, (4,) [h0, h1, rec_rate, coll_rate] of
    # the two photonstats.grid_counts calls of the solver's tail
    # (chemistry_cuda.audit_reference); None from the plain version
    audit: Optional[torch.Tensor] = None


def global_chemistry(cfg: RunConfig, dt, ndens: torch.Tensor,
                     xh1_old: torch.Tensor, xh1_intermed: torch.Tensor,
                     xh1_av: torch.Tensor, phih: torch.Tensor,
                     phiheat=None, temper_current=None, temper_av=None,
                     clumping: Union[float, torch.Tensor] = 1.0,
                     cool: Optional[CoolingTable] = None,
                     cosmo_cool_coeff=0.0,
                     photon_loss_rate: Union[float, torch.Tensor] = 0.0,
                     max_subcycles: int = 10000) -> ChemistryResult:
    """One global pass over the mesh (global_pass -> evolve0D_global).
    Argument order follows the JAX twin.  Non-isothermal runs need the
    heating grid phiheat, the step-initial temper_current, the iterate
    temper_av and the cooling table cool; cosmo_cool_coeff is the
    adiabatic-cooling coefficient (ops/thermal.thermal); max_subcycles
    caps each cell's thermal substeps in a pass.  The kernel on a CUDA
    device, the plain version on the CPU."""
    if ndens.device.type == "cpu":
        return global_chemistry_reference(
            cfg, dt, ndens, xh1_old, xh1_intermed, xh1_av, phih, phiheat,
            temper_current, temper_av, clumping, cool, cosmo_cool_coeff,
            photon_loss_rate, max_subcycles)
    from .chemistry_cuda import global_chemistry_cuda
    return global_chemistry_cuda(
        cfg, dt, ndens, xh1_old, xh1_intermed, xh1_av, phih, phiheat,
        temper_current, temper_av, clumping, cool, cosmo_cool_coeff,
        photon_loss_rate, max_subcycles)


def global_chemistry_reference(cfg: RunConfig, dt, ndens: torch.Tensor,
                               xh1_old: torch.Tensor,
                               xh1_intermed: torch.Tensor,
                               xh1_av: torch.Tensor, phih: torch.Tensor,
                               phiheat=None, temper_current=None,
                               temper_av=None,
                               clumping: Union[float, torch.Tensor] = 1.0,
                               cool: Optional[CoolingTable] = None,
                               cosmo_cool_coeff=0.0,
                               photon_loss_rate: Union[float,
                                                       torch.Tensor] = 0.0,
                               max_subcycles: int = 10000
                               ) -> ChemistryResult:
    """Plain version of global_chemistry, on any device: the masked grid
    loop of the JAX twin as a host-driven Python loop."""
    isothermal = cfg.isothermal
    if not isothermal and (cool is None or phiheat is None
                           or temper_current is None or temper_av is None):
        raise ValueError("non-isothermal chemistry needs cool, phiheat, "
                         "temper_current and temper_av")
    compressed = cfg.compressed_xfrac
    dtype, dev = ndens.dtype, ndens.device
    eps = cfg.epsilon
    mfc = cfg.minimum_fractional_change
    min_atoms = cfg.minimum_fraction_of_atoms
    dt = torch.full((), dt, dtype=dtype, device=dev)

    # initial local states (evolve_point.F90:341-354); under compressed
    # storage the x inputs are signed min-fraction tensors and both sides
    # decode tail-exactly, and the neutral side is carried natively
    if compressed:
        from ..state import compress_xh, xh0_of, xh1_of
        h1 = torch.clamp(xh1_of(xh1_intermed), min=eps)
        h0 = torch.clamp(xh0_of(xh1_intermed), min=eps)
        h1_old = torch.clamp(xh1_of(xh1_old), min=eps)
        h0_old = torch.clamp(xh0_of(xh1_old), min=eps)
        h_av1 = torch.clamp(xh1_of(xh1_av), min=eps)
        h_av0 = torch.clamp(xh0_of(xh1_av), min=eps)
        h_av0_start = h_av0
    else:
        h1 = torch.clamp(xh1_intermed, min=eps)
        h1_old = torch.clamp(xh1_old, min=eps)
        h_av1 = torch.clamp(xh1_av, min=eps)
        h0_old = None

    if isothermal:
        # T is the same constant in every cell and iteration, so its rate
        # coefficients are computed once (the same float ops as the JAX
        # twin's per-cell full_like(T) evaluation)
        t_av = torch.full((), cfg.initial_temperature, dtype=dtype,
                          device=dev)
        rates = recombination_rates(t_av, clumping)
        t_int = None
    else:
        t_cur0 = temper_current
        t_int, t_av = temper_current, temper_av
        rates = None
    phih_total = phih + photon_loss_rate

    active = torch.ones(ndens.shape, dtype=torch.bool, device=dev)
    n_iter = torch.zeros((), dtype=torch.int32, device=dev)
    every = _SYNC_EVERY if isothermal else 1
    nit = 1
    while nit <= cfg.max_chemistry_iterations:
        if (nit - 1) % every == 0 and not bool(active.any()):
            break
        n_iter += active.any().to(torch.int32)
        h_av0_prev = h_av0 if compressed else torch.clamp(1.0 - h_av1,
                                                          min=eps)
        de = electrondens(ndens, h_av1)
        res = doric(cfg, dt, t_av, de, h1_old, phih_total, clumping,
                    rates=rates, xh0_old=h0_old)
        if not isothermal:
            # (thermal's electron-density argument is unused, as in JAX)
            th = thermal(cfg, cool, dt, t_cur0, None, ndens, res.xh1,
                         res.xh1_av, h1_old, phiheat, cosmo_cool_coeff,
                         max_subcycles)
            t_int = torch.where(active, th.final_temperature, t_int)
            t_av = torch.where(active, th.average_temperature, t_av)
        converged = ((torch.abs((res.xh0_av - h_av0_prev) / res.xh0_av)
                      < mfc) | (res.xh0_av < min_atoms))
        h1 = torch.where(active, res.xh1, h1)
        h_av1 = torch.where(active, res.xh1_av, h_av1)
        if compressed:
            h0 = torch.where(active, res.xh0, h0)
            h_av0 = torch.where(active, res.xh0_av, h_av0)
        active = active & ~converged
        nit += 1

    # outer non-convergence count (evolve_point.F90:384-391)
    if compressed:
        yh0_av_old = h_av0_start
        h_av0_end = h_av0
    else:
        yh1_av_old = torch.clamp(xh1_av, min=eps)
        yh0_av_old = 1.0 - yh1_av_old
        h_av0_end = torch.clamp(1.0 - h_av1, min=eps)
    ion_cond = ((torch.abs(h_av0_end - yh0_av_old) > mfc)
                & (torch.abs((h_av0_end - yh0_av_old) / h_av0_end) > mfc)
                & (h_av0_end > min_atoms))
    if not isothermal:
        ion_cond = ion_cond | ((torch.abs((temper_av - t_av) / t_av) > 1.0e-1)
                               & (torch.abs(temper_av - t_av) > 100.0))
    conv_flag = ion_cond.sum().to(torch.int32)
    if compressed:
        h1 = compress_xh(h1, h0)
        h_av1 = compress_xh(h_av1, h_av0)
    if isothermal:
        return ChemistryResult(h1, h_av1, None, None, conv_flag, n_iter)
    return ChemistryResult(h1, h_av1, t_int, t_av, conv_flag, n_iter)
