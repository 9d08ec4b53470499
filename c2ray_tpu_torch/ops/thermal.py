"""Thermal evolution, PyTorch port of c2ray_tpu/ops/thermal.py: the CIE
cooling table and the subcycled heating/cooling integration of every cell
(cooling.f90:26-87, thermal.f90:22-176, tped.f90:41-83).

The reference reads a 61-point log10(T) cooling curve from
'tables/corocool.tab', which is not part of the repository; setup_cool
defaults to the JAX package's analytic H-only CIE curve (kept here as a
numpy copy) in the same format, and loads such a file when given one.

Every cell integrates its internal energy in its own sequence of adaptive
substeps until its cumulative time reaches the step.  The JAX masked
lax.while_loop becomes a Python loop of substep passes: a pass in which a
cell has stopped leaves it bitwise unchanged, and the host counts the
passes, so the cap of max_subcycles substeps is exact.  With
cfg.thermal_compact the pass over the dense grid runs only while more than
m_cap cells still run; the stragglers finish in a compacted vector with
the same substep closure, so every cell takes the same substeps on the
same numbers and the result is bitwise that of the dense loop.  Each test
of the running cells is a device-to-host sync: the dense loop tests after
every pass (a pass over the grid costs far more than the sync), the
compacted loop, whose passes are short, every _SYNC_EVERY passes.  TRIPS
counts the passes of each kind.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as const
from ..config import RunConfig, resolve_device
from .doric import electrondens
from .tables import LOG10_E

TEMPPOINTS = 61      # cooling.f90:26
_SYNC_EVERY = 4      # substeps between host tests of the running cells

# thermal calls, and the dense and compacted substep passes they made
TRIPS = {"calls": 0, "dense": 0, "compact": 0}


class CoolingTable(NamedTuple):
    """log10(T)-indexed CIE cooling curve (erg cm^3/s). cooling.f90:26-31."""

    cie_cool: torch.Tensor  # (TEMPPOINTS,) linear cooling rates
    mintemp: float          # lowest log10(T)
    dtemp: float            # log10(T) step


def analytic_cie_curve(logT: np.ndarray) -> np.ndarray:
    """H-only collisional-ionization-equilibrium cooling curve, per n_H n_e
    (erg cm^3/s), like the corocool table: collisional excitation and
    ionization of HI, case-B recombination and free-free emission (Cen
    1992 fits), with x_HI / x_HII the CIE balance between collisional
    ionization and case-B recombination at T.  A copy of the JAX
    package's curve."""
    T = 10.0 ** np.asarray(logT, dtype=np.float64)
    sq5 = 1.0 + np.sqrt(T / 1e5)
    with np.errstate(over="ignore", under="ignore"):
        cion = 5.85e-11 * np.sqrt(T) * np.exp(-157809.1 / T) / sq5
        alphab = const.BH00 * (T / 1e4) ** const.ALBPOW
        x1 = cion / (cion + alphab)
        x0 = 1.0 - x1
        lam_exc = 7.50e-19 * np.exp(-118348.0 / T) / sq5 * x0
        lam_cion = 1.27e-21 * np.sqrt(T) * np.exp(-157809.1 / T) / sq5 * x0
        lam_rec = 0.75 * 3.41e-27 * np.sqrt(T) * (T / 1e3) ** (-0.2) / (
            1.0 + (T / 1e6) ** 0.7) * x1
        lam_ff = 1.42e-27 * 1.3 * np.sqrt(T) * x1
    lam = lam_exc + lam_cion + lam_rec + lam_ff
    return np.maximum(lam, 1e-60)


def setup_cool(cfg: RunConfig, table_file: Optional[str] = None,
               device=None) -> CoolingTable:
    """Build (or read) the cooling table (cooling.f90:64-87): the analytic
    curve on 61 points of log10(T) in [1, 9], or a corocool.tab-format
    file (log10 T, log10 rate).  device: None means CUDA, as elsewhere in
    the port."""
    if table_file is not None:
        data = np.loadtxt(table_file)
        logT = data[:, 0]
        cie = 10.0 ** data[:, 1]
    else:
        logT = np.linspace(1.0, 9.0, TEMPPOINTS)
        cie = analytic_cie_curve(logT)
    return CoolingTable(
        cie_cool=torch.as_tensor(cie.astype(cfg.np_dtype),
                                 device=resolve_device(device)),
        mintemp=float(logT[0]),
        dtemp=float(logT[1] - logT[0]))


def coolin(cool: CoolingTable, nucldens, eldens, temp):
    """Cooling rate with linear table interpolation (cooling.f90:38-59);
    log10 as XLA lowers it, the natural log times log10(e)."""
    tpos = (torch.log(temp) * LOG10_E - cool.mintemp) / cool.dtemp + 1.0
    itpos = torch.clamp(torch.floor(tpos).to(torch.int32), 1, TEMPPOINTS - 1)
    dtpos = tpos - itpos.to(temp.dtype)
    itpos1 = torch.clamp(itpos + 1, max=TEMPPOINTS)
    c0 = cool.cie_cool[(itpos - 1).long()]
    c1 = cool.cie_cool[(itpos1 - 1).long()]
    return nucldens * eldens * (c0 + (c1 - c0) * dtpos)


def temper2pressr(temper, ndens, eldens):
    """p = (n + n_e) k_B T. tped.f90:41-53."""
    return (ndens + eldens) * const.K_B * temper


def pressr2temper(pressr, ndens, eldens):
    """T = p / ((n + n_e) k_B). tped.f90:58-70."""
    return pressr / (const.K_B * (ndens + eldens))


class ThermalResult(NamedTuple):
    final_temperature: torch.Tensor
    average_temperature: torch.Tensor


def _make_substep(cfg: RunConfig, cool: CoolingTable, dt: torch.Tensor,
                  ndens_atom, ne_av, cosmo_rate, heat_rate):
    """One adaptive subcycle step (thermal.f90:98-159) as a closure over
    the per-cell fields: the same function serves the dense grid pass and
    the compacted straggler pass, so the per-cell substep sequences, and
    every bit of the result, are the same.  State: (e_int, t_interm,
    avg_acc, cum, running)."""
    minitemp = cfg.minitemp
    e_floor = temper2pressr(minitemp, ndens_atom, ne_av)

    def substep(state):
        e_int, t_interm, avg_acc, cum, running = state
        cooling = coolin(cool, ndens_atom, ne_av, t_interm) + cosmo_rate
        thermal_rate = torch.clamp(torch.abs(cooling - heat_rate), min=1e-50)
        dt_thermal = cfg.relative_denergy * e_int / thermal_rate
        dt_ode = torch.minimum(dt_thermal, dt - cum)
        e_new = e_int + dt_ode * (heat_rate - cooling)
        avg_new = avg_acc + 0.5 * t_interm * dt_ode
        t_new = pressr2temper(e_new * const.GAMMA1, ndens_atom, ne_av)
        avg_new = avg_new + 0.5 * t_new * dt_ode
        # temperature floor (thermal.f90:142-148); the reference stores the
        # *pressure* as internal energy here (no /gamma1): reproduced
        floor = t_new < minitemp
        e_new = torch.where(floor, e_floor, e_new)
        t_new = torch.where(floor, minitemp, t_new)
        cum_new = cum + dt_ode
        done = (cum_new >= dt) | (torch.abs(cum_new - dt) < 1e-6 * dt)
        still = running & ~done

        def keep(new, old):
            return torch.where(running, new, old)

        return (keep(e_new, e_int), keep(t_new, t_interm),
                keep(avg_new, avg_acc), keep(cum_new, cum), still)

    return substep


def _subcycle(substep, state, i: int, max_subcycles: int, more,
              kind: str, every: int):
    """Substep passes while i < max_subcycles and more(running) holds, the
    test made every `every` passes; -> (state, i).  Passes after a cell
    stops leave it unchanged, so the extra passes between two tests change
    nothing, or only advance running cells by the substeps that they would
    take anyway, and i counts every pass."""
    start = i
    while i < max_subcycles:
        if (i - start) % every == 0 and not bool(more(state[-1])):
            break
        state = substep(state)
        i += 1
        TRIPS[kind] += 1
    return state, i


def _thermal_core(cfg: RunConfig, cool: CoolingTable, dt: torch.Tensor,
                  initial_temperature, ndens_atom, ne_av, e0, cosmo_rate,
                  heat_rate, active0, max_subcycles: int):
    """Subcycle integration of the grid; -> (e_int, avg_acc)."""
    shape = initial_temperature.shape
    full = [torch.broadcast_to(x, shape)
            for x in (ndens_atom, ne_av, cosmo_rate, heat_rate)]
    substep = _make_substep(cfg, cool, dt, *full)
    zero = torch.zeros_like(initial_temperature)
    state = (torch.broadcast_to(e0, shape), initial_temperature, zero, zero,
             torch.broadcast_to(active0, shape))

    if not cfg.thermal_compact:
        state, _ = _subcycle(substep, state, 0, max_subcycles,
                             lambda run: run.any(), "dense", 1)
        return state[0], state[2]

    # straggler compaction: the dense loop's trip count follows the worst
    # cell, so it runs only while more than m_cap cells still subcycle;
    # the rest finish in a compact vector with the same closure
    ncell = int(np.prod(shape))
    m_cap = min(ncell, max(1024, ncell // 64))
    state, i = _subcycle(substep, state, 0, max_subcycles,
                         lambda run: run.sum() > m_cap, "dense", 1)
    e_f, t_f, avg_f, cum_f, run_f = (x.reshape(-1) for x in state)
    if i >= max_subcycles:
        return e_f.reshape(shape), avg_f.reshape(shape)
    idx = torch.nonzero(run_f).squeeze(1)
    if idx.numel() == 0:
        return e_f.reshape(shape), avg_f.reshape(shape)
    csub = _make_substep(cfg, cool, dt, *(x.reshape(-1)[idx] for x in full))
    cstate = (e_f[idx], t_f[idx], avg_f[idx], cum_f[idx], run_f[idx])
    cstate, _ = _subcycle(csub, cstate, i, max_subcycles,
                          lambda run: run.any(), "compact", _SYNC_EVERY)
    e_f = e_f.clone()
    avg_f = avg_f.clone()
    e_f[idx] = cstate[0]
    avg_f[idx] = cstate[2]
    return e_f.reshape(shape), avg_f.reshape(shape)


def thermal(cfg: RunConfig, cool: CoolingTable, dt, initial_temperature,
            ndens_electron, ndens_atom, xh1_end, xh1_av, xh1_old, heat_rate,
            cosmo_cool_coeff=0.0, max_subcycles: int = 10000
            ) -> ThermalResult:
    """Subcycled explicit internal-energy integration of every cell
    (thermal.f90:22-176): the energy step is at most relative_denergy of
    the thermal timescale, and the time-averaged temperature accumulates
    trapezoidally over the substeps.  The signature is the JAX twin's
    (ndens_electron is unused there too).

    cosmo_cool_coeff: 2 (dz/dt) / (1+z) at the current redshift; the
    reference evaluates the adiabatic cooling rate once from the INITIAL
    internal energy (thermal.f90:74-79): reproduced.

    cfg.thermal_compact finishes straggler cells in a compacted vector
    (bitwise the same).  cfg.thermal_chunk is ignored: the JAX package's
    slabbing works around a TPU worker fault and has no counterpart here.
    """
    TRIPS["calls"] += 1
    dtype, dev = initial_temperature.dtype, initial_temperature.device
    dt = (torch.as_tensor(dt, dtype=dtype, device=dev)
          if isinstance(dt, torch.Tensor)
          else torch.full((), dt, dtype=dtype, device=dev))
    e0 = temper2pressr(initial_temperature, ndens_atom,
                       electrondens(ndens_atom, xh1_old)) / const.GAMMA1
    cosmo_rate = cosmo_cool_coeff * e0
    ne_av = electrondens(ndens_atom, xh1_av)
    active0 = initial_temperature > cfg.minitemp      # thermal.f90:83

    e_int, avg_acc = _thermal_core(cfg, cool, dt, initial_temperature,
                                   ndens_atom, ne_av, e0, cosmo_rate,
                                   heat_rate, active0, max_subcycles)
    avg_t = torch.where(dt > 0.0, avg_acc / dt, initial_temperature)
    final_t = pressr2temper(e_int * const.GAMMA1, ndens_atom,
                            electrondens(ndens_atom, xh1_end))
    # cells at or below minitemp stay untouched (thermal.f90:83,174)
    avg_t = torch.where(active0, avg_t, initial_temperature)
    final_t = torch.where(active0, final_t, initial_temperature)
    return ThermalResult(final_t, avg_t)
