"""Analytic time-dependent ionization update ("doric"), PyTorch port of
c2ray_tpu/ops/doric.py (doric.f90:33-134).

With (iterated) constant rates over the step, x(t) relaxes exponentially
toward its equilibrium; the exact time average over the step comes out
as well.  Elementwise over tensors of any shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as const
from ..config import RunConfig


class DoricResult(NamedTuple):
    xh1: torch.Tensor      # ionized fraction at end of step
    xh0: torch.Tensor      # neutral fraction at end of step
    xh1_av: torch.Tensor   # time-averaged ionized fraction
    xh0_av: torch.Tensor   # time-averaged neutral fraction


def electrondens(ndens, xh1):
    """Electron density n_e = n (x_HII + abu_c). tped.f90:75-83."""
    return ndens * (xh1 + const.ABU_C)


def recombination_rates(temperature, clumping=1.0):
    """(brech0, acolh0): clumped case-B recombination and collisional
    ionization coefficients at T (doric.f90:74-79)."""
    brech0 = clumping * const.BH00 * (temperature / 1e4) ** const.ALBPOW
    acolh0 = (const.COLH0 * torch.sqrt(temperature)
              * torch.exp(-const.TEMPH0 / temperature))
    return brech0, acolh0


def doric(cfg: RunConfig, dt, temperature, rhe, xh1_old, phih,
          clumping=1.0, rates=None, xh0_old=None) -> DoricResult:
    """Time-dependent H ionization solution over a step dt
    (doric.f90:96-124):

      A = phih + n_e colH0(T),  D = A + n_e C alphaB(T)
      x_eq = A / D,  x(t) = (x0 - x_eq) e^{-D dt} + x_eq
      <x> = x_eq + (x0 - x_eq) (1 - e^{-D dt}) / (D dt)

    temperature is a tensor (a 0-d one broadcasts).  rates: optional
    precomputed recombination_rates(temperature, clumping), which the
    isothermal chemistry loop hoists out of its iterations.  xh0_old: the
    exact step-initial neutral fraction (compressed storage); the neutral
    side then relaxes from it natively, never through 1 - x_HII.
    """
    eps = cfg.epsilon
    brech0, acolh0 = (rates if rates is not None
                      else recombination_rates(temperature, clumping))

    aih0 = phih + rhe * acolh0
    delth = aih0 + rhe * brech0
    eqxfh1 = aih0 / delth
    eqxfh0 = rhe * brech0 / delth
    deltht = delth * dt
    ee = torch.exp(-deltht)

    native_xh0 = xh0_old is not None
    if not native_xh0:
        xh0_old = 1.0 - xh1_old
    xh1 = (xh1_old - eqxfh1) * ee + eqxfh1
    xh0 = (xh0_old - eqxfh0) * ee + eqxfh0

    # precision guard (doric.f90:108-111)
    under = xh0 < eps
    xh0 = torch.where(under, eps, xh0)
    xh1 = torch.where(under, 1.0 - eps, xh1)

    # exact time average; -expm1(-x)/x is stable for all x
    avg_factor = torch.where(deltht < 1.0e-8, torch.ones_like(deltht),
                             -torch.expm1(-deltht) / deltht)
    xh1_av = eqxfh1 + (xh1_old - eqxfh1) * avg_factor
    if native_xh0:
        # the same relaxation applied to the neutral side directly
        xh0_av = torch.clamp(eqxfh0 + (xh0_old - eqxfh0) * avg_factor,
                             min=eps)
    else:
        xh0_av = torch.clamp(1.0 - xh1_av, min=eps)   # doric.f90:128
    return DoricResult(xh1, xh0, xh1_av, xh0_av)
