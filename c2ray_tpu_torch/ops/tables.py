"""SED integration and photoionization/heating rate tables (PyTorch port).

Host-side (numpy) construction of the tau-indexed photon-conserving rate
tables - a copy of the builder in c2ray_tpu/ops/tables.py, so both
packages evaluate identical tables and mixture constants - plus the
device-side rate assembly written in torch.

Reference mapping:
  - SED setup + S_star scaling:  radiation_sed_parameters.F90:82-283
  - band/cross-section setup:    radiation_sizes.f90:36-89
  - table construction:          radiation_tables.F90:95-565
  - lookup + rate assembly:      radiation_photoionrates.F90:71-417
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as const
from ..config import RunConfig, resolve_device
from .romberg import scalar_romberg, vector_romberg


class RadTables(NamedTuple):
    """Rate tables (one frequency band, H-only), torch tensors on a device.

    Field for field the JAX package's RadTables: the thick/thin photo and
    heat tables over optical depth (num_tau+1 entries), the X-ray tables,
    and the K-term exponential mixture (exp_a decay rates, exp_w photo
    weights, heat_exp_w heat weights) with its X-ray twin.
    """

    photo_thick: torch.Tensor
    photo_thin: torch.Tensor
    heat_thick: torch.Tensor
    heat_thin: torch.Tensor
    xray_photo_thick: torch.Tensor
    xray_photo_thin: torch.Tensor
    xray_heat_thick: torch.Tensor
    xray_heat_thin: torch.Tensor
    exp_a: torch.Tensor = None
    exp_w: torch.Tensor = None
    heat_exp_w: torch.Tensor = None
    xray_exp_a: torch.Tensor = None
    xray_exp_w: torch.Tensor = None
    xray_heat_exp_w: torch.Tensor = None


class SEDProperties(NamedTuple):
    """Host-side diagnostics of the scaled SED (spec_diag).

    Reference: radiation_sed_parameters.F90:172-224.
    """

    s_star: float
    r_star: float
    l_star: float
    ionizing_luminosity: float
    s_scaling: float
    t_eff: float
    h_over_kt: float


# ---------------------------------------------------------------------------
# host-side construction
# ---------------------------------------------------------------------------

def _bb_sed_photon(freq: np.ndarray, h_over_kt: float, r_star2: float) -> np.ndarray:
    """Black-body SED in photon-number sense (per Hz per s).

    BB_SED = 4 pi R*^2 (2 pi/c^2) nu^2 / (exp(h nu / kT) - 1), with overflow
    guard. Reference: radiation_tables.F90:434-452.
    """
    x = freq * h_over_kt
    safe = x < 700.0
    with np.errstate(over="ignore"):
        denom = np.where(safe, np.expm1(np.where(safe, x, 1.0)), np.inf)
    out = 4.0 * np.pi * r_star2 * const.TWO_PI_OVER_C_SQUARE * freq * freq / denom
    return np.where(safe, out, 0.0)


def _pl_sed_photon(freq: np.ndarray, pl_index: float, s_scaling: float) -> np.ndarray:
    """Power-law SED in photon-number sense. radiation_tables.F90:456-467."""
    return s_scaling * freq ** (-pl_index)


def integrate_sed(cfg: RunConfig, freq_min: float, freq_max: float,
                  sourcetype: str, sedtype: str,
                  r_star: float = const.R_SOLAR, s_scaling: float = 1.0) -> float:
    """Romberg-integrate the (unscaled) SED over [freq_min, freq_max].

    sedtype 'S' = photon sense, 'L' = energy sense.
    Reference: radiation_sed_parameters.F90:226-283.
    """
    n = cfg.num_freq
    freq = np.linspace(freq_min, freq_max, n + 1)
    h = (freq_max - freq_min) / n
    if sourcetype == "B":
        t_eff = float(np.clip(cfg.sed.bb_teff, 2000.0, 1e6))
        h_over_kt = const.HPLANCK / (const.K_B * t_eff)
        integrand = _bb_sed_photon(freq, h_over_kt, r_star * r_star)
    elif sourcetype == "P":
        integrand = _pl_sed_photon(freq, cfg.sed.pl_index, s_scaling)
    else:
        raise ValueError(f"unknown sourcetype {sourcetype!r}")
    if sedtype == "L":
        integrand = const.HPLANCK * freq * integrand
    return scalar_romberg(integrand, h)


def sed_properties(cfg: RunConfig) -> SEDProperties:
    """Scale the SED so its band-integrated photon rate equals S_star.

    Black body: scale R_star (spec_diag, radiation_sed_parameters.F90:178-202).
    Power law: scale the flux normalization (S_scaling, :204-222).
    """
    sed = cfg.sed
    if sed.stellar_type == "B":
        t_eff = float(np.clip(sed.bb_teff, 2000.0, 1e6))
        h_over_kt = const.HPLANCK / (const.K_B * t_eff)
        r_star = const.R_SOLAR
        l_star = 4.0 * np.pi * r_star**2 * const.SIGMA_SB * t_eff**4
        s_unscaled = integrate_sed(cfg, sed.bb_min_freq, sed.bb_max_freq, "B", "S",
                                   r_star=r_star)
        s_scaling = sed.s_star / s_unscaled
        r_star = np.sqrt(s_scaling) * r_star
        l_star = s_scaling * l_star
        lion = integrate_sed(cfg, sed.bb_min_freq, sed.bb_max_freq, "B", "L",
                             r_star=r_star)
        return SEDProperties(sed.s_star, r_star, l_star, lion, s_scaling,
                             t_eff, h_over_kt)
    else:
        s_unscaled = integrate_sed(cfg, sed.pl_min_freq, sed.pl_max_freq, "P", "S",
                                   s_scaling=1.0)
        s_scaling = sed.pl_s_star / s_unscaled
        lion = integrate_sed(cfg, sed.pl_min_freq, sed.pl_max_freq, "P", "L",
                             s_scaling=s_scaling)
        return SEDProperties(sed.pl_s_star, 0.0, 0.0, lion, s_scaling, 0.0, 0.0)


def _tau_axis(cfg: RunConfig) -> np.ndarray:
    """Optical-depth sample points: tau(0)=0, tau(i)=10^(minlogtau+dlogtau*(i-1)).

    Reference: radiation_tables.F90:141-146.
    """
    dlogtau = (cfg.maxlogtau - cfg.minlogtau) / cfg.num_tau
    tau = 10.0 ** (cfg.minlogtau + dlogtau * (np.arange(cfg.num_tau + 1) - 1.0))
    tau[0] = 0.0
    return tau


def _band_tables(cfg: RunConfig, sed_vals: np.ndarray, freq: np.ndarray,
                 h: float, build_heat: bool):
    """Integrate thick/thin photo (and heat) integrands over frequency for
    every tau.  Reference: radiation_tables.F90:361-430,471-509,524-565."""
    tau = _tau_axis(cfg)
    freq_min = freq[0]
    if cfg.grey:
        xsec = np.ones_like(freq)
    else:
        xsec = (freq / freq_min) ** (-cfg.pl_index_cross_section_hi)
    # integrand(freq, tau); guard exp underflow/overflow at arg 700
    arg = tau[None, :] * xsec[:, None]
    safe = arg < 700.0
    att = np.where(safe, np.exp(-np.where(safe, arg, 0.0)), 0.0)
    thick_i = sed_vals[:, None] * att
    thin_i = thick_i * xsec[:, None]
    photo_thick = vector_romberg(thick_i, h, axis=0)
    photo_thin = vector_romberg(thin_i, h, axis=0)
    if build_heat:
        hw = const.HPLANCK * (freq - const.ION_FREQ_HI)
        heat_thick = vector_romberg(hw[:, None] * thick_i, h, axis=0)
        heat_thin = vector_romberg(hw[:, None] * thin_i, h, axis=0)
    else:
        heat_thick = np.zeros_like(photo_thick)
        heat_thin = np.zeros_like(photo_thin)
    return photo_thick, photo_thin, heat_thick, heat_thin


def _fit_exp_mixture(weights: np.ndarray, ahat: np.ndarray,
                     k: int = 16):
    """Compress sum_i W_i e^{-tau a_i} (the exact frequency-quadrature
    form of the thick integral) into a K-term nonnegative mixture.

    Decay rates a_k are log-spaced over the cross-section-ratio range and
    the weights solved by nonnegative least squares over log-spaced tau
    samples with relative-error weighting.  Returns (a_k, w_photo_k).
    The same a_k basis is reused for the heating weights so photo and
    heat rates share exponentials.
    """
    from scipy.optimize import nnls

    amin, amax = float(ahat.min()), float(ahat.max())
    if amax / amin < 1.0 + 1e-12:
        return np.asarray([amin]), np.asarray([weights.sum()])
    a_k = np.geomspace(amin, amax, k)
    taus = np.concatenate([[0.0], np.geomspace(1e-6, 3.0 / amin, 240)])
    target = (weights[None, :] * np.exp(-np.outer(taus, ahat))).sum(axis=1)
    design = np.exp(-np.outer(taus, a_k))
    # relative weighting, floored so the deep-absorbed tail doesn't dominate
    row_w = 1.0 / np.maximum(np.abs(target), 1e-7 * abs(target[0]))
    w_k, _ = nnls(design * row_w[:, None], target * row_w,
                  maxiter=100 * len(a_k))
    # exactness at tau=0 (photon-count normalization)
    tot = w_k.sum()
    if tot > 0:
        w_k *= target[0] / tot
    return a_k, w_k


def _refine_mixture_nodes(a0: np.ndarray, w0: np.ndarray,
                          hw0: Optional[np.ndarray],
                          weights: np.ndarray,
                          heat_weights: Optional[np.ndarray],
                          ahat: np.ndarray):
    """Shrink the NNLS mixture by jointly optimizing nodes AND weights
    (round 5): NNLS on a FIXED log-spaced basis wastes terms — a bounded
    trust-region refinement of (log a_k, log w_k) meets the NNLS fit
    error with ~20-30%% fewer exponentials (measured: the 10-term
    test-problem blackbody fit compresses to 8 terms at 3x LOWER max
    relative error).  Every mixture evaluation on device (the consume
    kernel, the windowed kernels, the XLA expsum rate pass) pays one
    exp+expm1 per term per cell, so fewer terms is a direct VPU-floor
    reduction (BENCH_HISTORY round-5 consume ablations: the mixture is
    ~72%% of the consume kernel).

    Accepts the smallest k whose refined max weighted relative error is
    <= the incoming fit's, for BOTH the photo target and (when built)
    the heat target; returns the inputs unchanged if no smaller k
    qualifies.  Deterministic (scipy trf, fixed init) and bounded
    (max_nfev); any numerical failure falls back to the NNLS fit.
    """
    try:
        from scipy.optimize import least_squares, nnls
    except Exception:
        return a0, w0, hw0
    if len(a0) <= 4:
        return a0, w0, hw0
    amin, amax = float(ahat.min()), float(ahat.max())
    if amax / amin < 1.0 + 1e-12:
        return a0, w0, hw0
    taus = np.concatenate([[0.0], np.geomspace(1e-6, 3.0 / amin, 240)])

    def mk_target(wv):
        t = (wv[None, :] * np.exp(-np.outer(taus, ahat))).sum(axis=1)
        rw = 1.0 / np.maximum(np.abs(t), 1e-7 * max(abs(t[0]), 1e-300))
        return t, rw

    target, row_w = mk_target(weights)
    if not (target[0] > 0):
        return a0, w0, hw0
    want_heat = heat_weights is not None and hw0 is not None
    if want_heat:
        h_target, h_row_w = mk_target(heat_weights)

    def relmax(a_k, w_k, t, rw):
        fit = (w_k[None, :]
               * np.exp(-np.clip(np.outer(taus, a_k), 0.0, 700.0))
               ).sum(axis=1)
        return float(np.max(np.abs(fit - t) * rw))

    base_err = relmax(a0, w0, target, row_w)
    base_herr = relmax(a0, hw0, h_target, h_row_w) if want_heat else 0.0

    def heat_on(a_k):
        """Heat weights on a candidate basis (shared-node contract)."""
        design = np.exp(-np.clip(np.outer(taus, a_k), 0.0, 700.0))
        w_k, _ = nnls(design * h_row_w[:, None], h_target * h_row_w,
                      maxiter=100 * len(a_k))
        tot = w_k.sum()
        if tot > 0 and h_target[0] > 0:
            w_k *= h_target[0] / tot
        return w_k

    order = np.argsort(-w0)
    lo_a, hi_a = np.log(amin) - 2.0, np.log(amax) + 2.0
    lw_ref = np.log(target[0])
    best = None
    # descend from len-1: refinement succeeds easily at high k and each
    # FAILING k burns the full nfev budget, so stop at the first failure
    # below a success (error grows monotonically as k shrinks)
    for k in range(len(a0) - 1, 3, -1):
        sel = np.sort(order[:k])
        a_init = a0[sel]
        w_init = np.maximum(w0[sel], 1e-9 * target[0])
        lo = np.concatenate([np.full(k, lo_a), np.full(k, lw_ref - 40.0)])
        hi = np.concatenate([np.full(k, hi_a), np.full(k, lw_ref + 3.0)])
        x0 = np.clip(np.concatenate([np.log(a_init), np.log(w_init)]),
                     lo, hi)

        def resid(x):
            a = np.exp(x[:k])
            w = np.exp(x[k:])
            fit = (w[None, :]
                   * np.exp(-np.clip(np.outer(taus, a), 0.0, 700.0))
                   ).sum(axis=1)
            return (fit - target) * row_w

        try:
            sol = least_squares(resid, x0, method="trf", bounds=(lo, hi),
                                max_nfev=1500, xtol=1e-14, ftol=1e-14)
        except Exception:
            break
        a_k = np.exp(sol.x[:k])
        w_k = np.exp(sol.x[k:])
        w_k *= target[0] / w_k.sum()       # exact photon count at tau=0
        if relmax(a_k, w_k, target, row_w) > base_err:
            break
        if want_heat:
            hw_k = heat_on(a_k)
            if relmax(a_k, hw_k, h_target, h_row_w) > base_herr:
                break
        else:
            hw_k = np.zeros_like(w_k) if hw0 is not None else None
        srt = np.argsort(a_k)
        best = (a_k[srt], w_k[srt],
                hw_k[srt] if hw_k is not None else None)
    return best if best is not None else (a0, w0, hw0)


def _fit_heat_weights(a_k: np.ndarray, weights: np.ndarray,
                      ahat: np.ndarray) -> np.ndarray:
    """Heating-mixture weights on the shared a_k basis (may be signed in
    principle; fitted with NNLS since the heat integrand is positive)."""
    from scipy.optimize import nnls

    amin = float(ahat.min())
    taus = np.concatenate([[0.0], np.geomspace(1e-6, 3.0 / amin, 240)])
    target = (weights[None, :] * np.exp(-np.outer(taus, ahat))).sum(axis=1)
    design = np.exp(-np.outer(taus, a_k))
    row_w = 1.0 / np.maximum(np.abs(target), 1e-7 * max(abs(target[0]), 1e-300))
    w_k, _ = nnls(design * row_w[:, None], target * row_w,
                  maxiter=100 * len(a_k))
    tot = w_k.sum()
    if tot > 0 and target[0] > 0:
        w_k *= target[0] / tot
    return w_k


def build_rad_tables(cfg: RunConfig, device=None) -> RadTables:
    """rad_ini equivalent: build all rate tables (host) and ship to device.

    device: where the tensors go; None means CUDA (config.resolve_device).

    Reference: radiation_tables.F90:95-126 (rad_ini), :130-236
    (spec_integration).
    """
    props = sed_properties(cfg)
    sed = cfg.sed
    # Band 1 frequency partition (radiation_sizes.f90:55-66)
    freq_min = max(const.ION_FREQ_HI, sed.min_freq)
    freq_max = sed.max_freq
    n = cfg.num_freq
    freq = np.linspace(freq_min, freq_max, n + 1)
    h = (freq_max - freq_min) / n

    if sed.stellar_type == "B":
        sed_vals = _bb_sed_photon(freq, props.h_over_kt, props.r_star**2)
    else:
        sed_vals = _pl_sed_photon(freq, sed.pl_index, props.s_scaling)

    build_heat = not cfg.isothermal
    pt, pn, ht, hn = _band_tables(cfg, sed_vals, freq, h, build_heat)

    if sed.use_xray_sed:
        xs_unscaled = integrate_sed(cfg, sed.pl_min_freq, sed.pl_max_freq, "P", "S")
        x_scaling = sed.pl_s_star / xs_unscaled
        xfreq = np.linspace(max(const.ION_FREQ_HI, sed.pl_min_freq),
                            sed.pl_max_freq, n + 1)
        xh = (xfreq[-1] - xfreq[0]) / n
        xsed = _pl_sed_photon(xfreq, sed.pl_index, x_scaling)
        xpt, xpn, xht, xhn = _band_tables(cfg, xsed, xfreq, xh, build_heat)
    else:
        z = np.zeros_like(pt)
        xpt, xpn, xht, xhn = z, z, z, z

    # Exponential-mixture compression for the fast path: quadrature
    # weights W_i = romberg_w * h * SED_i, cross-section ratios
    # ahat_i = (nu_i/nu_min)^-2.8 (radiation_tables.F90:351-353).
    from .romberg import romberg_weights
    if cfg.grey:
        ahat = np.ones_like(freq)
    else:
        ahat = (freq / freq_min) ** (-cfg.pl_index_cross_section_hi)
    wq = romberg_weights(n) * h * sed_vals
    exp_a, exp_w = _fit_exp_mixture(wq, ahat, k=cfg.num_exp_terms)
    if build_heat:
        heat_wq = wq * const.HPLANCK * (freq - const.ION_FREQ_HI)
        heat_exp_w = _fit_heat_weights(exp_a, heat_wq, ahat)
    else:
        heat_exp_w = np.zeros_like(exp_w)
    # NNLS zeroes a good fraction of the K requested weights; drop terms
    # with no photo AND no heat weight before shipping to the device - a
    # zero-weight term contributes exactly 0.0 (bitwise-identical rates)
    # but still costs its exponentials in the unrolled mixture loop
    # (measured: 10 of 16 terms live for the test-problem blackbody).
    keep = (exp_w != 0) | (heat_exp_w != 0)
    if keep.any():
        exp_a, exp_w, heat_exp_w = exp_a[keep], exp_w[keep], heat_exp_w[keep]
    # node-refinement compression: fewer exponentials at <= the NNLS fit
    # error (each term costs one exp+expm1 per cell per source on device)
    exp_a, exp_w, heat_exp_w = _refine_mixture_nodes(
        exp_a, exp_w, heat_exp_w, wq,
        heat_wq if build_heat else None, ahat)
    if sed.use_xray_sed:
        xahat = (xfreq / xfreq[0]) ** (-cfg.pl_index_cross_section_hi)
        xwq = romberg_weights(n) * xh * xsed
        xexp_a, xexp_w = _fit_exp_mixture(xwq, xahat, k=cfg.num_exp_terms)
        if build_heat:
            xheat_exp_w = _fit_heat_weights(
                xexp_a, xwq * const.HPLANCK * (xfreq - const.ION_FREQ_HI), xahat)
        else:
            xheat_exp_w = np.zeros_like(xexp_w)
        xkeep = (xexp_w != 0) | (xheat_exp_w != 0)
        if xkeep.any():
            xexp_a, xexp_w, xheat_exp_w = (xexp_a[xkeep], xexp_w[xkeep],
                                           xheat_exp_w[xkeep])
        xexp_a, xexp_w, xheat_exp_w = _refine_mixture_nodes(
            xexp_a, xexp_w, xheat_exp_w, xwq,
            xwq * const.HPLANCK * (xfreq - const.ION_FREQ_HI)
            if build_heat else None, xahat)
    else:
        xexp_a, xexp_w = exp_a, np.zeros_like(exp_w)
        xheat_exp_w = np.zeros_like(exp_w)

    s = props.s_star
    sx = sed.pl_s_star          # X-ray fluxes are normalized by S_star_xray
    dt = cfg.np_dtype
    dev = resolve_device(device)

    def put(a, scale=None):
        a = np.asarray(a)
        if scale is not None:
            a = a / scale
        return torch.from_numpy(np.ascontiguousarray(a.astype(dt))).to(dev)

    return RadTables(put(pt, s), put(pn, s), put(ht, s), put(hn, s),
                     put(xpt, sx), put(xpn, sx), put(xht, sx), put(xhn, sx),
                     exp_a=put(exp_a), exp_w=put(exp_w, s),
                     heat_exp_w=put(heat_exp_w, s),
                     xray_exp_a=put(xexp_a), xray_exp_w=put(xexp_w, sx),
                     xray_heat_exp_w=put(xheat_exp_w, sx))


# ---------------------------------------------------------------------------
# device-side lookup and rate assembly
# ---------------------------------------------------------------------------

# jnp.log10's constant: log10(e), one ulp above the float 1/np.log(10)
LOG10_E = float(np.log10(np.e))


def table_lookup(table: torch.Tensor, tau: torch.Tensor,
                 cfg: RunConfig) -> torch.Tensor:
    """Linear interpolation in log10(tau) table position
    (radiation_photoionrates.F90:184-228): tau floors at 1e-20 so tau=0
    reads position 1."""
    dlogtau = (cfg.maxlogtau - cfg.minlogtau) / cfg.num_tau
    # log10 as XLA lowers it: natural log times log10(e)
    logtau = torch.log(torch.clamp(tau, min=1.0e-20)) * LOG10_E
    odpos = torch.clamp(1.0 + (logtau - cfg.minlogtau) / dlogtau,
                        0.0, float(cfg.num_tau))
    ipos = torch.floor(odpos).to(torch.int64)
    resid = odpos - ipos.to(tau.dtype)
    ipos1 = torch.clamp(ipos + 1, max=cfg.num_tau)
    t0 = table[ipos]
    t1 = table[ipos1]
    return t0 + (t1 - t0) * resid


class PhotoRates(NamedTuple):
    """Per-cell rates (radiation_photoionrates.F90:34-44), H-only, in
    S_star photon units and cell-volume units."""

    photo_cell: torch.Tensor   # cell photoionization rate / vol_ph
    photo_in: torch.Tensor     # photon rate entering the cell
    photo_out: torch.Tensor    # photon rate leaving the cell
    heat: torch.Tensor         # heating rate of the cell / vol_ph


def use_expsum(cfg: RunConfig, dtype: torch.dtype) -> bool:
    """rate_eval "expsum", or "auto" in float32: the mixture path."""
    return cfg.rate_eval == "expsum" or (cfg.rate_eval == "auto"
                                         and dtype == torch.float32)


def _photoion_expsum_impl(cfg: RunConfig, tables: RadTables,
                          coldens_in, coldens_out, vol_ph, nflux,
                          nflux_xray, coldens_pre):
    """Exponential-mixture rates, optionally with the fused LLS-absorption
    tally (see photoion_rates_lls_fused).  Returns (PhotoRates, lls_cell).
    Term for term c2ray_tpu.ops.tables._photoion_expsum_impl."""
    sigma = const.SIGMA_HI_AT_ION_FREQ
    tau_in = coldens_in * sigma
    dtau = (coldens_out - coldens_in) * sigma
    if coldens_pre is not None:
        tau_pre = coldens_pre * sigma
        dtau_pre = (coldens_in - coldens_pre) * sigma
    else:
        tau_pre = dtau_pre = None

    def one_source(a, w, hw, nf):
        phi_in = torch.zeros_like(tau_in)
        phi_cell = torch.zeros_like(tau_in)
        heat_acc = torch.zeros_like(tau_in) if not cfg.isothermal else None
        lls_acc = torch.zeros_like(tau_in) if dtau_pre is not None else None
        for i in range(a.shape[0]):
            att = torch.exp(-torch.clamp(a[i] * tau_in, max=80.0))
            absorb = att * -torch.expm1(-torch.clamp(a[i] * dtau, max=80.0))
            phi_in = phi_in + w[i] * att
            phi_cell = phi_cell + w[i] * absorb
            if heat_acc is not None:
                heat_acc = heat_acc + hw[i] * absorb
            if lls_acc is not None:
                # tau_pre gets its own 80-clamp (see the JAX twin)
                att_pre = torch.exp(-torch.clamp(a[i] * tau_pre, max=80.0))
                lls_acc = lls_acc + (w[i] * att_pre) * -torch.expm1(
                    -torch.clamp(a[i] * dtau_pre, max=80.0))
        phi_in = nf * phi_in
        phi_cell = nf * phi_cell
        phi_out = phi_in - phi_cell
        photo_cell = phi_cell / vol_ph
        if cfg.isothermal:
            heat = torch.zeros_like(photo_cell)
        else:
            heat = nf * heat_acc / vol_ph
        lls_cell = nf * lls_acc / vol_ph if lls_acc is not None else None
        return photo_cell, phi_in, phi_out, heat, lls_cell

    pc, pi, po, he, lc = one_source(tables.exp_a, tables.exp_w,
                                    tables.heat_exp_w, nflux)
    if cfg.sed.use_xray_sed and nflux_xray is not None:
        pc2, pi2, po2, he2, lc2 = one_source(
            tables.xray_exp_a, tables.xray_exp_w,
            tables.xray_heat_exp_w, nflux_xray)
        pc, pi, po, he = pc + pc2, pi + pi2, po + po2, he + he2
        lc = lc + lc2 if lc is not None else None
    return PhotoRates(pc, pi, po, he), lc


def photoion_rates_expsum(cfg: RunConfig, tables: RadTables, coldens_in,
                          coldens_out, vol_ph, nflux,
                          nflux_xray=None) -> PhotoRates:
    """Gather-free rate evaluation via the exponential mixture."""
    rates, _ = _photoion_expsum_impl(cfg, tables, coldens_in, coldens_out,
                                     vol_ph, nflux, nflux_xray, None)
    return rates


def photoion_rates_lls_fused(cfg: RunConfig, tables: RadTables, coldens_in,
                             coldens_out, vol_ph, nflux, coldens_pre,
                             nflux_xray=None):
    """Cell rates plus the LLS-absorbed photon tally in one evaluation
    (expsum); table mode evaluates the two calls.  Returns
    (PhotoRates, lls_cell)."""
    if use_expsum(cfg, coldens_in.dtype):
        return _photoion_expsum_impl(cfg, tables, coldens_in, coldens_out,
                                     vol_ph, nflux, nflux_xray, coldens_pre)
    phi = photoion_rates(cfg, tables, coldens_in, coldens_out, vol_ph,
                         nflux, nflux_xray=nflux_xray)
    phi_lls = photoion_rates(cfg, tables, coldens_pre, coldens_in,
                             vol_ph, nflux, nflux_xray=nflux_xray)
    return phi, phi_lls.photo_cell


def photoion_rates(cfg: RunConfig, tables: RadTables, coldens_in,
                   coldens_out, vol_ph, nflux,
                   nflux_xray=None) -> PhotoRates:
    """Photon-conserving photoionization + heating rates of a cell
    (radiation_photoionrates.F90:71-417): the thick-table difference, or
    the optically-thin branch when |dtau| is below the limit.  In float32
    the thin threshold rises to 3e-3 and the thin rate is taken at the
    midpoint optical depth, as in the JAX package."""
    f32 = coldens_in.dtype == torch.float32
    if use_expsum(cfg, coldens_in.dtype):
        return photoion_rates_expsum(cfg, tables, coldens_in, coldens_out,
                                     vol_ph, nflux, nflux_xray)

    sigma = const.SIGMA_HI_AT_ION_FREQ
    tau_in = coldens_in * sigma
    tau_out = coldens_out * sigma
    dtau = tau_out - tau_in
    if f32:
        photo_limit = max(cfg.tau_photo_limit, 3e-3)
        heat_limit = max(cfg.tau_heat_limit, 3e-3)
        tau_thin = 0.5 * (tau_in + tau_out)
    else:
        photo_limit = cfg.tau_photo_limit
        heat_limit = cfg.tau_heat_limit
        tau_thin = tau_in

    def one_source(photo_thick, photo_thin, heat_thick, heat_thin, nf):
        phi_in = nf * table_lookup(photo_thick, tau_in, cfg)
        thick_out = nf * table_lookup(photo_thick, tau_out, cfg)
        phi_cell_thick = phi_in - thick_out
        phi_cell_thin = nf * dtau * table_lookup(photo_thin, tau_thin, cfg)
        use_thick = torch.abs(dtau) > photo_limit
        phi_cell = torch.where(use_thick, phi_cell_thick, phi_cell_thin)
        phi_out = phi_in - phi_cell
        photo_cell = phi_cell / vol_ph
        if cfg.isothermal:
            heat = torch.zeros_like(photo_cell)
        else:
            h_in = nf * table_lookup(heat_thick, tau_in, cfg)
            h_out = nf * table_lookup(heat_thick, tau_out, cfg)
            h_thick = (h_in - h_out) / vol_ph
            h_thin = nf * dtau * table_lookup(heat_thin, tau_thin,
                                              cfg) / vol_ph
            heat = torch.where(torch.abs(dtau) > heat_limit, h_thick, h_thin)
        return photo_cell, phi_in, phi_out, heat

    pc, pi, po, he = one_source(tables.photo_thick, tables.photo_thin,
                                tables.heat_thick, tables.heat_thin, nflux)
    if cfg.sed.use_xray_sed and nflux_xray is not None:
        pc2, pi2, po2, he2 = one_source(
            tables.xray_photo_thick, tables.xray_photo_thin,
            tables.xray_heat_thick, tables.xray_heat_thin, nflux_xray)
        pc, pi, po, he = pc + pc2, pi + pi2, po + po2, he + he2
    return PhotoRates(pc, pi, po, he)
