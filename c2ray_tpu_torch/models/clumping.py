"""Sub-grid clumping models (PyTorch port of c2ray_tpu/models/clumping.py).

clumping_module.F90's five models, selected by cfg.type_of_clumping:
  1: constant factor
  2: globally averaged C(z) = C0 exp(c1 z + c2 z^2) + 1      (GCM)
  3: deterministic per-cell quadratic in overdensity          (DCM, Mao+2019)
  4: stochastic lognormal per-cell                            (SCM, Bianco+2020)
  5: precomputed clumping grids read per redshift

Parameter tables are small (redshift x coefficients); redshift
interpolation uses linear weights between the two nearest tabulated
redshifts (weight_function, clumping_module.F90:249-307).  Models 3-5
produce grids consumed directly by the chemistry.  The host evaluation
(ClumpingModel.evaluate, numpy) is a copy of the JAX twin's; the driver
evaluates types 3 and 4 on the grid's device with evaluate_device, whose
type-4 draw is JAX's jax.random.normal rebuilt bit for bit: the
threefry2x32 counter-based generator in its partitionable layout
(jax_threefry_partitionable, the default of JAX 0.9), its bits -> uniform
map and sqrt(2) erf_inv (replacing the Fortran Box-Muller loop,
clumping_module.F90:309-323), so both packages draw the same clumping
cube from the same (seed, redshift).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from ..config import RunConfig


@dataclass
class ClumpingModel:
    """Holds the loaded parameter tables (load_clumping_model,
    clumping_module.F90:33-59)."""

    cfg: RunConfig
    params_gcm: Optional[np.ndarray] = None  # (6,): C0 c1 c2 + errors
    params_dcm: Optional[np.ndarray] = None  # (nz, 7): z a0 a1 a2 + errors
    params_scm: Optional[np.ndarray] = None  # (nz, nbins, 5): mu sig lo hi mid
    seed: int = 0

    # ------------------------------------------------------------------
    def _z_weights(self, zred: float):
        """Linear interpolation weights between tabulated redshifts
        (weight_function, clumping_module.F90:249-307)."""
        zt = self.params_dcm[:, 0]
        # tables are stored with decreasing z in the reference files;
        # normalize to increasing for searching
        order = np.argsort(zt)
        zi = zt[order]
        z = np.clip(zred, zi[0], zi[-1])
        j = int(np.searchsorted(zi, z, side="right") - 1)
        j = min(j, len(zi) - 2)
        w2 = (z - zi[j]) / (zi[j + 1] - zi[j])
        return order[j], order[j + 1], 1.0 - w2, w2

    def _dcm_coeffs(self, zred: float) -> np.ndarray:
        i0, i1, w1, w2 = self._z_weights(zred)
        return self.params_dcm[i0, 1:4] * w1 + self.params_dcm[i1, 1:4] * w2

    # ------------------------------------------------------------------
    def evaluate(self, zred: float, ndens: Optional[np.ndarray] = None,
                 avg_dens: Optional[float] = None,
                 grid_file_reader=None) -> Union[float, np.ndarray]:
        """set_clumping: return a scalar (types 1,2) or a grid (3,4,5).

        Reference: clumping_module.F90:63-102.
        """
        cfg = self.cfg
        t = cfg.type_of_clumping
        if t == 1:
            return float(cfg.clumping_factor)
        if t == 2:
            p = self.params_gcm
            return float(p[0] * np.exp(p[1] * zred + p[2] * zred**2) + 1.0)
        if t == 3:
            a0, a1, a2 = self._dcm_coeffs(zred)
            delta = np.asarray(ndens, np.float64) / avg_dens
            return (a0 * delta * delta + a1 * delta + a2).astype(cfg.np_dtype)
        if t == 4:
            return self._stochastic(zred, ndens, avg_dens)
        if t == 5:
            if grid_file_reader is None:
                raise ValueError("type_of_clumping=5 requires a grid reader")
            return grid_file_reader(zred)
        raise ValueError(f"unknown clumping type {t}")

    def _stochastic(self, zred, ndens, avg_dens) -> np.ndarray:
        """SCM: lognormal draw per cell, mu/sigma interpolated over the
        density bins; out-of-range densities fall back to the DCM mean
        with the edge bin's sigma (clumping_module.F90:369-438)."""
        i0, i1, w1, w2 = self._z_weights(zred)
        p = self.params_scm[i0] * w1 + self.params_scm[i1] * w2  # (nbins, 5)
        mids = p[:, 4]
        order = np.argsort(mids)
        mids_s, mu_s, sig_s = mids[order], p[order, 0], p[order, 1]
        delta = (np.asarray(ndens, np.float64) / avg_dens).ravel()
        mu = np.interp(delta, mids_s, mu_s)
        sig = np.interp(delta, mids_s, sig_s)
        # out-of-range: DCM-based mean (log), edge sigma
        a0, a1, a2 = self._dcm_coeffs(zred)
        low, high = delta < mids_s[0], delta > mids_s[-1]
        out = low | high
        if np.any(out):
            dcm = np.log(np.maximum(a0 * delta[out] ** 2 + a1 * delta[out] + a2,
                                    1e-30))
            mu[out] = dcm
            sig[out] = np.where(low[out], sig_s[0], sig_s[-1])
        rng = np.random.default_rng(self.seed + int(zred * 1000))
        draw = np.exp(rng.normal(mu, np.maximum(sig, 0.0)))
        return draw.reshape(np.shape(ndens)).astype(self.cfg.np_dtype)


def load_clumping_model(cfg: RunConfig, resolution_mpc: Optional[float] = None,
                        params_dir: Optional[str] = None,
                        seed: int = 0) -> ClumpingModel:
    """Load parameter files paramsGCM/DCM/SCM_<res>Mpc.dat
    (clumping_module.F90:122-223).  Files are Fortran unformatted."""
    model = ClumpingModel(cfg=cfg, seed=seed)
    t = cfg.type_of_clumping
    if t in (1, 5) or params_dir is None:
        return model
    from ..utils.io_fortran import read_unformatted_records
    res = f"{resolution_mpc:5.3f}"
    if t == 2:
        recs = read_unformatted_records(f"{params_dir}/paramsGCM_{res}Mpc.dat")
        model.params_gcm = np.frombuffer(recs[0], np.float64)
    if t in (3, 4):
        recs = read_unformatted_records(f"{params_dir}/paramsDCM_{res}Mpc.dat")
        q1, q2 = np.frombuffer(recs[0], np.int32)[:2]
        model.params_dcm = np.frombuffer(recs[1], np.float64).reshape(
            (q2, q1)).T  # Fortran column-major (q1, q2)
    if t == 4:
        recs = read_unformatted_records(f"{params_dir}/paramsSCM_{res}Mpc.dat")
        l1, l2, l3 = np.frombuffer(recs[0], np.int32)[:3]
        model.params_scm = np.frombuffer(recs[1], np.float64).reshape(
            (l3, l2, l1)).T  # Fortran order -> (l1, l2, l3)
    return model


# ---------------------------------------------------------------------------
# JAX's default PRNG on the device: threefry2x32 (jax/_src/prng.py), its
# 32-bit words held in int64 tensors and masked after every addition
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash (20 rounds, JAX's _threefry2x32_lowering) of
    the count words (x1, x2), int64 tensors holding uint32 values, under
    the key (k1, k2).  -> (y1, y2) the same way."""
    ks = (k1 & _M32, k2 & _M32, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = x[0] ^ _rotl32(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def _key_words(seed: int):
    """jax.random.key(seed)'s raw key (threefry_seed): the seed's high
    and low 32 bits."""
    return (seed >> 32) & _M32, seed & _M32


def random_bits(seed: int, shape, bit_width: int, device, offset: int = 0):
    """jax.random.bits of jax.random.key(seed) at this shape with the
    partitionable layout (_threefry_random_bits_partitionable): the
    element at flat C-order index i hashes the 64-bit count i split into
    (high, low) words.  32 bits: y1 ^ y2 (int64 tensor); 64 bits: the
    pair (y1, y2), the high and low words.  offset: the flat index of
    the first element, for a block (a slab's rows) of a larger draw."""
    import torch
    k1, k2 = _key_words(seed)
    n = int(np.prod(shape))
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    if bit_width == 32:
        return (y1 ^ y2).reshape(shape)
    return y1.reshape(shape), y2.reshape(shape)


def uniform(seed: int, shape, dtype, minval: float, maxval: float, device,
            offset: int = 0):
    """jax.random.uniform(key(seed), shape, dtype, minval, maxval)
    (random._uniform): the mantissa bits under the exponent of 1.0, less
    1, scaled to the range in the working dtype and held above minval."""
    import torch
    if dtype == torch.float32:
        bits = random_bits(seed, shape, 32, device, offset)
        fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
        floats = fbits.view(torch.float32) - 1.0
    else:
        y1, y2 = random_bits(seed, shape, 64, device, offset)
        # the top 52 of the 64 bits (y1 << 32 | y2) >> 12
        fbits = (y1 << 20) | (y2 >> 12) | 0x3FF0000000000000
        floats = fbits.view(torch.float64) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=device)
    hi = torch.tensor(maxval, dtype=dtype, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's erf_inv, as JAX lowers lax.erf_inv (Giles' approximations in
# w = -log1p(-x^2)): float32 has one polynomial in w - 2.5 below w = 5
# and one in sqrt(w) - 3 above; float64 has three, in w - 3.125 below
# w = 6.25, sqrt(w) - 3.25 below 16 and sqrt(w) - 5 above
_ERFINV32 = (
    (5.0, 2.5, False, (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                       -4.39150654e-06, 0.00021858087, -0.00125372503,
                       -0.00417768164, 0.246640727, 1.50140941)),
    (np.inf, 3.0, True, (-0.000200214257, 0.000100950558, 0.00134934322,
                         -0.00367342844, 0.00573950773, -0.0076224613,
                         0.00943887047, 1.00167406, 2.83297682)))
_ERFINV64 = (
    (6.25, 3.125, False, (
        -3.6444120640178196996e-21, -1.685059138182016589e-19,
        1.2858480715256400167e-18, 1.115787767802518096e-17,
        -1.333171662854620906e-16, 2.0972767875968561637e-17,
        6.6376381343583238325e-15, -4.0545662729752068639e-14,
        -8.1519341976054721522e-14, 2.6335093153082322977e-12,
        -1.2975133253453532498e-11, -5.4154120542946279317e-11,
        1.051212273321532285e-09, -4.1126339803469836976e-09,
        -2.9070369957882005086e-08, 4.2347877827932403518e-07,
        -1.3654692000834678645e-06, -1.3882523362786468719e-05,
        0.0001867342080340571352, -0.00074070253416626697512,
        -0.0060336708714301490533, 0.24015818242558961693,
        1.6536545626831027356)),
    (16.0, 3.25, True, (
        2.2137376921775787049e-09, 9.0756561938885390979e-08,
        -2.7517406297064545428e-07, 1.8239629214389227755e-08,
        1.5027403968909827627e-06, -4.013867526981545969e-06,
        2.9234449089955446044e-06, 1.2475304481671778723e-05,
        -4.7318229009055733981e-05, 6.8284851459573175448e-05,
        2.4031110387097893999e-05, -0.0003550375203628474796,
        0.00095328937973738049703, -0.0016882755560235047313,
        0.0024914420961078508066, -0.0037512085075692412107,
        0.005370914553590063617, 1.0052589676941592334,
        3.0838856104922207635)),
    (np.inf, 5.0, True, (
        -2.7109920616438573243e-11, -2.5556418169965252055e-10,
        1.5076572693500548083e-09, -3.7894654401267369937e-09,
        7.6157012080783393804e-09, -1.4960026627149240478e-08,
        2.9147953450901080826e-08, -6.7711997758452339498e-08,
        2.2900482228026654717e-07, -9.9298272942317002539e-07,
        4.5260625972231537039e-06, -1.9681778105531670567e-05,
        7.5995277030017761139e-05, -0.00021503011930044477347,
        -0.00013871931833623122026, 1.0103004648645343977,
        4.8499064014085844221)))


def erfinv_xla(x):
    """erf_inv of a float32 or float64 tensor with XLA's arithmetic.
    torch.erfinv differs from XLA's by up to ~80 ulp (float32) and ~660
    ulp (float64) in the tails; this form agrees to a few ulp in float32
    and ~20 in float64, which is where libm's log1p and XLA's differ."""
    import torch
    f32 = x.dtype == torch.float32
    w = -torch.log1p(-x * x)
    out = None
    for limit, shift, root, coefs in reversed(_ERFINV32 if f32
                                              else _ERFINV64):
        ww = (torch.sqrt(w) if root else w) - shift
        p = torch.full_like(x, coefs[0])
        for c in coefs[1:]:
            p = c + p * ww
        out = p if out is None else torch.where(w < limit, p, out)
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), out * x)


def normal(seed: int, shape, dtype, device, offset: int = 0):
    """jax.random.normal(key(seed), shape, dtype) (random._normal_real):
    sqrt(2) erf_inv(u), u uniform on (nextafter(-1, 0), 1).  The uniform
    variates are JAX's bit for bit, erf_inv is XLA's polynomial
    (erfinv_xla)."""
    import torch
    npd = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(npd(-1.0), npd(0.0)))
    u = uniform(seed, shape, dtype, lo, 1.0, device, offset)
    return erfinv_xla(u) * float(npd(np.sqrt(2)))


def interp(x, xp, fp):
    """jnp.interp(x, xp, fp) on tensors, its arithmetic and its constant
    ends (fp[0] below xp[0], fp[-1] above xp[-1]); xp increasing."""
    import torch
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(
        np.float32 if xp.dtype == torch.float32 else np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def evaluate_device(model: ClumpingModel, zred: float, ndens, avg_dens: float,
                    row0: int = 0):
    """Types 3 and 4 evaluated elementwise on the density tensor's device
    (the JAX twin's evaluate_device; clumping_module.F90:327-487).  The
    type-4 draw is threefry's, deterministic in (seed, zred): the same
    cube as the JAX package's for the same inputs.  ndens may be the
    rows [row0, row0+m) of the grid (a halo-layout slab): the draw's
    counters are the cells' global indices, so the slabs hold the bits
    of the whole cube's draw."""
    import torch

    cfg = model.cfg
    t = cfg.type_of_clumping
    dtype, dev = ndens.dtype, ndens.device
    delta = ndens / float(cfg.np_dtype(avg_dens))
    a0, a1, a2 = (float(v) for v in model._dcm_coeffs(zred))
    if t == 3:
        return a0 * delta * delta + a1 * delta + a2
    if t != 4:
        raise ValueError(f"evaluate_device handles types 3/4, got {t}")
    i0, i1, w1, w2 = model._z_weights(zred)
    p = model.params_scm[i0] * w1 + model.params_scm[i1] * w2
    order = np.argsort(p[:, 4])

    def col(k):
        return torch.as_tensor(p[order, k], device=dev).to(dtype)

    mids, mu_s, sig_s = col(4), col(0), col(1)
    mu = interp(delta, mids, mu_s)
    sig = interp(delta, mids, sig_s)
    dcm = torch.log(torch.clamp(a0 * delta * delta + a1 * delta + a2,
                                min=1e-30))
    low = delta < mids[0]
    high = delta > mids[-1]
    mu = torch.where(low | high, dcm, mu)
    sig = torch.where(low, sig_s[0], torch.where(high, sig_s[-1], sig))
    z = normal(model.seed + int(zred * 1000), tuple(ndens.shape), dtype, dev,
               offset=row0 * int(np.prod(ndens.shape[1:])))
    return torch.exp(mu + torch.clamp(sig, min=0.0) * z)
