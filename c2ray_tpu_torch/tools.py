"""Post-processing tools, the port of c2ray_tpu/tools.py (the python
equivalents of the reference's tools/ Fortran post-processors):

  - volume/mass-averaged ionized+neutral fractions    (fractions.f90)
  - 21-cm differential brightness temperature cubes,
    mean evolution, rms fluctuations and power spectra (21cm_fluct_vs_z.f90,
    make_PDF_21cm.f90)
  - photoionization-rate PDFs                         (make_PDF_photorates.f90)
  - Thomson optical depth along the light cone        (make_maps_tau.f90, tau.f)
  - kSZ-style integrated maps (given velocity cubes)  (make_maps_kSZ.f90)

Every function has the JAX twin's name and arguments plus `device`
(None: the card, config.resolve_device), computes in float64 torch on
that device (torch.fft.rfftn for the power spectrum) and returns what the
twin returns: floats and numpy arrays, files byte for byte.  Histograms
keep NumPy's bin edges (np.histogram, np.digitize): each value goes to
the bin i with edges[i] <= x < edges[i+1], the last bin closed on the
right (torch.histc computes its own bins).  load_xfrac only reads a
file.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import constants as const
from .config import CosmologyParams, resolve_device
from .models.nbody import fortran_f6_3
from .utils.io_fortran import read_sm3d, write_unformatted_records

SIGMA_T = 6.6524e-25          # Thomson cross-section [cm^2]
NU0_21CM = 1420.40575e6       # 21cm rest frequency [Hz] (21cm_fluct_vs_z.f90)
T_STAR = 0.0681               # 21cm T* [K]
A10 = 2.85e-15                # 21cm Einstein A [1/s]


def _f64(a, device) -> torch.Tensor:
    """An array (numpy or torch) as a float64 tensor on `device`."""
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=torch.float64, device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def load_xfrac(results_dir: str, zred: float, mesh) -> np.ndarray:
    """Read an xfrac3D_<z>.bin cube (ours or reference-produced)."""
    return read_sm3d(os.path.join(results_dir,
                                  f"xfrac3D_{fortran_f6_3(zred)}.bin"),
                     np.float64, expect_mesh=tuple(mesh))


def ionized_fractions(xh1, ndens, device=None) -> Dict[str, float]:
    """Volume- and mass-weighted mean ionized/neutral fractions
    (fractions.f90; also PhotonCounts2 columns, output.F90:567-578)."""
    dev = resolve_device(device)
    x, n = _f64(xh1, dev), _f64(ndens, dev)
    volfrac = float(x.mean())
    massfrac = float((n * x).sum() / n.sum())
    return {"vol_ionized": volfrac, "mass_ionized": massfrac,
            "vol_neutral": 1.0 - volfrac, "mass_neutral": 1.0 - massfrac}


def _hubble(cosmo: CosmologyParams, zred: float) -> float:
    return cosmo.H0 * np.sqrt(cosmo.omega0 * (1 + zred) ** 3
                              + cosmo.omega_l)


def brightness_temperature_21cm(xh1, ndens_proper, zred: float,
                                cosmo: CosmologyParams,
                                device=None) -> np.ndarray:
    """Differential 21-cm brightness temperature cube [mK] in the high
    T_spin limit: dTb = (3 c^3 A10 T* / (32 pi nu0^3)) * n_HI / ((1+z)
    H(z)), per cell (the formula 21cm_fluct_vs_z.f90 integrates);
    ndens_proper is the proper H+He number density, n_HI = abu_h * n *
    (1-x)."""
    dev = resolve_device(device)
    hz = _hubble(cosmo, zred)
    n_hi = const.ABU_H * _f64(ndens_proper, dev) * (1.0 - _f64(xh1, dev))
    coef = (3.0 * const.C_LIGHT**3 * A10 * T_STAR
            / (32.0 * np.pi * NU0_21CM**3))
    dtb_k = coef * n_hi / ((1.0 + zred) * hz)
    return _host(dtb_k * 1e3)  # mK


def rms_fluctuation(cube, device=None) -> Tuple[float, float]:
    """Mean and rms fractional fluctuation of a cube
    (21cm_fluct_vs_z.f90 'fluct')."""
    c = _f64(cube, resolve_device(device))
    mean = float(c.mean())
    if mean == 0.0:
        return 0.0, 0.0
    return mean, float(torch.sqrt(((c - mean) ** 2).mean()))


def power_spectrum(cube, boxsize_cm: float, nbins: int = 32,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Spherically averaged dimensionless power spectrum Delta^2(k) of the
    fractional fluctuation field.  Returns (k [1/cm], Delta^2).  The
    frequencies and bin edges are the twin's (numpy, on the host); a mode
    goes to bin i where edges[i-1] <= |k| < edges[i] (np.digitize)."""
    dev = resolve_device(device)
    c = _f64(cube, dev)
    n = c.shape[0]
    delta = c / c.mean() - 1.0
    fk = torch.fft.rfftn(delta)
    pk = torch.abs(fk) ** 2 * (boxsize_cm**3 / n**6)
    kf = 2 * np.pi / boxsize_cm
    kx = _f64(np.fft.fftfreq(n, 1.0 / n) * kf, dev)
    kz = _f64(np.fft.rfftfreq(n, 1.0 / n) * kf, dev)
    ax, ay, az = kx[:, None, None], kx[None, :, None], kz[None, None, :]
    kk = torch.sqrt(ax * ax + ay * ay + az * az)
    kmax = kf * n / 2
    bins = np.linspace(kf, kmax, nbins + 1)
    which = torch.bucketize(kk.reshape(-1), _f64(bins, dev), right=True)
    psum = torch.zeros(nbins + 2, dtype=torch.float64, device=dev)
    psum.index_add_(0, which, pk.reshape(-1))
    cnt = torch.bincount(which, minlength=nbins + 2)
    psum, cnt = _host(psum), _host(cnt)
    kcen = 0.5 * (bins[1:] + bins[:-1])
    with np.errstate(invalid="ignore", divide="ignore"):
        pofk = psum[1:nbins + 1] / np.maximum(cnt[1:nbins + 1], 1)
    return kcen, pofk * kcen**3 / (2 * np.pi**2)


def _histogram(x: torch.Tensor, nbins: int, value_range):
    """np.histogram(x, bins=nbins, range=value_range, density=True): the
    edges from np.linspace on the host, the counts on x's device."""
    if value_range is not None:
        lo, hi = (float(v) for v in value_range)
    elif x.numel() == 0:
        lo, hi = 0.0, 1.0
    else:
        lo, hi = float(x.min()), float(x.max())
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    edges = np.linspace(lo, hi, nbins + 1)
    x = x[(x >= lo) & (x <= hi)]
    idx = torch.bucketize(x, _f64(edges, x.device), right=True) - 1
    idx = idx.clamp(max=nbins - 1)          # x == hi: the last bin
    counts = _host(torch.bincount(idx, minlength=nbins)).astype(np.float64)
    return counts / np.diff(edges) / counts.sum(), edges


def rate_pdf(rates, nbins: int = 100,
             log_range: Tuple[float, float] = (-18.0, -8.0),
             device=None) -> Tuple[np.ndarray, np.ndarray]:
    """PDF of log10 photoionization rates (make_PDF_photorates.f90)."""
    r = _f64(rates, resolve_device(device)).reshape(-1)
    r = r[r > 0]
    hist, edges = _histogram(torch.log10(r), nbins, log_range)
    return 0.5 * (edges[1:] + edges[:-1]), hist


def thomson_tau(xh1_slices: Sequence, ndens_slices: Sequence,
                zreds: Sequence[float], cosmo: CosmologyParams,
                device=None) -> np.ndarray:
    """Integrated Thomson optical depth map through a stack of redshift
    slices (make_maps_tau.f90/tau.f): tau(x,y) = sum sigma_T n_e dl with
    dl = c dt per slice."""
    dev = resolve_device(device)
    tau = torch.zeros(tuple(xh1_slices[0].shape[:2]),
                      dtype=torch.float64, device=dev)
    for x, n, z in zip(xh1_slices, ndens_slices, zreds):
        hz = _hubble(cosmo, z)
        ne = _f64(n, dev) * _f64(x, dev)
        # path length of one slice along the LoS: c / ((1+z) H(z)) per unit z
        # approximated with the slice's comoving depth; sum over the z-axis
        dl = const.C_LIGHT / ((1.0 + z) * hz) * (1.0 / len(xh1_slices))
        tau += SIGMA_T * ne.sum(dim=2) * dl
    return _host(tau)


def ksz_map(xh1, ndens_proper, vel_z, dr_proper: float,
            device=None) -> np.ndarray:
    """Kinetic SZ-style integrated map: sum sigma_T n_e (v_z/c) dl along the
    z axis (make_maps_kSZ.f90), given a line-of-sight velocity cube."""
    dev = resolve_device(device)
    ne = _f64(ndens_proper, dev) * _f64(xh1, dev)
    return _host((SIGMA_T * ne * _f64(vel_z, dev) / const.C_LIGHT)
                 .sum(dim=2) * dr_proper)


def ksz_map_interpolated(maps_a: Sequence, maps_b: Sequence,
                         weights: Sequence[float],
                         shifts: Optional[Sequence[Tuple[int, int]]] = None,
                         random_vel_sigma: Optional[Sequence[float]] = None,
                         tau_maps: Optional[Sequence] = None,
                         seed: int = 0, device=None) -> np.ndarray:
    """Light-cone kSZ accumulation with per-slice interpolation
    (make_interp_maps_kSZ_w_random_vel2.f90): per light-cone step i,
    weight*map_a + (1-weight)*map_b (reference :79), optionally rolled by
    shifts[i] (cshift decorrelation, :116-117), plus a large-scale random
    bulk velocity, a zero-mean Gaussian of sigma random_vel_sigma[i]
    applied to the slice's tau map (tauadd*vrandom/c, :110-122).  The
    draws are the twin's: numpy's default_rng(seed), on the host."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    total = torch.zeros(tuple(maps_a[0].shape), dtype=torch.float64,
                        device=dev)

    def shifted(m, i):
        if shifts is None:
            return m
        sx, sy = shifts[i]
        return torch.roll(torch.roll(m, sx, dims=0), sy, dims=1)

    for i, (ma, mb, w) in enumerate(zip(maps_a, maps_b, weights)):
        add = shifted(w * _f64(ma, dev) + (1.0 - w) * _f64(mb, dev), i)
        if random_vel_sigma is not None and tau_maps is not None:
            vrand = rng.normal(0.0, random_vel_sigma[i]) * 1e5  # km/s -> cm/s
            add = add + shifted(_f64(tau_maps[i], dev), i) * vrand \
                / const.C_LIGHT
        total += add
    return _host(total)


def cube_pdf(cube, nbins: int = 100,
             value_range: Optional[Tuple[float, float]] = None,
             device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Linear-range PDF of a cube's values (make_PDF_21cm.f90), e.g. the
    21-cm dTb cube from brightness_temperature_21cm."""
    c = _f64(cube, resolve_device(device)).reshape(-1)
    hist, edges = _histogram(c, nbins, value_range)
    return 0.5 * (edges[1:] + edges[:-1]), hist


def write_ifrit_cube(map2d, path: str, scale: float = 1e6,
                     device=None) -> None:
    """Replicate a 2D map along the third axis and write it in IFRIT's
    unformatted format: one (m,m,m) header record + one f32 data record
    (ifrit_format.f90; the reference scales dT maps by 1e6 to muK)."""
    dev = resolve_device(device)
    m2 = torch.as_tensor(np.asarray(map2d, np.float32), device=dev) \
        * torch.tensor(np.float32(scale), device=dev)
    n = m2.shape[0]
    header = np.asarray([n, n, n], np.int32).tobytes()
    # reference writes (((a(i,j),i),j),k): the 2D map repeated n times
    data = m2.t().reshape(-1).repeat(n)     # Fortran order per plane
    write_unformatted_records(path, [header, _host(data).tobytes()])


def source_luminosity_history(zreds: Sequence[float],
                              flux_total: Sequence,
                              flux_active: Sequence,
                              results_file: Optional[str] = None,
                              device=None) -> np.ndarray:
    """Active vs total source counts and luminosities per redshift
    (sources_total_lum.f90:83-85): rows (z, N_total, N_active, S_total,
    S_active), optionally written in the reference's column layout.
    flux_total[i] / flux_active[i] are slice i's per-source photon rates
    before / after suppression."""
    dev = resolve_device(device)
    rows = []
    for z, ft, fa in zip(zreds, flux_total, flux_active):
        ft, fa = _f64(ft, dev), _f64(fa, dev)
        rows.append((float(z), ft.numel(), fa.numel(),
                     float(ft.sum()), float(fa.sum())))
    out = np.asarray(rows)
    if results_file:
        with open(results_file, "w") as f:
            for z, nt, na, st, sa in rows:
                f.write(f"{z:10.3f}  {int(nt):8d}{int(na):8d}  "
                        f"{st:12.3e}{sa:12.3e}\n")
    return out
