"""The port's post-processing tools (c2ray_tpu_torch.tools) against the
JAX package's (c2ray_tpu/tools.py), every function on the same float64
inputs made with numpy from a seed: floats and arrays at rtol 1e-12, the
power spectrum within 1e-10 of its largest bin (an FFT in another
order), histograms exactly (NumPy's bin edges), files byte for byte."""

import os

import numpy as np
import pytest

from c2ray_tpu import tools as jt
from c2ray_tpu.config import WMAP3PLUS as JAX_WMAP3PLUS
from c2ray_tpu.utils.io_fortran import write_sm3d as jax_write_sm3d

from c2ray_tpu_torch import tools as pt
from c2ray_tpu_torch.config import WMAP3PLUS

CPU = "cpu"
RTOL = 1e-12


def _cube(seed, n=16, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, n, n))


def test_load_xfrac(tmp_path):
    x = _cube(0)
    jax_write_sm3d(os.path.join(tmp_path, "xfrac3D_8.500.bin"), x)
    got = pt.load_xfrac(str(tmp_path), 8.5, x.shape)
    np.testing.assert_array_equal(got, jt.load_xfrac(str(tmp_path), 8.5,
                                                     x.shape))
    np.testing.assert_array_equal(got, x)


def test_ionized_fractions():
    x, n = _cube(1), _cube(2, lo=1e-4, hi=3e-4)
    got = pt.ionized_fractions(x, n, device=CPU)
    want = jt.ionized_fractions(x, n)
    assert set(got) == set(want)
    for key in want:
        assert isinstance(got[key], float)
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)


def test_brightness_temperature_and_rms():
    x, n = _cube(3), _cube(4, lo=1e-4, hi=3e-4)
    got = pt.brightness_temperature_21cm(x, n, 9.0, WMAP3PLUS, device=CPU)
    want = jt.brightness_temperature_21cm(x, n, 9.0, JAX_WMAP3PLUS)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    for cube in (want, np.zeros((4, 4, 4))):
        np.testing.assert_allclose(pt.rms_fluctuation(cube, device=CPU),
                                   jt.rms_fluctuation(cube), rtol=RTOL)


@pytest.mark.parametrize("n,nbins", [(32, 32), (17, 12)])
def test_power_spectrum(n, nbins):
    cube = 1.0 + 0.1 * np.random.default_rng(5).standard_normal((n,) * 3)
    k, d2 = pt.power_spectrum(cube, 3.1e25, nbins, device=CPU)
    kw, d2w = jt.power_spectrum(cube, 3.1e25, nbins)
    np.testing.assert_array_equal(k, kw)
    assert d2.shape == d2w.shape and np.all(np.isfinite(d2))
    np.testing.assert_allclose(d2, d2w, rtol=0, atol=1e-10 * d2w.max())


def test_rate_pdf_and_cube_pdf():
    rng = np.random.default_rng(6)
    rates = 10.0 ** rng.uniform(-15, -9, 20000)
    rates[:50] = 0.0
    rates[50] = 1e-8                   # the right edge: the last bin
    rates[51] = 1e-18                  # the left edge
    for args in ((rates,), (rates, 40, (-14.0, -10.0))):
        got, want = pt.rate_pdf(*args, device=CPU), jt.rate_pdf(*args)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)
    cube = rng.normal(5.0, 1.0, (16, 16, 16))
    for kw in (dict(nbins=50), dict(nbins=7, value_range=(4.0, 6.0))):
        got, want = pt.cube_pdf(cube, device=CPU, **kw), jt.cube_pdf(cube,
                                                                    **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)
    flat = np.full((4, 4, 4), 2.0)     # one value: numpy's +-0.5 range
    for g, w in zip(pt.cube_pdf(flat, 4, device=CPU), jt.cube_pdf(flat, 4)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)


def test_thomson_tau_and_ksz():
    xs = [_cube(7), _cube(8)]
    ns = [_cube(9, lo=1e-4, hi=3e-4), _cube(10, lo=1e-4, hi=3e-4)]
    got = pt.thomson_tau(xs, ns, [9.0, 8.5], WMAP3PLUS, device=CPU)
    want = jt.thomson_tau(xs, ns, [9.0, 8.5], JAX_WMAP3PLUS)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    vel = _cube(11, lo=-1e7, hi=1e7)
    np.testing.assert_allclose(
        pt.ksz_map(xs[0], ns[0], vel, 3e24, device=CPU),
        jt.ksz_map(xs[0], ns[0], vel, 3e24), rtol=RTOL, atol=0)


def test_ksz_map_interpolated():
    rng = np.random.default_rng(12)
    a = [rng.uniform(size=(8, 8)) for _ in range(3)]
    b = [rng.uniform(size=(8, 8)) for _ in range(3)]
    tau = [rng.uniform(size=(8, 8)) for _ in range(3)]
    kw = dict(shifts=[(1, 2), (0, -3), (5, 5)],
              random_vel_sigma=[100.0, 50.0, 20.0], tau_maps=tau, seed=4)
    for opts in ({}, kw):
        got = pt.ksz_map_interpolated(a, b, [0.2, 0.5, 0.9], device=CPU,
                                      **opts)
        want = jt.ksz_map_interpolated(a, b, [0.2, 0.5, 0.9], **opts)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_files_byte_for_byte(tmp_path):
    m = np.random.default_rng(13).uniform(-1, 1, (6, 6))
    pt.write_ifrit_cube(m, str(tmp_path / "p.bin"), scale=1e6, device=CPU)
    jt.write_ifrit_cube(m, str(tmp_path / "j.bin"), scale=1e6)
    assert (tmp_path / "p.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    rng = np.random.default_rng(14)
    tot = [10.0 ** rng.uniform(50, 56, s) for s in (30, 45)]
    act = [t[:s] for t, s in zip(tot, (12, 20))]
    got = pt.source_luminosity_history([9.0, 8.5], tot, act,
                                       str(tmp_path / "p.dat"), device=CPU)
    want = jt.source_luminosity_history([9.0, 8.5], tot, act,
                                        str(tmp_path / "j.dat"))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert (tmp_path / "p.dat").read_bytes() == \
        (tmp_path / "j.dat").read_bytes()


def test_tools_import_nothing_of_jax():
    """The port's tools and native reader are its own copies."""
    import ast

    import c2ray_tpu_torch.native as native

    for mod in (pt, native):
        tree = ast.parse(open(mod.__file__).read())
        names = [a.name for node in ast.walk(tree)
                 if isinstance(node, ast.Import) for a in node.names]
        names += [node.module or "" for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom)]
        assert not any(x.split(".")[0] in ("jax", "c2ray_tpu")
                       for x in names), names
