"""The port's clumping models against the JAX package's, on the CPU: the
host models 1-5 from the same synthetic parameter files (made from seeds
with numpy), and the device evaluation of types 3 and 4, whose type-4
draw rebuilds jax.random.normal: the threefry2x32 words bitwise equal to
JAX's for several seeds and redshifts (32- and 64-bit), the uniform
variates bitwise, the normals sqrt(2) erf_inv(u) (the test records the
largest difference from JAX's), and the clumping grid
within 1e-5 relative in float32 and 1e-10 in float64.  erf_inv is
XLA's polynomial, rebuilt in torch (the normals within a few ulp)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.models import clumping as jax_clumping
from c2ray_tpu.utils.io_fortran import (write_stream_cube,
                                        write_unformatted_records)

from c2ray_tpu_torch.convert import config_from_dict
from c2ray_tpu_torch.models import clumping

SEEDS = [0, 7, 123456]
ZREDS = [9.0, 8.884, 12.5]


def port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def write_params(tmp_path, cfg, seed=0):
    """paramsGCM/DCM/SCM files at the grid resolution, sigma > 0 (the
    shapes of tests/test_round5.py's inputs), from a seed."""
    rng = np.random.default_rng(seed)
    res = f"{cfg.dr_comoving / const.MPC:5.3f}"
    gcm = np.array([0.6, 0.02, 0.002, 0.0, 0.0, 0.0])
    write_unformatted_records(str(tmp_path / f"paramsGCM_{res}Mpc.dat"),
                              [gcm.tobytes()])
    dcm = np.zeros((3, 7))
    dcm[:, 0] = [12.0, 9.0, 6.0]                 # decreasing z, as on file
    dcm[:, 1:4] = rng.uniform([0.02, 0.05, 1.0], [0.08, 0.2, 1.5], (3, 3))
    write_unformatted_records(
        str(tmp_path / f"paramsDCM_{res}Mpc.dat"),
        [np.array(dcm.shape, np.int32).tobytes(), dcm.T.tobytes()])
    scm = np.zeros((3, 4, 5))
    mids = np.array([0.5, 1.0, 2.0, 4.0])
    for iz in range(3):
        scm[iz, :, 0] = np.log(rng.uniform(1.2, 2.0, 4))
        scm[iz, :, 1] = rng.uniform(0.1, 0.4, 4)
        scm[iz, :, 4] = mids
    write_unformatted_records(
        str(tmp_path / f"paramsSCM_{res}Mpc.dat"),
        [np.array(scm.shape, np.int32).tobytes(), scm.T.tobytes()])
    cube = 1.0 + rng.random(cfg.mesh)
    write_stream_cube(str(tmp_path / "clump.dat"), cube.astype(np.float32))
    return res


def models(tmp_path, t, dtype="float64", n=8):
    jcfg = jax_config(mesh=n, dtype=dtype, type_of_clumping=t,
                      clumping_factor=1.7)
    write_params(tmp_path, jcfg)
    res = jcfg.dr_comoving / const.MPC
    jm = jax_clumping.load_clumping_model(jcfg, res, str(tmp_path), seed=3)
    pm = clumping.load_clumping_model(port_cfg(jcfg), res, str(tmp_path),
                                      seed=3)
    return jcfg, jm, pm


def density(n, dtype, seed=5):
    """A lognormal density whose overdensities reach both sides of the
    SCM bins (0.5 .. 4), so both interpolation ends and the DCM fallback
    are taken."""
    rng = np.random.default_rng(seed)
    return (2e-4 * rng.lognormal(0.0, 0.9, (n,) * 3)).astype(dtype)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5])
def test_host_models_match_jax(tmp_path, t):
    jcfg, jm, pm = models(tmp_path, t)
    for name in ("params_gcm", "params_dcm", "params_scm"):
        a, b = getattr(pm, name), getattr(jm, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    nd = density(8, np.float64)
    avg = float(nd.mean())

    def reader(z):
        return np.full(jcfg.mesh, 1.25 + z / 100)
    for z in ZREDS:
        a = pm.evaluate(z, nd, avg, grid_file_reader=reader)
        b = jm.evaluate(z, nd, avg, grid_file_reader=reader)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("zred", ZREDS)
def test_threefry_words_bitwise(seed, zred):
    """The draw's key is seed + int(zred * 1000), as in evaluate_device."""
    k = seed + int(zred * 1000)
    shape = (5, 6, 7)
    key = jax.random.key(k)
    got32 = clumping.random_bits(k, shape, 32, "cpu").numpy()
    ref32 = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    np.testing.assert_array_equal(got32.astype(np.uint32), ref32)
    y1, y2 = clumping.random_bits(k, shape, 64, "cpu")
    ref64 = np.asarray(jax.random.bits(key, shape, jnp.uint64))
    np.testing.assert_array_equal(y1.numpy().astype(np.uint64),
                                  ref64 >> np.uint64(32))
    np.testing.assert_array_equal(y2.numpy().astype(np.uint64),
                                  ref64 & np.uint64(0xFFFFFFFF))
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.float64, jnp.float64)):
        lo = float(np.nextafter(np.dtype(jdt).type(-1.0),
                                np.dtype(jdt).type(0.0)))
        u = clumping.uniform(k, shape, tdt, lo, 1.0, "cpu").numpy()
        ref = np.asarray(jax.random.uniform(key, shape, jdt, lo, 1.0))
        np.testing.assert_array_equal(u, ref)


@pytest.mark.parametrize("zred", ZREDS)
def test_normals_against_jax(zred):
    """sqrt(2) erf_inv(u) on JAX's uniforms at 32^3, with erf_inv in XLA's
    polynomial form (models.clumping.erfinv_xla): the largest differences
    from jax.random.normal measured here were 3 ulp in float32 and 30 ulp
    (3.3e-15) in float64, all from libm's log1p against XLA's; the bounds
    are 4 and 40 ulp.  torch.erfinv itself differs by ~80 and ~660 ulp."""
    k = 7 + int(zred * 1000)
    shape = (32, 32, 32)
    for tdt, jdt, most in ((torch.float32, jnp.float32, 4),
                           (torch.float64, jnp.float64, 40)):
        z = clumping.normal(k, shape, tdt, "cpu").numpy()
        ref = np.asarray(jax.random.normal(jax.random.key(k), shape, jdt))
        ulps = float((np.abs(z - ref) / np.spacing(np.abs(ref))).max())
        print(f"normal {jdt.__name__}: largest |port - JAX| {ulps:.0f} ulp")
        assert ulps <= most


def test_interp_matches_jnp_interp():
    xp = torch.tensor([0.5, 1.0, 1.0, 2.0, 4.0], dtype=torch.float64)
    fp = torch.tensor([0.3, 0.1, 0.7, 0.2, 0.9], dtype=torch.float64)
    x = torch.tensor([0.1, 0.5, 0.75, 1.0, 1.5, 3.9, 4.0, 9.0],
                     dtype=torch.float64)
    np.testing.assert_array_equal(
        clumping.interp(x, xp, fp).numpy(),
        np.asarray(jnp.interp(jnp.asarray(x.numpy()), jnp.asarray(xp.numpy()),
                              jnp.asarray(fp.numpy()))))


@pytest.mark.parametrize("t", [3, 4])
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("float64", 1e-10)])
def test_device_grid_matches_jax(tmp_path, t, dtype, rtol):
    """evaluate_device on a torch density against the JAX twin's on the
    same density, at several redshifts (one between the tabulated ones)."""
    n = 16
    jcfg, jm, pm = models(tmp_path, t, dtype, n)
    nd = density(n, np.dtype(dtype))
    worst = 0.0
    for z in ZREDS:
        avg = float(nd.astype(np.float64).mean()) * 1.0003
        a = clumping.evaluate_device(pm, z, torch.from_numpy(nd), avg)
        b = np.asarray(jax_clumping.evaluate_device(jm, z, jnp.asarray(nd),
                                                    avg))
        assert a.dtype == getattr(torch, dtype)
        a = a.numpy()
        assert np.isfinite(a).all() and (a > 0).all()
        worst = max(worst, float(np.abs(a / b - 1.0).max()))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
    print(f"type {t} {dtype}: largest relative difference {worst:.3e}")
    if t == 4:
        # the draw is random: the grid is not the deterministic mean
        mean = clumping.evaluate_device(pm.__class__(
            cfg=pm.cfg, params_dcm=pm.params_dcm,
            params_scm=pm.params_scm * [1, 0, 1, 1, 1], seed=3), 9.0,
            torch.from_numpy(nd), avg).numpy()
        assert np.abs(a / mean - 1.0).max() > 0.05
