"""Compressed ionization-fraction storage and add_photon_losses in the
port, against the JAX package on the CPU.  Mirrors every case of
tests/test_compressed.py (the codec, the restart encode, the float64
re-encoding, the float32 neutral tail, the non-isothermal and windowed
many-source cases) and tests/test_round3.py's compressed audit, each
with the port's evolve3d against JAX's on the same inputs (niter equal,
decoded xh1 within 1e-9 relative in float64), and add_photon_losses
against JAX on the full cube and the adaptive path."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.ops.photonstats import grid_counts as jax_grid_counts
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables
from c2ray_tpu.ops.thermal import setup_cool as jax_setup_cool
from c2ray_tpu.solver import Evolve3D as JaxEvolve3D
from c2ray_tpu.state import compress_xh as jax_compress
from c2ray_tpu.state import initial_state as jax_initial_state
from c2ray_tpu.state import xh1_of as jax_xh1_of

import c2ray_tpu_torch as port
from c2ray_tpu_torch.convert import config_from_dict
from c2ray_tpu_torch.ops.photonstats import grid_counts
from c2ray_tpu_torch.ops.tables import build_rad_tables
from c2ray_tpu_torch.ops.thermal import setup_cool
from c2ray_tpu_torch.state import compress_xh, xh0_of, xh1_of

torch.set_num_threads(2)

NH = 1.98e-4
RTOL = 1e-9


def port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


class TestCodec:
    def test_codec_matches_jax(self):
        x1 = np.array([1e-10, 2e-4, 0.3, 0.5, 0.5000001, 0.8, 1.0 - 1e-10,
                       1.0, 0.0])
        for dt in (np.float32, np.float64):
            for x0 in (None, 1.0 - x1):
                a = compress_xh(torch.from_numpy(x1.astype(dt)),
                                None if x0 is None
                                else torch.from_numpy(x0.astype(dt)))
                b = jax_compress(jnp.asarray(x1.astype(dt)),
                                 None if x0 is None
                                 else jnp.asarray(x0.astype(dt)))
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                assert not np.signbit(a.numpy()[x1 == 1.0]).any()
                np.testing.assert_array_equal(xh1_of(a).numpy(),
                                              np.asarray(jax_xh1_of(b)))

    def test_roundtrip_preserves_both_tails_f32(self):
        x1 = np.array([1e-10, 2e-4, 0.5, 1.0 - 1e-10])
        xc = compress_xh(torch.from_numpy(x1),
                         torch.from_numpy(1.0 - x1)).float()
        assert float(xh0_of(xc)[3]) == pytest.approx(1e-10, rel=1e-6)
        assert float(xh1_of(xc)[0]) == pytest.approx(1e-10, rel=1e-6)
        assert 1.0 - np.float32(x1[3]) == 0.0

    def test_sign_convention_and_saturation(self):
        xc = compress_xh(torch.tensor([0.2, 0.8]))
        assert float(xc[0]) == pytest.approx(0.2)
        assert float(xc[1]) == pytest.approx(-0.2)
        xc = compress_xh(torch.tensor([1.0, 0.5, 2e-4]))
        assert float(xh1_of(xc)[0]) == 1.0 and float(xh0_of(xc)[0]) == 0.0
        xc2 = compress_xh(torch.tensor([1.0]), torch.tensor([0.0]))
        assert float(xh1_of(xc2)[0]) == 1.0

    def test_initial_state_compressed(self):
        jcfg = jax_config(mesh=4, dtype="float32", compressed_xfrac=True)
        st = port.initial_state(port_cfg(jcfg), device="cpu")
        np.testing.assert_array_equal(st.xh1.numpy(),
                                      np.asarray(jax_initial_state(jcfg).xh1))


def solvers(jcfg):
    cfg = port_cfg(jcfg)
    jcool = None if jcfg.isothermal else jax_setup_cool(jcfg)
    cool = None if jcfg.isothermal else setup_cool(cfg, device="cpu")
    return (JaxEvolve3D(jcfg, jax_tables(jcfg), cool=jcool),
            port.Evolve3D(cfg, build_rad_tables(cfg, device="cpu"),
                          device="cpu", cool=cool))


def run_pair(jcfg, src, nflux, dr, dt, steps=2):
    """`steps` timesteps of both packages' evolve3d on a uniform density.
    -> [(jax info, port info)], final (jax state, port state)"""
    js, ps = solvers(jcfg)
    n = jcfg.mesh[0]
    jst = jax_initial_state(jcfg)
    pst = port.initial_state(port_cfg(jcfg), device="cpu")
    jnd = jnp.full((n,) * 3, NH, jcfg.jnp_dtype)
    pnd = torch.full((n,) * 3, NH, dtype=getattr(torch, jcfg.dtype))
    infos = []
    for _ in range(steps):
        jst, ji = js.evolve3d(jst, jnd, dr, src, nflux, dt)
        pst, pi = ps.evolve3d(pst, pnd, dr, src, nflux, dt)
        infos.append((ji, pi))
    return infos, (jst, pst)


def decoded(state, cfg):
    x = np.asarray(state.xh1) if not isinstance(state.xh1, torch.Tensor) \
        else state.xh1.numpy()
    if cfg.compressed_xfrac:
        x = xh1_of(torch.from_numpy(np.array(x))).numpy()
    return x


def one_source(jcfg, dt_frac=0.05):
    n = jcfg.mesh[0]
    return (np.array([[n // 2] * 3], np.int32),
            np.array([1e57]) / jcfg.sed.s_star, 5.7e24 / 4,
            dt_frac / (const.BH00 * NH))


def assert_pair(infos, states, jcfg, rtol=RTOL):
    for ji, pi in infos:
        assert pi.niter == ji.niter
        assert pi.mean_xh1 == pytest.approx(ji.mean_xh1, rel=rtol)
    np.testing.assert_allclose(decoded(states[1], jcfg),
                               decoded(states[0], jcfg), rtol=rtol, atol=0)
    if not jcfg.isothermal:
        np.testing.assert_allclose(states[1].temper_current.numpy(),
                                   np.asarray(states[0].temper_current),
                                   rtol=rtol)


class TestCompressedSolver:
    def test_f64_compressed_matches_jax_and_dense(self):
        base = dict(mesh=16, dtype="float64", use_lls=False,
                    cosmological=False)
        jcfg = jax_config(**base, compressed_xfrac=True)
        infos, states = run_pair(jcfg, *one_source(jcfg))
        assert_pair(infos, states, jcfg)
        # and the port's dense run, to rounding (a pure re-encoding)
        _, dense = run_pair(jax_config(**base), *one_source(jcfg))
        np.testing.assert_allclose(decoded(states[1], jcfg),
                                   dense[1].xh1.numpy(), rtol=1e-10,
                                   atol=1e-14)

    def test_f32_compressed_recovers_neutral_tail(self):
        """The residual neutral fraction inside the ionized sphere: the
        port's compressed float32 run tracks the float64 truth as JAX's
        does, where dense float32 storage floors it.  In float32 the two
        packages' niter part (torch's and XLA's float32 arithmetic differ
        in the last places, dense storage too: 69 against 91 iterations in
        the second step), so the mean is held to 1e-4, as card against
        CPU is."""
        base = dict(mesh=16, use_lls=False, cosmological=False)
        c = 8
        src = one_source(jax_config(**base), 0.2)
        _, s64 = run_pair(jax_config(**base, dtype="float64"), *src)
        truth = 1.0 - s64[1].xh1.numpy()[c, c, c]
        jcfg = jax_config(**base, dtype="float32", compressed_xfrac=True)
        infos, states = run_pair(jcfg, *src)
        comp = float(xh0_of(states[1].xh1)[c, c, c])
        assert truth < 1e-4
        assert comp == pytest.approx(truth, rel=0.05)
        for ji, pi in infos:
            assert pi.mean_xh1 == pytest.approx(ji.mean_xh1, rel=1e-4)

    def test_compressed_mean_matches_dense_f32(self):
        base = dict(mesh=16, dtype="float32", use_lls=False,
                    cosmological=False)
        src = one_source(jax_config(**base))
        dense, _ = run_pair(jax_config(**base), *src)
        comp, _ = run_pair(jax_config(**base, compressed_xfrac=True), *src)
        assert comp[-1][1].mean_xh1 == pytest.approx(dense[-1][1].mean_xh1,
                                                     rel=1e-4)
        assert comp[-1][1].mean_xh1 == pytest.approx(comp[-1][0].mean_xh1,
                                                     rel=1e-4)

    def test_nonisothermal_compressed_matches_jax(self):
        """tests/test_compressed.py:133's case at a fifth of its timestep:
        the port's thermal integration is host-bound on the CPU (~1 s per
        iteration at dt_frac 0.05, ~0.05 s at 0.01)."""
        base = dict(mesh=12, dtype="float64", use_lls=False,
                    cosmological=False, isothermal=False,
                    initial_temperature=100.0)
        jcfg = jax_config(**base, compressed_xfrac=True)
        infos, states = run_pair(jcfg, *one_source(jcfg, 0.01))
        assert_pair(infos, states, jcfg)

    def test_windowed_multisource_compressed_matches_jax(self):
        base = dict(mesh=24, dtype="float64", use_lls=False,
                    cosmological=False, window_sweep=True,
                    adaptive_sweep=True, source_batch=4)
        rng = np.random.default_rng(5)
        src = np.asarray(rng.integers(0, 24, (6, 3)), np.int32)
        nflux = 10.0 ** rng.uniform(7.5, 8.5, 6)
        jcfg = jax_config(**base, compressed_xfrac=True)
        infos, states = run_pair(jcfg, src, nflux, 5.7e24 / 6,
                                 0.05 / (const.BH00 * NH), steps=1)
        assert_pair(infos, states, jcfg)
        assert infos[0][1].rungs is not None


class TestCompressedAudit:
    def test_f32_compressed_audit_keeps_neutral_tail(self):
        n, tail = 8, 3.7e-9
        jcfg = jax_config(mesh=n, dtype="float32", compressed_xfrac=True)
        cfg = port_cfg(jcfg)
        x1 = np.full((n,) * 3, 1.0 - tail)
        xc = compress_xh(torch.from_numpy(x1),
                         torch.full((n,) * 3, tail,
                                    dtype=torch.float64)).float()
        nd = torch.full((n,) * 3, 2e-4, dtype=torch.float32)
        got = grid_counts(cfg, nd, xc, compressed=True)
        ref = jax_grid_counts(jcfg, jnp.asarray(nd.numpy()),
                              jnp.asarray(xc.numpy()), compressed=True)
        for a, b in zip(got, ref):
            assert float(a) == pytest.approx(float(b), rel=1e-6)
        assert float(got.h0) == pytest.approx(2e-4 * tail * n ** 3, rel=1e-5)
        # dense float32: 1 - tail rounds to 1.0f, the neutral side vanishes
        dense = torch.from_numpy(x1.astype(np.float32))
        assert float(grid_counts(cfg, nd, dense).h0) == 0.0


@pytest.mark.parametrize("adaptive", [False, True])
def test_add_photon_losses_matches_jax(adaptive):
    """The boundary losses fed back as a per-cell rate (the reference's
    dormant add_photon_losses block): sources near the box face leak, so
    the rate is on; niter, mean xh1 and xh1 as JAX's, float64."""
    n = 16
    base = dict(mesh=n, dtype="float64", use_lls=False, cosmological=False,
                add_photon_losses=True)
    if adaptive:
        base.update(adaptive_sweep=True, source_batch=4)
    jcfg = jax_config(**base)
    rng = np.random.default_rng(9)
    s = 6 if adaptive else 2
    src = np.asarray(rng.integers(0, n, (s, 3)), np.int32)
    nflux = 10.0 ** rng.uniform(8.5, 9.0, s)
    infos, states = run_pair(jcfg, src, nflux, 5.7e24 / 4,
                             0.5 / (const.BH00 * NH))
    assert any(pi.photon_loss > 0.0 for _, pi in infos)
    assert_pair(infos, states, jcfg)
    # the losses change the answer: the same run without them differs
    _, plain = run_pair(jcfg.replace(add_photon_losses=False), src, nflux,
                        5.7e24 / 4, 0.5 / (const.BH00 * NH))
    assert not np.allclose(plain[1].xh1.numpy(), states[1].xh1.numpy(),
                           rtol=1e-9, atol=0)
