"""The PyTorch port's non-isothermal Evolve3D.evolve3d on the CPU: the
frozen golden_thermal_32, the JAX package's Evolve3D on the same inputs
(made with numpy from a seed) on the full-cube path and on the adaptive
windowed path, and the photo-heating behaviour."""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.models.sources import SourceModel, read_source_file
from c2ray_tpu.ops.photonstats import PhotonStatistics as JaxStats
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables
from c2ray_tpu.ops.thermal import setup_cool as jax_setup_cool
from c2ray_tpu.solver import Evolve3D as JaxEvolve3D
from c2ray_tpu.state import initial_state as jax_initial_state

import c2ray_tpu_torch as port
from c2ray_tpu_torch.convert import (config_from_dict, cooling_from_numpy,
                                     tables_from_numpy)
from c2ray_tpu_torch.models.lls import set_lls
from c2ray_tpu_torch.ops.photonstats import PhotonStatistics
from c2ray_tpu_torch.ops.tables import build_rad_tables
from c2ray_tpu_torch.ops.thermal import setup_cool

torch.set_num_threads(2)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _solvers(**kw):
    """The JAX and the port's non-isothermal Evolve3D on identical
    configuration, rate tables and cooling table."""
    jcfg = jax_config(isothermal=False, **kw)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    jtabs = jax_tables(jcfg)
    ptabs = tables_from_numpy({k: np.asarray(v) for k, v in
                               jtabs._asdict().items()}, "cpu")
    jcool = jax_setup_cool(jcfg)
    pcool = cooling_from_numpy({"cie_cool": np.asarray(jcool.cie_cool),
                                "mintemp": jcool.mintemp,
                                "dtemp": jcool.dtemp}, "cpu")
    return (JaxEvolve3D(jcfg, jtabs, cool=jcool),
            port.Evolve3D(cfg, ptabs, device="cpu", cool=pcool))


def test_golden_thermal_32():
    """tests/test_golden.py's TestThermalGolden through the port: 32^3,
    f64, table rates, two steps, LLS type 1 (lls_model 5, set_lls), 100 K
    start.  niter exact in both steps; xh1 and the temperature at rtol
    1e-9."""
    g = np.load(os.path.join(FIXDIR, "golden_thermal_32.npz"))
    jcfg = jax_config(mesh=32, dtype="float64", use_lls=True,
                      cosmological=False, rate_eval="table",
                      sweep_backend="facemajor", isothermal=False,
                      type_of_lls=1, lls_model=5, initial_temperature=100.0)
    rows = read_source_file(os.path.join(FIXDIR, "test_sources_onesrc_32.dat"))
    cat = SourceModel.from_recipe(jcfg, 7).load(
        rows, np.asarray(jax_initial_state(jcfg).xh1), 0, jcfg.lifetime)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    solver = port.Evolve3D(cfg, build_rad_tables(cfg, device="cpu"),
                           device="cpu", cool=setup_cool(cfg, device="cpu"))
    state = port.initial_state(cfg, device="cpu")
    ndens = torch.full((32,) * 3, 1.98e-4, dtype=torch.float64)
    zred = 9.0
    dr = cfg.dr_comoving / (1.0 + zred)
    lls = set_lls(cfg, zred, dr)
    for want in g["niters"]:
        state, info = solver.evolve3d(state, ndens, dr, cat.srcpos,
                                      cat.normflux_stellar, 1e7 * const.YEAR,
                                      lls_coldens=lls.coldensh_lls)
        assert info.niter == int(want)
        assert info.converged
    np.testing.assert_allclose(state.xh1.numpy(), g["xh1"], rtol=1e-9,
                               atol=0)
    np.testing.assert_allclose(state.temper_current.numpy(), g["temper"],
                               rtol=1e-9, atol=0)


# --- full cube: the port against the JAX Evolve3D, 32^3 x 3 sources ------

N = 32
DT = 3.0e13
DR = 4.4e23


def _check_step(ji, pi, jstate, pstate, flux_sum):
    assert pi.niter == ji.niter
    assert pi.converged == ji.converged
    assert pi.conv_flag == ji.conv_flag
    assert pi.mean_xh1 == pytest.approx(ji.mean_xh1, rel=1e-9)
    np.testing.assert_allclose(pi.per_source_loss, ji.per_source_loss,
                               rtol=1e-9, atol=1e-12 * flux_sum)
    for name in ("phih", "phiheat"):
        np.testing.assert_allclose(getattr(pi, name).numpy(),
                                   np.asarray(getattr(ji, name)),
                                   rtol=1e-9, atol=0, err_msg=name)
    np.testing.assert_allclose(pstate.xh1.numpy(), np.asarray(jstate.xh1),
                               rtol=1e-9, atol=0)
    for name in ("temper_current", "temper_av", "temper_intermed"):
        np.testing.assert_allclose(getattr(pstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=1e-9, atol=0, err_msg=name)


def test_evolve3d_non_isothermal_matches_jax_f64_expsum():
    """Two timesteps on the full-cube path (f64 expsum rates, LLS type 1,
    an adiabatic cooling term, photon statistics): niter, conv_flag and
    the losses as the isothermal test holds them; xh1, phih, phiheat and
    the three temperature fields at rtol 1e-9."""
    jsolver, psolver = _solvers(mesh=N, dtype="float64", use_lls=True,
                                type_of_lls=1, cosmological=False,
                                rate_eval="expsum", source_batch=2)
    rng = np.random.default_rng(21)
    ndens = rng.uniform(1.5e-4, 2.5e-4, (N,) * 3)
    srcpos = rng.integers(0, N, (3, 3)).astype(np.int32)
    srcpos[0] = [0, N - 1, 5]                 # a periodic corner
    nflux = 10.0 ** rng.uniform(5.5, 6.5, 3)
    jstate = jax_initial_state(jsolver.cfg)
    pstate = port.initial_state(psolver.cfg, device="cpu")
    jstats, pstats = JaxStats(jsolver.cfg), PhotonStatistics(psolver.cfg)
    for _ in range(2):
        jstate, ji = jsolver.evolve3d(
            jstate, jnp.asarray(ndens), DR, srcpos, nflux, DT,
            lls_coldens=1e17, cosmo_cool_coeff=1e-17, stats=jstats)
        pstate, pi = psolver.evolve3d(
            pstate, torch.from_numpy(ndens), DR, srcpos, nflux, DT,
            lls_coldens=1e17, cosmo_cool_coeff=1e-17, stats=pstats)
        _check_step(ji, pi, jstate, pstate, nflux.sum())
        assert pi.photon_stats["photon_cons"] == pytest.approx(
            ji.photon_stats["photon_cons"], rel=1e-9)
    t = pstate.temper_current.numpy()
    assert float(pi.phiheat.max()) > 0.0
    assert t.max() > psolver.cfg.initial_temperature


# --- adaptive: the port against the JAX Evolve3D, 32^3 x 40 sources ------

@functools.lru_cache(maxsize=None)
def _adaptive_runs(steps=2):
    jsolver, psolver = _solvers(mesh=N, dtype="float64", use_lls=False,
                                cosmological=False, rate_eval="expsum",
                                source_batch=8)
    rng = np.random.default_rng(3)
    srcpos = rng.integers(0, N, (40, 3)).astype(np.int32)
    nflux = 10.0 ** rng.uniform(4, 7, 40)
    nflux[:3] = [3e8, 1e8, 3e7]
    ndens = np.full((N,) * 3, 1.98e-4)
    jrungs = []
    promote = jsolver._promote

    def record(per_src, nf, assign):
        jrungs[-1].append(np.bincount(assign, minlength=2).tolist())
        return promote(per_src, nf, assign)

    jsolver._promote = record
    jstate = jax_initial_state(jsolver.cfg)
    pstate = port.initial_state(psolver.cfg, device="cpu")
    out = []
    for _ in range(steps):
        jrungs.append([])
        jstate, ji = jsolver.evolve3d(jstate, jnp.asarray(ndens), 3e22,
                                      srcpos, nflux, DT)
        pstate, pi = psolver.evolve3d(pstate, torch.from_numpy(ndens), 3e22,
                                      srcpos, nflux, DT)
        out.append((ji, jstate, jrungs[-1], pi, pstate, nflux.sum()))
    return out


def test_adaptive_non_isothermal_matches_jax_f64():
    """The adaptive path, windowed rungs (heat through a second
    scatter-add) and the full-cube rung, with promotions in the first
    step: the same niter and rung history as JAX, xh1, phih, phiheat and
    the temperatures at rtol 1e-9."""
    runs = _adaptive_runs()
    first_rungs = runs[0][2]
    assert first_rungs[0][0] > 0 and first_rungs[-1][1] > first_rungs[0][1]
    for ji, jstate, jrungs, pi, pstate, flux_sum in runs:
        assert pi.rungs == jrungs
        _check_step(ji, pi, jstate, pstate, flux_sum)


def test_heating_raises_temperature():
    """The behaviour of tests/test_solver.py's heating test through the
    port: photo-heating raises T inside the HII region and leaves the
    neutral gas at its initial 100 K."""
    n = 16
    cfg = port.test_problem_config(mesh=n, dtype="float64", use_lls=False,
                                   cosmological=False, isothermal=False,
                                   initial_temperature=100.0)
    solver = port.Evolve3D(cfg, build_rad_tables(cfg, device="cpu"),
                           device="cpu", cool=setup_cool(cfg, device="cpu"))
    state = port.initial_state(cfg, device="cpu")
    ndens = torch.full((n,) * 3, 1.98e-4, dtype=torch.float64)
    for _ in range(2):
        state, info = solver.evolve3d(state, ndens, 2.9e24,
                                      np.array([[8, 8, 8]]), np.array([1e9]),
                                      3.1e14)
    t = state.temper_current.numpy()
    assert state.xh1.numpy()[8, 8, 8] > 0.9
    assert t[8, 8, 8] > 3000.0
    assert t[0, 0, 0] == pytest.approx(100.0, rel=1e-3)
    assert np.all(t >= 100.0 - 1e-6)


def test_non_isothermal_needs_a_cooling_table():
    cfg = port.test_problem_config(mesh=8, dtype="float64", isothermal=False)
    with pytest.raises(ValueError):
        port.Evolve3D(cfg, build_rad_tables(cfg, device="cpu"), device="cpu")
