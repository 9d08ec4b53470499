"""The PyTorch port's Evolve3D.evolve3d with the LLS and X-ray options
against the JAX package's Evolve3D on the CPU, on inputs made with numpy
from a seed: a grid LLS cube (type 2) with X-ray sources on the full-cube
path, isothermal and non-isothermal, the R_max barrier (type 3), and the
adaptive path with a grid LLS cube and X-ray sources; and the port's twin
of tests/test_round2.py::test_xray_ionizes_end_to_end."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.config import SEDConfig as JaxSED
from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.ops.photonstats import PhotonStatistics as JaxStats
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables
from c2ray_tpu.ops.thermal import setup_cool as jax_setup_cool
from c2ray_tpu.solver import Evolve3D as JaxEvolve3D
from c2ray_tpu.state import initial_state as jax_initial_state

import c2ray_tpu_torch as port
from c2ray_tpu_torch.convert import (config_from_dict, cooling_from_numpy,
                                     tables_from_numpy)
from c2ray_tpu_torch.ops.photonstats import PhotonStatistics
from c2ray_tpu_torch.ops.tables import build_rad_tables

torch.set_num_threads(2)

N = 16
DT = 3.0e13
ZRED = 9.0


def _solvers(**kw):
    """The JAX and the port's Evolve3D on identical configuration, rate
    tables and (non-isothermal) cooling table; X-ray SED on."""
    jcfg = jax_config(mesh=N, dtype="float64", cosmological=False,
                      rate_eval="expsum", use_lls=True,
                      sed=JaxSED(use_xray_sed=True), **kw)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    jtabs = jax_tables(jcfg)
    ptabs = tables_from_numpy({k: np.asarray(v) for k, v in
                               jtabs._asdict().items()}, "cpu")
    if jcfg.isothermal:
        return (JaxEvolve3D(jcfg, jtabs),
                port.Evolve3D(cfg, ptabs, device="cpu"))
    jcool = jax_setup_cool(jcfg)
    pcool = cooling_from_numpy({"cie_cool": np.asarray(jcool.cie_cool),
                                "mintemp": jcool.mintemp,
                                "dtemp": jcool.dtemp}, "cpu")
    return (JaxEvolve3D(jcfg, jtabs, cool=jcool),
            port.Evolve3D(cfg, ptabs, device="cpu", cool=pcool))


def _lls_grid(cfg, dr):
    """Type 2's column cube from a lognormal cross-section cube, scaled
    so that the mean column is ~1e17 cm^-2 (through the port's set_lls)."""
    rng = np.random.default_rng(7)
    sigma = rng.lognormal(0.0, 0.5, (N,) * 3)
    raw = port.set_lls(cfg, ZRED, dr, sigma)
    return raw.grid * (1e17 / raw.coldensh_lls)


def _problem(num_src, lo, hi, seed=21):
    rng = np.random.default_rng(seed)
    ndens = rng.uniform(1.5e-4, 2.5e-4, (N,) * 3)
    srcpos = rng.integers(0, N, (num_src, 3)).astype(np.int32)
    srcpos[0] = [0, N - 1, 5]                 # a periodic corner
    nflux = 10.0 ** rng.uniform(lo, hi, num_src)
    nfx = 0.3 * nflux * rng.uniform(0.5, 2.0, num_src)
    nflux[-1] = 0.0                           # a pure X-ray source
    return ndens, srcpos, nflux, nfx


def _check_step(ji, pi, jstate, pstate, flux_sum, temperatures):
    assert pi.niter == ji.niter
    assert pi.converged == ji.converged
    assert pi.conv_flag == ji.conv_flag
    assert pi.mean_xh1 == pytest.approx(ji.mean_xh1, rel=1e-9)
    assert pi.lls_loss == pytest.approx(ji.lls_loss, rel=1e-9,
                                        abs=1e-12 * flux_sum)
    np.testing.assert_allclose(pi.per_source_loss, ji.per_source_loss,
                               rtol=1e-9, atol=1e-12 * flux_sum)
    np.testing.assert_allclose(pi.phih.numpy(), np.asarray(ji.phih),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(pstate.xh1.numpy(), np.asarray(jstate.xh1),
                               rtol=1e-9, atol=0)
    if temperatures:
        np.testing.assert_allclose(pi.phiheat.numpy(),
                                   np.asarray(ji.phiheat), rtol=1e-9, atol=0)
        for name in ("temper_current", "temper_av", "temper_intermed"):
            np.testing.assert_allclose(getattr(pstate, name).numpy(),
                                       np.asarray(getattr(jstate, name)),
                                       rtol=1e-9, atol=0, err_msg=name)


@functools.lru_cache(maxsize=None)
def _full_cube_runs(lls_type, isothermal):
    """Two timesteps of both solvers on the full-cube path with photon
    statistics: 3 sources (one pure X-ray), X-ray fluxes beside the
    stellar ones, a grid LLS cube (type 2) or the R_max barrier at 3 cells
    (type 3)."""
    dr = 4.4e23
    jsolver, psolver = _solvers(type_of_lls=lls_type, isothermal=isothermal,
                                source_batch=2)
    ndens, srcpos, nflux, nfx = _problem(3, 5.5, 6.5)
    if lls_type == 2:
        grid = _lls_grid(psolver.cfg, dr)
        jkw, pkw = dict(lls_grid=jnp.asarray(grid)), dict(
            lls_grid=torch.from_numpy(grid))
    else:
        jkw = pkw = dict(rmax_cells=3.0)
    jstate = jax_initial_state(jsolver.cfg)
    pstate = port.initial_state(psolver.cfg, device="cpu")
    jstats, pstats = JaxStats(jsolver.cfg), PhotonStatistics(psolver.cfg)
    out = []
    for _ in range(2):
        jstate, ji = jsolver.evolve3d(jstate, jnp.asarray(ndens), dr, srcpos,
                                      nflux, DT, nflux_xray=nfx,
                                      stats=jstats, **jkw)
        pstate, pi = psolver.evolve3d(pstate, torch.from_numpy(ndens), dr,
                                      srcpos, nflux, DT, nflux_xray=nfx,
                                      stats=pstats, **pkw)
        out.append((ji, pi, jstate, pstate))
    return out, nflux.sum() + nfx.sum()


@pytest.mark.parametrize("lls_type,isothermal", [
    pytest.param(2, True, id="grid-lls-xray"),
    pytest.param(2, False, id="grid-lls-xray-non-isothermal"),
    pytest.param(3, True, id="rmax-xray"),
])
def test_evolve3d_lls_xray_matches_jax_f64(lls_type, isothermal):
    """The full-cube path with a grid LLS cube and X-ray sources
    (isothermal and non-isothermal) and with the R_max barrier: niter,
    conv_flag, converged exact; mean xh1, the LLS loss, the per-source
    losses, phih and xh1 at rtol 1e-9 (phiheat and the temperatures too
    where non-isothermal), and photon conservation in both steps."""
    runs, flux = _full_cube_runs(lls_type, isothermal)
    for ji, pi, jstate, pstate in runs:
        _check_step(ji, pi, jstate, pstate, flux, not isothermal)
        assert pi.photon_stats["photon_cons"] == pytest.approx(
            ji.photon_stats["photon_cons"], rel=1e-9)
    last = runs[-1][1]
    assert 0.0 < last.mean_xh1 < 1.0
    if lls_type == 2:
        assert last.lls_loss > 0.0


def test_rmax_barrier_stops_ionization():
    """Type 3 on the port alone (cf. tests/test_solver.py::
    test_rmax_barrier): a thin grid, one source, R_max = 4 cells: ionized
    inside the barrier, untouched beyond it."""
    n = 24
    cfg = port.test_problem_config(mesh=n, dtype="float64",
                                   cosmological=False, use_lls=True,
                                   type_of_lls=3)
    solver = port.Evolve3D(cfg, build_rad_tables(cfg, device="cpu"),
                           device="cpu")
    state = port.initial_state(cfg, device="cpu")
    ndens = torch.full((n,) * 3, 2e-6, dtype=torch.float64)
    src = np.array([[12, 12, 12]], np.int32)
    state, _ = solver.evolve3d(state, ndens, 2.9e24, src,
                               np.array([1e57 / cfg.sed.s_star]), 3e15,
                               rmax_cells=4.0)
    x = state.xh1.numpy()
    assert x[12, 12, 12] > 0.9 and x[16, 12, 12] > 0.9
    assert x[18, 12, 12] == pytest.approx(cfg.initial_xh, rel=1e-2)


@functools.lru_cache(maxsize=None)
def _adaptive_runs():
    n = N
    jsolver, psolver = _solvers(type_of_lls=2, source_batch=2,
                                adaptive_sweep=True, adaptive_min_shell=2)
    rng = np.random.default_rng(21)
    ndens = rng.uniform(1.5e-4, 2.5e-4, (n,) * 3)
    srcpos = rng.integers(0, n, (5, 3)).astype(np.int32)
    srcpos[0] = [0, n - 1, 5]                 # a periodic corner
    nflux = 10.0 ** rng.uniform(3.0, 6.5, 5)  # all rungs, promotions
    nfx = 0.3 * nflux
    nflux[-1] = 0.0                           # a pure X-ray source
    dr = 3e22                                  # thin cells: rays reach r
    grid = _lls_grid(psolver.cfg, dr) * 0.1
    jrungs = []
    promote = jsolver._promote

    def record(per_src, nf, assign):
        jrungs[-1].append(np.bincount(
            assign, minlength=len(jsolver._radius_ladder())).tolist())
        return promote(per_src, nf, assign)

    jsolver._promote = record
    jstate = jax_initial_state(jsolver.cfg)
    pstate = port.initial_state(psolver.cfg, device="cpu")
    out = []
    for _ in range(2):
        jrungs.append([])
        jstate, ji = jsolver.evolve3d(jstate, jnp.asarray(ndens), dr, srcpos,
                                      nflux, DT, lls_grid=jnp.asarray(grid),
                                      nflux_xray=nfx)
        pstate, pi = psolver.evolve3d(pstate, torch.from_numpy(ndens), dr,
                                      srcpos, nflux, DT,
                                      lls_grid=torch.from_numpy(grid),
                                      nflux_xray=nfx)
        out.append((ji, pi, jstate, pstate, jrungs[-1]))
    return out, nflux.sum() + nfx.sum()


def test_adaptive_lls_xray_matches_jax_f64():
    """The adaptive path (windowed rungs r = 2, 4 with the LLS windows'
    second gather, and the full-cube rung) with a grid LLS cube and X-ray
    sources: the same niter and rung history as JAX, with promotions;
    mean xh1, the losses, phih and xh1 at rtol 1e-9."""
    runs, flux = _adaptive_runs()
    for ji, pi, jstate, pstate, jrungs in runs:
        assert pi.rungs == jrungs
        _check_step(ji, pi, jstate, pstate, flux, False)
    assert runs[0][1].rungs[0] != runs[0][1].rungs[-1]      # promoted
    assert runs[-1][1].lls_loss > 0.0


def test_xray_ionizes_end_to_end():
    """The port's twin of tests/test_round2.py::
    test_xray_ionizes_end_to_end: a pure X-ray (power-law) source ionizes
    through Evolve3D.evolve3d; without the X-ray SED the same inputs do
    nothing; the mean xh1 equals the JAX solver's at rtol 1e-9."""
    n = 16
    jcfg = jax_config(mesh=n, dtype="float64", use_lls=False,
                      cosmological=False, sed=JaxSED(use_xray_sed=True))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    solver = port.Evolve3D(cfg, build_rad_tables(cfg, device="cpu"),
                           device="cpu")
    state = port.initial_state(cfg, device="cpu")
    nh = 1.98e-4
    nd = torch.full((n, n, n), nh, dtype=torch.float64)
    dr = 5.7e24 / 4
    src = np.array([[8, 8, 8]], np.int32)
    zero = np.array([0.0])
    xflux = np.array([1e57]) / cfg.sed.pl_s_star
    dt = 0.05 / (const.BH00 * nh)
    _, info = solver.evolve3d(state, nd, dr, src, zero, dt,
                              nflux_xray=xflux)
    assert info.mean_xh1 > 10 * cfg.initial_xh
    jsolver = JaxEvolve3D(jcfg, jax_tables(jcfg))
    _, jinfo = jsolver.evolve3d(jax_initial_state(jcfg),
                                jnp.full((n, n, n), nh), dr, src, zero, dt,
                                nflux_xray=xflux)
    assert info.niter == jinfo.niter
    assert info.mean_xh1 == pytest.approx(jinfo.mean_xh1, rel=1e-9)
    # without the X-ray SED enabled the same inputs do nothing
    cfg0 = cfg.replace(sed=port.SEDConfig(use_xray_sed=False))
    solver0 = port.Evolve3D(cfg0, build_rad_tables(cfg0, device="cpu"),
                            device="cpu")
    _, info0 = solver0.evolve3d(state, nd, dr, src, zero, dt,
                                nflux_xray=xflux)
    assert info0.mean_xh1 < 1.01 * cfg.initial_xh
