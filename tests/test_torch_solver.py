"""The PyTorch port end to end on the CPU: Evolve3D.evolve3d against the
frozen goldens and against the JAX package's Evolve3D on the same inputs
(made with numpy from a seed), the radius-limiting options against JAX,
the package's import boundary, and the options this slice of the port
rejects."""

import dataclasses
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.models.sources import SourceModel, read_source_file
from c2ray_tpu.ops.photonstats import PhotonStatistics as JaxStats
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables
from c2ray_tpu.solver import Evolve3D as JaxEvolve3D
from c2ray_tpu.state import initial_state as jax_initial_state

import c2ray_tpu_torch as port
from c2ray_tpu_torch.convert import config_from_dict, tables_from_numpy
from c2ray_tpu_torch.ops.photonstats import PhotonStatistics
from c2ray_tpu_torch.ops.tables import build_rad_tables

torch.set_num_threads(2)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the frozen golden problem (tests/test_golden.py, scripts/make_goldens.py)
NH = 1.98e-4
ZRED = 9.0
DT_GOLDEN = 1e7 * const.YEAR


def _run_golden(src_file):
    jcfg = jax_config(mesh=100, dtype="float64", use_lls=False,
                      cosmological=False, rate_eval="table",
                      sweep_backend="facemajor")
    rows = read_source_file(os.path.join(FIXDIR, src_file))
    cat = SourceModel.from_recipe(jcfg, 7).load(
        rows, np.asarray(jax_initial_state(jcfg).xh1), 0, jcfg.lifetime)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    solver = port.Evolve3D(cfg, build_rad_tables(cfg, device="cpu"),
                           device="cpu")
    state = port.initial_state(cfg, device="cpu")
    ndens = torch.full((100,) * 3, NH, dtype=torch.float64)
    dr = cfg.dr_comoving / (1.0 + ZRED)
    state, info = solver.evolve3d(state, ndens, dr, cat.srcpos,
                                  cat.normflux_stellar, DT_GOLDEN)
    return state, info


def test_golden_onesrc_100():
    g = np.load(os.path.join(FIXDIR, "golden_onesrc_100.npz"))
    state, info = _run_golden("test_sources_onesrc.dat")
    assert info.niter == 67 == int(g["niters"][0])
    assert info.converged
    np.testing.assert_allclose(state.xh1.numpy(), g["xh1"], rtol=1e-9,
                               atol=0)


@pytest.mark.slow
def test_golden_standard_100():
    g = np.load(os.path.join(FIXDIR, "golden_standard_100.npz"))
    state, info = _run_golden("test_sources_standard.dat")
    assert info.niter == 66 == int(g["niters"][0])
    np.testing.assert_allclose(state.xh1.numpy(), g["xh1"], rtol=1e-9,
                               atol=0)


# --- the port against the JAX Evolve3D at 32^3 x 3 sources --------------

N = 32
DT = 3.0e13
DR = 4.4e23          # the golden problem's proper cell size


def _problem():
    rng = np.random.default_rng(21)
    ndens = rng.uniform(1.5e-4, 2.5e-4, (N,) * 3)
    srcpos = rng.integers(0, N, (3, 3)).astype(np.int32)
    srcpos[0] = [0, N - 1, 5]                 # a periodic corner
    nflux = 10.0 ** rng.uniform(5.5, 6.5, 3)
    return ndens, srcpos, nflux


@functools.lru_cache(maxsize=None)
def _both(dtype, steps=2):
    """Two timesteps of the JAX Evolve3D and of the port's, with photon
    statistics, from identical inputs and tables."""
    jcfg = jax_config(mesh=N, dtype=dtype, use_lls=True, type_of_lls=1,
                      cosmological=False, rate_eval="expsum",
                      source_batch=2)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    jtabs = jax_tables(jcfg)
    ptabs = tables_from_numpy({k: np.asarray(v) for k, v in
                               jtabs._asdict().items()}, "cpu")
    ndens, srcpos, nflux = _problem()
    out = {}
    jsolver = JaxEvolve3D(jcfg, jtabs)
    jstate = jax_initial_state(jcfg)
    jstats = JaxStats(jcfg)
    psolver = port.Evolve3D(cfg, ptabs, device="cpu")
    pstate = port.initial_state(cfg, device="cpu")
    pstats = PhotonStatistics(cfg)
    jinfos, pinfos = [], []
    for _ in range(steps):
        jstate, ji = jsolver.evolve3d(
            jstate, jnp.asarray(ndens.astype(jcfg.np_dtype)), DR, srcpos,
            nflux, DT, lls_coldens=1e17, stats=jstats)
        pstate, pi = psolver.evolve3d(
            pstate, torch.from_numpy(ndens.astype(cfg.np_dtype)), DR, srcpos,
            nflux, DT, lls_coldens=1e17, stats=pstats)
        jinfos.append(ji)
        pinfos.append(pi)
    out["jax"] = (np.asarray(jstate.xh1), jinfos)
    out["port"] = (pstate.xh1.numpy(), pinfos)
    return out


def test_evolve3d_matches_jax_f64_expsum():
    r = _both("float64")
    (jx, jinfos), (px, pinfos) = r["jax"], r["port"]
    for ji, pi in zip(jinfos, pinfos):
        assert pi.niter == ji.niter
        assert pi.converged == ji.converged
        assert pi.conv_flag == ji.conv_flag
        assert pi.mean_xh1 == pytest.approx(ji.mean_xh1, rel=1e-9)
        np.testing.assert_allclose(pi.per_source_loss, ji.per_source_loss,
                                   rtol=1e-9, atol=1e-12 * 3e8)
        assert pi.photon_stats["photon_cons"] == pytest.approx(
            ji.photon_stats["photon_cons"], rel=1e-9)
        np.testing.assert_allclose(pi.phih.numpy(), np.asarray(ji.phih),
                                   rtol=1e-9, atol=0)
    np.testing.assert_allclose(px, jx, rtol=1e-9, atol=0)
    assert 0.0 < pinfos[-1].mean_xh1 < 1.0
    assert pinfos[-1].mean_xh1 > pinfos[0].mean_xh1


def test_evolve3d_matches_jax_f32_expsum():
    r = _both("float32")
    (jx, jinfos), (px, pinfos) = r["jax"], r["port"]
    assert px.dtype == np.float32
    assert np.isfinite(px).all()
    for ji, pi in zip(jinfos, pinfos):
        assert abs(pi.niter - ji.niter) <= 1
    # the states' means, summed in float64: XLA's float32 grid sum (the
    # JAX info.mean_xh1) drifts ~2e-4 from the float64 mean here, while
    # torch's cascade sum keeps the port's mean_xh1 to ~1e-6
    mean = lambda x: float(np.mean(x.astype(np.float64)))
    assert mean(px) == pytest.approx(mean(jx), rel=2e-4)
    assert pinfos[-1].mean_xh1 == pytest.approx(mean(px), rel=1e-5)
    assert mean(px) == pytest.approx(mean(_both("float64")["port"][0]),
                                     rel=2e-4)


@pytest.mark.parametrize("overrides", [
    dict(adaptive_sweep=True),
    dict(max_shell=3),
    dict(max_subbox=2),
])
def test_radius_options_match_jax(overrides):
    """The options that limit the sweep radius, each through Evolve3D on
    the CPU against the JAX Evolve3D: adaptive rungs (windowed r = 2, 4
    and the full cube at 16^3, with promotions in both steps), a capped
    full-cube sweep from max_shell, and one from max_subbox.  Two steps,
    f64 expsum rates, LLS type 1."""
    n = 16
    jcfg = jax_config(mesh=n, dtype="float64", use_lls=True, type_of_lls=1,
                      cosmological=False, rate_eval="expsum",
                      source_batch=2, adaptive_min_shell=2, **overrides)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    jtabs = jax_tables(jcfg)
    ptabs = tables_from_numpy({k: np.asarray(v) for k, v in
                               jtabs._asdict().items()}, "cpu")
    rng = np.random.default_rng(21)
    ndens = rng.uniform(1.5e-4, 2.5e-4, (n,) * 3)
    srcpos = rng.integers(0, n, (4, 3)).astype(np.int32)
    srcpos[0] = [0, n - 1, 5]                 # a periodic corner
    nflux = 10.0 ** rng.uniform(3.0, 6.5, 4)  # adaptive: all rungs, promotions
    dr = 3e22                                  # thin cells: rays reach r
    jsolver = JaxEvolve3D(jcfg, jtabs)
    psolver = port.Evolve3D(cfg, ptabs, device="cpu")
    jstate = jax_initial_state(jcfg)
    pstate = port.initial_state(cfg, device="cpu")
    for _ in range(2):
        jstate, ji = jsolver.evolve3d(jstate, jnp.asarray(ndens), dr, srcpos,
                                      nflux, DT, lls_coldens=1e17)
        pstate, pi = psolver.evolve3d(pstate, torch.from_numpy(ndens), dr,
                                      srcpos, nflux, DT, lls_coldens=1e17)
        assert pi.niter == ji.niter
        assert pi.conv_flag == ji.conv_flag
        assert pi.mean_xh1 == pytest.approx(ji.mean_xh1, rel=1e-9)
        np.testing.assert_allclose(pi.per_source_loss, ji.per_source_loss,
                                   rtol=1e-9, atol=1e-12 * nflux.sum())
        np.testing.assert_allclose(pstate.xh1.numpy(), np.asarray(jstate.xh1),
                                   rtol=1e-9, atol=0)
    if overrides.get("adaptive_sweep"):
        assert pi.rungs[0] != pi.rungs[-1]       # promoted
    else:
        assert pi.rungs is None


def test_import_leaves_jax_out():
    code = ("import sys, c2ray_tpu_torch, c2ray_tpu_torch.convert, "
            "c2ray_tpu_torch.ops.sweep_cuda, "
            "c2ray_tpu_torch.ops.window_cuda, c2ray_tpu_torch.ops.thermal, "
            "c2ray_tpu_torch.models.lls; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'c2ray_tpu' or "
            "m.startswith('c2ray_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_evolve3d_device_defaults_to_cuda():
    cfg = port.test_problem_config(mesh=8, dtype="float32")
    tabs = build_rad_tables(cfg, device="cpu")
    if torch.cuda.is_available():
        assert port.Evolve3D(cfg, tabs).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            port.Evolve3D(cfg, tabs)
        with pytest.raises(RuntimeError):
            port.initial_state(cfg)


@pytest.mark.parametrize("overrides", [
    dict(mesh=(8, 8, 10)),        # the JAX package asserts a cubic mesh too
    dict(dtype="float16"),
])
def test_rejected_options_raise(overrides):
    """What the port still refuses on the CPU: compressed storage and
    add_photon_losses are ported (tests/test_torch_compressed.py)."""
    cfg = port.test_problem_config(mesh=8, dtype="float64").replace(
        **overrides)
    tabs = build_rad_tables(port.test_problem_config(mesh=8,
                                                     dtype="float64"),
                            device="cpu")
    with pytest.raises(NotImplementedError):
        port.Evolve3D(cfg, tabs, device="cpu")


def test_rejected_call_arguments_raise(tmp_path):
    """dumper, iter_restart and clocks, once refused, are accepted and
    used: a step cut at 4 iterations dumps every iteration (interval 0),
    the clock stamps each iteration, and the step resumed from the newest
    dump ends where the uninterrupted step does (niter and xh1)."""
    from c2ray_tpu_torch.utils.checkpoint import IterDumper
    from c2ray_tpu_torch.utils.clocks import Clocks
    cfg = port.test_problem_config(mesh=8, dtype="float64",
                                   cosmological=False, use_lls=False)
    tabs = build_rad_tables(cfg, device="cpu")
    nd = torch.full((8,) * 3, NH, dtype=torch.float64)
    src, flux = np.array([[4, 4, 4]]), np.array([1e9])

    def step(c, **kw):
        solver = port.Evolve3D(c, tabs, device="cpu")
        return solver.evolve3d(port.initial_state(c, device="cpu"), nd,
                               2.9e24, src, flux, 3.1e14, **kw)
    full, info = step(cfg)
    assert info.niter > 5
    clocks = Clocks(str(tmp_path / "Timings.log"))
    dumper = IterDumper(dump_dir=str(tmp_path), interval_s=0.0)
    _, cut = step(cfg.replace(max_global_iterations=4), dumper=dumper,
                  clocks=clocks)
    assert dumper._ndump == cut.niter == 5
    stamps = (tmp_path / "Timings.log").read_text().splitlines()
    assert stamps[-1].startswith("Time after iteration 5")
    loaded = IterDumper.load(str(tmp_path), 1)        # the 5th dump
    assert int(loaded["niter"]) == 5
    resumed, rinfo = step(cfg, iter_restart=loaded)
    assert rinfo.niter == info.niter
    np.testing.assert_allclose(resumed.xh1.numpy(), full.xh1.numpy(),
                               rtol=1e-10, atol=0)
