"""The port's restarts, source models and N-body adapters against the
JAX package's, on the CPU.  Mirrors tests/test_restart.py,
tests/test_sources.py (all but the native catalog parser, which the port
does not copy), tests/test_adapters.py and tests/test_round3.py's
iteration-dump class, and shows that an iteration dump and a slice output
that JAX wrote resume in the port to JAX's own end.  Inputs come from
seeds with numpy; float64 results agree within 1e-9 relative, catalogs
exactly."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.driver import C2RayDriver as JaxDriver
from c2ray_tpu.driver import DriverConfig as JaxDriverConfig
from c2ray_tpu.models import nbody as jax_nbody
from c2ray_tpu.models import sources as jax_sources
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables
from c2ray_tpu.solver import Evolve3D as JaxEvolve3D
from c2ray_tpu.state import initial_state as jax_initial_state
from c2ray_tpu.utils.checkpoint import IterDumper as JaxIterDumper

import c2ray_tpu_torch as port
from c2ray_tpu_torch.convert import config_from_dict
from c2ray_tpu_torch.driver import C2RayDriver, DriverConfig
from c2ray_tpu_torch.models import nbody, sources
from c2ray_tpu_torch.models.nbody import fortran_f6_3
from c2ray_tpu_torch.ops.tables import build_rad_tables
from c2ray_tpu_torch.utils.checkpoint import IterDumper, load_slice_restart
from c2ray_tpu_torch.utils.io_fortran import (read_sm3d, write_sm3d,
                                              write_stream_cube)
from c2ray_tpu_torch.utils.output import OutputWriter

torch.set_num_threads(2)

RTOL = 1e-9


def port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


# --- iteration dumps and resumes in evolve3d ------------------------------

N = 16
NH = 1.98e-4
SRC = np.array([[8, 8, 8]], np.int32)
FLUX = np.array([1e9])
DT = 3.1e14
DR = 2.9e24


def iter_cfg(**kw):
    return jax_config(mesh=N, dtype="float64", use_lls=False,
                      cosmological=False, **kw)


def port_step(jcfg, state=None, **kw):
    cfg = port_cfg(jcfg)
    solver = port.Evolve3D(cfg, build_rad_tables(cfg, device="cpu"),
                           device="cpu")
    state = state if state is not None else port.initial_state(cfg,
                                                               device="cpu")
    nd = torch.full((N,) * 3, NH, dtype=torch.float64)
    return solver.evolve3d(state, nd, DR, SRC, FLUX, DT, **kw)


def jax_step(jcfg, **kw):
    solver = JaxEvolve3D(jcfg, jax_tables(jcfg))
    return solver.evolve3d(jax_initial_state(jcfg), jnp.full((N,) * 3, NH),
                           DR, SRC, FLUX, DT, **kw)


def newest_dump(path):
    return 1 if os.path.exists(os.path.join(path, "iterdump1.npz")) else 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_iter_restart_resumes(tmp_path, writer):
    """A step capped at 5 iterations dumps every iteration (interval 0);
    the port resumes from the newest dump, from either package's writer,
    and lands on the uninterrupted step: JAX's end within 1e-9, its own
    within 1e-10, with the niter of the uninterrupted step."""
    s_full, i_full = port_step(iter_cfg())
    js_full, ji_full = jax_step(iter_cfg())
    assert i_full.niter == ji_full.niter > 6
    cut = iter_cfg(max_global_iterations=5)
    if writer == "port":
        port_step(cut, dumper=IterDumper(dump_dir=str(tmp_path),
                                         interval_s=0.0))
        loaded = IterDumper.load(str(tmp_path), newest_dump(tmp_path))
    else:
        jax_step(cut, dumper=JaxIterDumper(dump_dir=str(tmp_path),
                                           interval_s=0.0))
        loaded = JaxIterDumper.load(str(tmp_path), newest_dump(tmp_path))
    assert "phih" in loaded and loaded["phih"].shape == (N,) * 3
    assert int(loaded["niter"]) < i_full.niter
    s_res, i_res = port_step(iter_cfg(), iter_restart=loaded)
    assert i_res.niter == i_full.niter
    np.testing.assert_allclose(s_res.xh1.numpy(), s_full.xh1.numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(s_res.xh1.numpy(), np.asarray(js_full.xh1),
                               rtol=RTOL)


def test_resume_enters_pending_chemistry_without_sweep(tmp_path,
                                                       monkeypatch):
    """start_from_dump runs the restored chemistry first, then one sweep
    per further iteration (evolve.F90:154-158, 328-426)."""
    port_step(iter_cfg(), dumper=IterDumper(dump_dir=str(tmp_path),
                                            interval_s=0.0))
    loaded = IterDumper.load(str(tmp_path), newest_dump(tmp_path))
    k = int(loaded["niter"])
    import c2ray_tpu_torch.solver as S
    events = []
    orig_rt, orig_tail = S.raytrace_all_sources, S.Evolve3D._tail
    monkeypatch.setattr(S, "raytrace_all_sources", lambda *a, **kw: (
        events.append("sweep"), orig_rt(*a, **kw))[1])
    monkeypatch.setattr(S.Evolve3D, "_tail", lambda self, *a, **kw: (
        events.append("chem"), orig_tail(self, *a, **kw))[1])
    _, info = port_step(iter_cfg(), iter_restart=loaded)
    assert events[0] == "chem"
    assert events.count("sweep") == info.niter - k


def test_sm3d_roundtrip_and_slice_restart(tmp_path):
    a = np.random.default_rng(0).random((5, 6, 7))
    p = str(tmp_path / "cube.bin")
    write_sm3d(p, a, np.float64)
    np.testing.assert_array_equal(read_sm3d(p, np.float64,
                                            expect_mesh=(5, 6, 7)), a)
    with pytest.raises(ValueError):
        read_sm3d(p, np.float64, expect_mesh=(5, 6, 8))
    # restart=1 reads the run's own xfrac3D output back
    cfg = port.test_problem_config(mesh=8, dtype="float64")
    xh = np.random.default_rng(1).random((8, 8, 8))
    out = OutputWriter(cfg, results_dir=str(tmp_path) + "/")
    out.write_stream2(8.884, torch.from_numpy(xh))
    st = load_slice_restart(cfg, str(tmp_path) + "/", 8.884, device="cpu")
    np.testing.assert_array_equal(st.xh1.numpy(), xh)


def test_report_memory():
    from c2ray_tpu_torch.utils.report_memory import report_memory
    assert report_memory().get("VmRSS", 0) > 0


# --- driver restarts: slice, mid-slice, iteration dump ---------------------

def run_driver(tag, jcfg, tmp_path, max_slices, results=None, **dc_kw):
    """One driver run of either package on the test problem.  ->
    (driver, final state)"""
    res = str(tmp_path / (results or tag)) + "/"
    if tag == "jax":
        cfg, mod, drv_cls, dc_cls, kw = (jcfg, jax_nbody, JaxDriver,
                                         JaxDriverConfig, {})
    else:
        cfg, mod, drv_cls, dc_cls, kw = (port_cfg(jcfg), nbody, C2RayDriver,
                                         DriverConfig, dict(device="cpu"))
    ad = mod.test_adapter(cfg, source_dir=str(tmp_path) + "/")
    dc = dc_cls(results_dir=res, dump_dir=res, **dc_kw)
    drv = drv_cls(cfg, adapter=ad, driver_cfg=dc, verbose=False, **kw)
    return drv, drv.run(max_slices=max_slices)


def x_of(state):
    return np.asarray(state.xh1) if not isinstance(state.xh1, torch.Tensor) \
        else state.xh1.numpy()


def niters(drv):
    return [h["niter"] for h in drv.history]


def test_jax_slice_output_resumes_in_port(tmp_path):
    """restart=1 of slice 1 from the cubes JAX wrote (non-isothermal, so
    the float32 Temper3D cube too): the port ends where JAX's own restart
    ends, with the niter of JAX's uninterrupted run.  (The restarted
    temperature is the float32 cube's, so neither package's restart ends
    on its uninterrupted run's bits.)"""
    jcfg = jax_config(mesh=16, dtype="float64", use_lls=False,
                      isothermal=False, initial_temperature=1e3)
    (tmp_path / "test_sources.dat").write_text("1\n8 8 8 1e57 0.0\n")
    jdrv, _ = run_driver("jax", jcfg, tmp_path, 2, number_timesteps=2)
    kw = dict(number_timesteps=2, restart=1, nz0=1)
    jr, jrs = run_driver("jax", jcfg, tmp_path, 1, **kw)
    pr, prs = run_driver("port", jcfg, tmp_path, 1, results="jax", **kw)
    assert niters(pr) == niters(jr) == niters(jdrv)[2:]
    np.testing.assert_allclose(x_of(prs), x_of(jrs), rtol=RTOL, atol=0)
    np.testing.assert_allclose(prs.temper_current.numpy(),
                               np.asarray(jrs.temper_current), rtol=RTOL)


def test_mid_slice_restart(tmp_path):
    """restart=2 from an intermediate output redshift (two outputs per
    slice), in both packages from each one's own output."""
    jcfg = jax_config(mesh=16, dtype="float64", use_lls=False)
    (tmp_path / "test_sources.dat").write_text("1\n8 8 8 1e57 0.0\n")
    ends = {}
    for tag in ("jax", "port"):
        run_driver(tag, jcfg, tmp_path, 1, number_timesteps=2,
                   number_outputs=2)
        outs = sorted(f for f in os.listdir(tmp_path / tag)
                      if f.startswith("xfrac3D"))
        assert len(outs) == 2
        z_interm = max(float(f[8:-4]) for f in outs)
        r, state = run_driver(tag, jcfg, tmp_path, 1, number_timesteps=2,
                              number_outputs=2, restart=2,
                              zred_interm=z_interm)
        ends[tag] = (niters(r), x_of(state))
    assert ends["port"][0] == ends["jax"][0]
    np.testing.assert_allclose(ends["port"][1], ends["jax"][1], rtol=RTOL)


def test_driver_iteration_dump_restart(tmp_path):
    """iter_restart 3 (the newest dump) through the driver: a dump JAX
    wrote in a slice's first step, cut at 5 iterations, resumes in both
    drivers (restart=1 from the slice's start cube); the port ends where
    JAX's resumed run ends, and where its own uninterrupted run ends."""
    cfg0 = jax_config(mesh=16, dtype="float64", use_lls=False,
                      cosmological=False)
    (tmp_path / "test_sources.dat").write_text("1\n8 8 8 1e57 0.0\n")
    d = tmp_path / "restart"
    d.mkdir()
    z0 = float(jax_nbody.test_adapter(cfg0).zred_array[0])
    write_sm3d(str(d / f"xfrac3D_{fortran_f6_3(z0)}.bin"),
               np.full((16,) * 3, cfg0.initial_xh))
    cut = cfg0.replace(max_global_iterations=5)
    jdrv = JaxDriver(cut, adapter=jax_nbody.test_adapter(
        cut, source_dir=str(tmp_path) + "/"), driver_cfg=JaxDriverConfig(
        number_timesteps=1, results_dir=str(tmp_path / "cut") + "/",
        dump_dir=str(d) + "/"), verbose=False)
    jdrv.dumper.interval_s = 0.0
    jdrv.run(max_slices=1)
    assert os.path.exists(d / "iterdump1.npz")
    assert os.path.exists(d / "iterdump2.npz")
    ends = {}
    for tag in ("jax", "port"):
        drv, state = run_driver(tag, cfg0, tmp_path, 1, results="restart",
                                number_timesteps=1, restart=1, nz0=0,
                                iter_restart=3)
        ends[tag] = (niters(drv), x_of(state))
    assert ends["port"][0] == ends["jax"][0]
    np.testing.assert_allclose(ends["port"][1], ends["jax"][1], rtol=RTOL)
    full, fstate = run_driver("port", cfg0, tmp_path, 1, results="full",
                              number_timesteps=1)
    assert niters(full) == ends["port"][0]
    np.testing.assert_allclose(ends["port"][1], x_of(fstate), rtol=1e-10)


# --- source models (tests/test_sources.py) --------------------------------

M_GRID = 1e40  # grams per grid mass unit


def source_rows():
    # pos (1-based) HMACH LMACH LMACH_SUPPR
    return np.array([
        [8, 8, 8, 100.0, 0.0, 0.0],     # massive halo in a neutral cell
        [2, 2, 2, 0.0, 10.0, 4.0],      # low-mass halo in a neutral cell
        [4, 4, 4, 0.0, 10.0, 4.0],      # low-mass halo in an ionized cell
        [6, 6, 6, 50.0, 20.0, 8.0],     # mixed halo in an ionized cell
    ])


def xh_grid():
    x = np.full((16, 16, 16), 1e-4)
    x[3, 3, 3] = x[5, 5, 5] = 0.9
    return x


def assert_same_catalog(a, b):
    np.testing.assert_array_equal(a.srcpos, b.srcpos)
    np.testing.assert_array_equal(a.normflux_stellar, b.normflux_stellar)
    np.testing.assert_array_equal(a.normflux_xray, b.normflux_xray)


@pytest.mark.parametrize("recipe,uv", [
    (0, None), (3, None), (4, None), (6, None), (7, None),
    (1, [1e60, 1e60]), (2, [1e50]),
])
def test_source_models_match_jax(recipe, uv):
    """Every UV recipe's catalog, with the suppression read from a torch
    grid, equal to JAX's from the same rows and grid; the fixed budget
    banks and releases its photons the same way."""
    jcfg = jax_config(mesh=16, dtype="float64")
    kw = dict(m_grid=M_GRID)
    if uv is not None:
        kw["uv_array"] = np.array(uv)
    jm = jax_sources.SourceModel.from_recipe(jcfg, recipe, **kw)
    pm = sources.SourceModel.from_recipe(port_cfg(jcfg), recipe, **kw)
    dt = 1e7 * const.YEAR
    rows = source_rows()
    if recipe == 7:
        rows = rows[:, :5] * [1, 1, 1, 1e54, 1e53]
    for nz in range(2 if recipe == 1 else 1):
        if recipe == 1 and nz == 0:
            jm.bank_photons(0)
            pm.bank_photons(0)
        a = pm.load(rows, torch.from_numpy(xh_grid()), nz, dt, dt_slice=dt)
        b = jm.load(rows, xh_grid(), nz, dt, dt_slice=dt)
        assert_same_catalog(a, b)
        assert (pm.num_supprsd, pm.num_supprble, pm.num_massive,
                pm.cumulative_uv) == (jm.num_supprsd, jm.num_supprble,
                                      jm.num_massive, jm.cumulative_uv)
    assert set(sources.UV_MODELS) == set(jax_sources.UV_MODELS) \
        == set(range(8))


def test_iliev_suppression():
    cfg = port_cfg(jax_config(mesh=16, dtype="float64"))
    model = sources.SourceModel.from_recipe(cfg, 0, m_grid=M_GRID)
    cat = model.load(source_rows(), torch.from_numpy(xh_grid()), 0,
                     1e7 * const.YEAR)
    assert cat.num_src == 3 and model.num_supprsd == 2


def test_collapsed_fraction_growth_matches_jax():
    jcfg = jax_config(mesh=16, dtype="float64")
    jm = jax_sources.SourceModel.from_recipe(jcfg, 5, m_grid=M_GRID)
    pm = sources.SourceModel.from_recipe(port_cfg(jcfg), 5, m_grid=M_GRID)
    dt = 1e7 * const.YEAR
    x = np.full((16, 16, 16), 1e-4)
    rows1 = source_rows().copy()
    rows1[:, 3] *= 1.1
    for nz, rows in enumerate((source_rows(), rows1)):
        a = pm.load(rows, torch.from_numpy(x), nz, dt, dt_slice=dt)
        b = jm.load(rows, x, nz, dt, dt_slice=dt)
        assert_same_catalog(a, b)
    assert a.num_src >= 1 and np.all(a.normflux_stellar > 0)


def test_read_and_sort(tmp_path):
    p = tmp_path / "src.dat"
    p.write_text("3\n1 2 3 1e54 0\n4 5 6 1e57 0\n7 8 9 1.0D+55 0\n\n")
    rows = sources.read_source_file(str(p))
    np.testing.assert_array_equal(rows, jax_sources.read_source_file(str(p)))
    cfg = port_cfg(jax_config(mesh=16, dtype="float64"))
    cat = sources.sort_sources_by_flux(sources.SourceModel.from_recipe(
        cfg, 7).load(rows, np.zeros((16, 16, 16)), 0, 1.0))
    assert list(cat.normflux_stellar * cfg.sed.s_star) == [1e57, 1e55, 1e54]
    assert tuple(cat.srcpos[0]) == (3, 4, 5)


def test_read_uv_file(tmp_path):
    p = tmp_path / "uv.dat"
    p.write_text("2\n9.0 1 2 3 4e60\n8.9 1 2 3 5e60\n")
    for recipe in (1, 2):
        np.testing.assert_array_equal(
            sources.read_uv_file(str(p), recipe),
            jax_sources.read_uv_file(str(p), recipe))


# --- the N-body adapters (tests/test_adapters.py) ---------------------------

ZREDS = [9.0, 8.9, 8.8]


def adapter_inputs(tmp_path, kind):
    n = 16
    zfile = tmp_path / "redshifts.dat"
    rng = np.random.default_rng({"LG": 0, "pmfast": 1, "gadget": 2}[kind])
    jcfg = jax_config(mesh=n, dtype="float64", use_lls=False)
    if kind == "LG":
        zfile.write_text(f"{len(ZREDS)}\n" + "".join(
            f"{100 + i} {z}\n" for i, z in enumerate(ZREDS)))
        mean = (jcfg.cosmo.rho_crit_0 * const.MPC**3 / const.M_SOLAR
                / jcfg.cosmo.h**2 * jcfg.cosmo.omega0)
        for i in range(len(ZREDS)):
            (tmp_path / f"{i + 1:03d}-dmdens_cic_sources.dat").write_text(
                "1\n8 8 8 50.0 0.0\n")
            write_stream_cube(str(tmp_path / f"{i + 1:03d}dmdens_cic.dat"),
                              (mean * rng.lognormal(0.0, 0.2, (n,) * 3))
                              .astype(np.float32))
    else:
        zfile.write_text(f"{len(ZREDS)}\n" + "".join(f"{z}\n" for z in ZREDS))
        ident = "coarse" if kind == "pmfast" else "gadget"
        line = "1\n8 8 8 50.0 0.0\n" if kind == "pmfast" else \
            "1\n8 8 8 1e57 0.0\n"
        scale = 1.0 if kind == "pmfast" else \
            jcfg.cosmo.rho_crit_0 * jcfg.cosmo.omega_b
        for z in ZREDS:
            zs = fortran_f6_3(z)
            (tmp_path / f"{zs}-{ident}_sources.dat").write_text(line)
            write_stream_cube(str(tmp_path / f"{zs}rho_{ident}.dat"),
                              (scale * rng.lognormal(0.0, 0.2, (n,) * 3))
                              .astype(np.float32), header=kind != "pmfast")

    def make(mod, cfg):
        d = str(tmp_path) + "/"
        if kind == "LG":
            return mod.lg_adapter(cfg, boxsize=cfg.boxsize_mpc_h, n_box=64,
                                  redshift_file=str(zfile), dir_dens=d,
                                  dir_src=d)
        if kind == "pmfast":
            return mod.pmfast_adapter(cfg, boxsize=cfg.boxsize_mpc_h,
                                      n_box=64, redshift_file=str(zfile),
                                      id_str="coarse", dir_dens=d, dir_src=d)
        return mod.gadget_adapter(cfg, boxsize=cfg.boxsize_mpc_h,
                                  redshift_file=str(zfile), dir_dens=d,
                                  dir_src=d)
    return jcfg, make


@pytest.mark.parametrize("kind,recipe", [("LG", 0), ("pmfast", 0),
                                         ("gadget", 7)])
def test_adapter_end_to_end(tmp_path, kind, recipe):
    """Each adapter's redshifts, file names, units and density reader equal
    JAX's (the density bitwise: the JAX reader's float64 product stored
    float32), and one slice through both drivers agrees."""
    jcfg, make = adapter_inputs(tmp_path, kind)
    jad, pad = make(jax_nbody, jcfg), make(nbody, port_cfg(jcfg))
    np.testing.assert_array_equal(pad.zred_array, jad.zred_array)
    assert pad.density_filename(8.9, 1) == jad.density_filename(8.9, 1)
    assert pad.source_filename(8.9, 1) == jad.source_filename(8.9, 1)
    assert pad.m_grid == jad.m_grid
    np.testing.assert_array_equal(pad.read_density(9.0, 0),
                                  jad.read_density(9.0, 0))
    states = {}
    for tag, mod, cfg, drv_cls, dc_cls, kw in (
            ("jax", jax_nbody, jcfg, JaxDriver, JaxDriverConfig, {}),
            ("port", nbody, port_cfg(jcfg), C2RayDriver, DriverConfig,
             dict(device="cpu"))):
        drv = drv_cls(cfg, adapter=make(mod, cfg), driver_cfg=dc_cls(
            uv_recipe=recipe, number_timesteps=1,
            results_dir=str(tmp_path / tag) + "/"), verbose=False, **kw)
        states[tag] = (x_of(drv.run(max_slices=1)), niters(drv))
    assert states["port"][1] == states["jax"][1]
    np.testing.assert_allclose(states["port"][0], states["jax"][0],
                               rtol=RTOL)
    assert states["port"][0][7, 7, 7] > 0.3
