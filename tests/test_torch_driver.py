"""The port's command-line run against the JAX package's, on the CPU: the
JAX driver and the port's (device "cpu") run on the same temporary inputs
(made from seeds with numpy) and must agree: niter per step equal, the
same output files, and xh1, temperature, rate cubes and PhotonCounts
numbers within 1e-9 relative in float64.  Mirrors tests/test_driver.py,
tests/test_round3.py's clumping-driver, memory and CLI classes and
tests/test_round5.py's per-cell clumping and grid-LLS driver runs."""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.__main__ import main as jax_main
from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.driver import C2RayDriver as JaxDriver
from c2ray_tpu.driver import DriverConfig as JaxDriverConfig
from c2ray_tpu.driver import read_input_file as jax_read_input_file
from c2ray_tpu.driver import read_input_stdin as jax_read_input_stdin
from c2ray_tpu.models import nbody as jax_nbody

from c2ray_tpu_torch.__main__ import main as port_main
from c2ray_tpu_torch.convert import config_from_dict
from c2ray_tpu_torch.driver import C2RayDriver, DriverConfig
from c2ray_tpu_torch.driver import read_input_file, read_input_stdin
from c2ray_tpu_torch.models import nbody
from c2ray_tpu_torch.models.nbody import fortran_f6_3
from c2ray_tpu_torch.state import xh1_of
from c2ray_tpu_torch.utils.io_fortran import (read_sm3d, write_stream_cube,
                                              write_unformatted_records)

torch.set_num_threads(2)

RTOL = 1e-9      # float64 results, port against JAX


def port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def run_both(tmp_path, jcfg, make_adapter, max_slices, **dc_kw):
    """The JAX driver and the port's on the same inputs, results in
    tmp_path/jax and tmp_path/port.  make_adapter(nbody_module, cfg) builds
    an adapter with the given package's adapters.  -> (jax driver, its
    final state, port driver, its final state)"""
    out = []
    for tag, mod, cfg_of, drv_cls, dc_cls, kw in (
            ("jax", jax_nbody, lambda c: c, JaxDriver, JaxDriverConfig, {}),
            ("port", nbody, port_cfg, C2RayDriver, DriverConfig,
             dict(device="cpu"))):
        cfg = cfg_of(jcfg)
        dc = dc_cls(results_dir=str(tmp_path / tag) + "/",
                    dump_dir=str(tmp_path / tag) + "/", **dc_kw)
        drv = drv_cls(cfg, adapter=make_adapter(mod, cfg), driver_cfg=dc,
                      verbose=False, **kw)
        out += [drv, drv.run(max_slices=max_slices)]
    return tuple(out)


def dense(x, compressed):
    x = torch.as_tensor(np.array(x))
    return (xh1_of(x) if compressed else x).numpy()


def photon_rows(path):
    """The numbers of a PhotonCounts file (a rerun appends its header)."""
    return [[float(v) for v in line.split()]
            for line in open(path).read().splitlines()
            if not line.lstrip().startswith("Columns")]


def compare_runs(tmp_path, jdrv, jstate, pdrv, pstate, results=("jax", "port")):
    """niter per step, output files and their contents, final states."""
    cfg = pdrv.cfg
    assert ([h["niter"] for h in pdrv.history]
            == [h["niter"] for h in jdrv.history])
    jdir, pdir = (tmp_path / r for r in results)
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names
    for name in names:
        if name.startswith(("xfrac3D", "Temper3D", "IonRates3D",
                            "HeatRates3D")):
            dt = np.float64 if name.startswith("xfrac") else np.float32
            a = read_sm3d(str(pdir / name), dt)
            b = read_sm3d(str(jdir / name), dt)
            atol = 0.0 if name.startswith(("xfrac", "Temper")) else \
                RTOL * float(np.abs(b).max())
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol,
                                       err_msg=name)
        elif name.startswith("PhotonCounts"):
            pa, pb = photon_rows(pdir / name), photon_rows(jdir / name)
            assert len(pa) == len(pb)
            np.testing.assert_allclose(np.array(pa), np.array(pb),
                                       rtol=RTOL, err_msg=name)
    comp = cfg.compressed_xfrac
    np.testing.assert_allclose(dense(pstate.xh1, comp),
                               dense(jstate.xh1, comp), rtol=RTOL, atol=0)
    if not cfg.isothermal:
        np.testing.assert_allclose(pstate.temper_current.numpy(),
                                   np.asarray(jstate.temper_current),
                                   rtol=RTOL)


def adapter_in(tmp_path):
    return lambda mod, cfg: mod.test_adapter(cfg,
                                             source_dir=str(tmp_path) + "/")


def test_input_file_protocol(tmp_path):
    files = {
        "input": ("n   ! restart\nn   ! mid\n1   ! slice\n7   ! uv\n"
                  "10  ! steps\n1   ! outputs\n", ("test",)),
        "input2": ("y\nn\n3\nredshifts.dat\n0\n4\n2\n",
                   ("cubep3m", "pmfast", "LG")),
        "input3": ("n\nn\n1\n8.5\n7\n4\n2\n", ("gadget",)),
        "input4": ("y\ny\n2\n1\nuv.dat\n3\n1\n2\n8.93\n", ("test",)),
    }
    for name, (text, kinds) in files.items():
        p = tmp_path / name
        p.write_text(text)
        for kind in kinds:
            got = read_input_file(str(p), kind)
            assert dataclasses.asdict(got) == dataclasses.asdict(
                jax_read_input_file(str(p), kind))
            # the stdin protocol: all tokens, comments stripped first
            toks = " ".join(line.split()[0] for line in text.splitlines())
            assert dataclasses.asdict(read_input_stdin(
                kind, io.StringIO(toks))) == dataclasses.asdict(
                jax_read_input_stdin(kind, io.StringIO(toks)))
    assert read_input_file(str(tmp_path / "input4")).zred_interm == 8.93
    assert read_input_stdin("test", io.StringIO("")) == DriverConfig()


def test_driver_test_problem(tmp_path):
    """Two slices of the test problem, then a slice restart of the second
    from each package's own output."""
    jcfg = jax_config(mesh=16, dtype="float64", use_lls=False)
    (tmp_path / "test_sources.dat").write_text("1\n8 8 8 1e57 0.0\n")
    ad = adapter_in(tmp_path)
    run = run_both(tmp_path, jcfg, ad, 2, number_timesteps=2)
    compare_runs(tmp_path, *run)
    assert run[3].xh1[8, 8, 8] > 0.99
    rerun = run_both(tmp_path, jcfg, ad, 1, number_timesteps=2, restart=1,
                     nz0=1)
    compare_runs(tmp_path, *rerun)
    # re-running slice 1 from its restart point reproduces the first end
    np.testing.assert_allclose(rerun[3].xh1.numpy(), run[3].xh1.numpy(),
                               rtol=1e-8)


def test_driver_compressed_storage(tmp_path):
    """Compressed storage through both drivers; the port's decodes to its
    own dense run, and a slice restart re-encodes the stored cube."""
    (tmp_path / "test_sources.dat").write_text("1\n8 8 8 1e57 0.0\n")
    ad = adapter_in(tmp_path)
    jcfg = jax_config(mesh=16, dtype="float64", use_lls=False,
                      compressed_xfrac=True)
    run = run_both(tmp_path, jcfg, ad, 2, number_timesteps=2)
    compare_runs(tmp_path, *run)
    dense_cfg = port_cfg(jcfg.replace(compressed_xfrac=False))
    drv = C2RayDriver(dense_cfg, adapter=ad(nbody, dense_cfg),
                      driver_cfg=DriverConfig(
                          number_timesteps=2,
                          results_dir=str(tmp_path / "dense") + "/"),
                      verbose=False, device="cpu")
    sd = drv.run(max_slices=2)
    np.testing.assert_allclose(xh1_of(run[3].xh1).numpy(), sd.xh1.numpy(),
                               rtol=1e-10, atol=1e-14)
    rerun = run_both(tmp_path, jcfg, ad, 1, number_timesteps=2, restart=1,
                     nz0=1)
    compare_runs(tmp_path, *rerun)


def cubep3m_inputs(tmp_path, n, sources):
    zreds = [9.0, 8.9, 8.8]
    zfile = tmp_path / "redshifts.dat"
    zfile.write_text(f"{len(zreds)}\n" + "".join(f"{z}\n" for z in zreds))
    rng = np.random.default_rng(0)
    for z in zreds:
        zs = fortran_f6_3(z)
        dens = rng.lognormal(0.0, 0.3, (n, n, n)).astype(np.float32)
        write_stream_cube(str(tmp_path / f"{zs}n_all.dat"), dens, np.float32)
        (tmp_path / f"{zs}-coarsest_sources.dat").write_text(sources)

    def make(mod, cfg):
        return mod.cubep3m_adapter(cfg, boxsize=cfg.boxsize_mpc_h, n_box=64,
                                   redshift_file=str(zfile),
                                   id_str="coarsest",
                                   dir_dens=str(tmp_path) + "/",
                                   dir_src=str(tmp_path) + "/")
    return make


def test_driver_cubep3m_synthetic(tmp_path):
    """Density cubes, source lists and a redshift file in the reference's
    formats, the Iliev et al. UV model with suppression."""
    jcfg = jax_config(mesh=16, dtype="float64", use_lls=False)
    ad = cubep3m_inputs(tmp_path, 16,
                        "2\n8 8 8 50.0 0.0\n4 12 6 20.0 5.0\n")
    run = run_both(tmp_path, jcfg, ad, 2, uv_recipe=0, number_timesteps=2)
    compare_runs(tmp_path, *run)
    x = run[3].xh1.numpy()
    assert x[7, 7, 7] > 0.5 and 0.0 < x.mean() < 1.0
    # the post-suppression source lists, byte for byte
    for z in (9.0, 8.9):
        name = f"{fortran_f6_3(z)}-coarsest_sources_used_wfgamma.dat"
        assert (tmp_path / name).exists()


def test_driver_kitchen_sink(tmp_path):
    """Cosmological scaling, photo-heating, GCM clumping C(z), type-1 LLS
    and an X-ray power-law component through both drivers."""
    from c2ray_tpu.config import SEDConfig
    jcfg = jax_config(mesh=12, dtype="float64", cosmological=True,
                      isothermal=False, initial_temperature=100.0,
                      use_lls=True, type_of_lls=1, lls_model=5,
                      type_of_clumping=2, sed=SEDConfig(use_xray_sed=True))
    (tmp_path / "test_sources.dat").write_text(
        "2\n6 6 6 5e56 2e55\n3 9 4 1e56 0.0\n")
    gcm = np.array([0.6, 0.02, 0.002, 0.0, 0.0, 0.0])
    res = f"{jcfg.dr_comoving / const.MPC:5.3f}"
    write_unformatted_records(str(tmp_path / f"paramsGCM_{res}Mpc.dat"),
                              [gcm.tobytes()])

    def ad(mod, cfg):
        a = mod.test_adapter(cfg, source_dir=str(tmp_path) + "/")
        a.dir_clump = str(tmp_path)
        return a
    run = run_both(tmp_path, jcfg, ad, 2, number_timesteps=2)
    compare_runs(tmp_path, *run)
    pdrv = run[2]
    assert pdrv.clumping_model.evaluate(9.0) == \
        run[0].clumping_model.evaluate(9.0) > 1.0
    assert any(h["lls_loss"] > 0.0 for h in pdrv.history)
    np.testing.assert_allclose([h["lls_loss"] for h in pdrv.history],
                               [h["lls_loss"] for h in run[0].history],
                               rtol=RTOL)
    assert run[3].temper_current[5, 5, 5] > 1e3


def clumping_inputs(tmp_path, cfg, clump_t, lls_t, mesh, sigma):
    """tests/test_round5.py's synthetic clumping and LLS inputs."""
    rng = np.random.default_rng(11)
    res = f"{cfg.dr_comoving / const.MPC:5.3f}"
    if clump_t in (3, 4):
        dcm = np.array([[6.0, 0.05, 0.1, 1.2, 0, 0, 0],
                        [12.0, 0.05, 0.1, 1.2, 0, 0, 0]], np.float64)
        write_unformatted_records(
            str(tmp_path / f"paramsDCM_{res}Mpc.dat"),
            [np.array(dcm.shape, np.int32).tobytes(), dcm.T.tobytes()])
    if clump_t == 4:
        scm = np.zeros((2, 3, 5))
        for iz in range(2):
            scm[iz] = [[np.log(1.3), sigma, 0.0, 0.8, 0.5],
                       [np.log(1.5), 1.5 * sigma, 0.8, 1.5, 1.0],
                       [np.log(1.8), sigma, 1.5, 9.0, 2.0]]
        write_unformatted_records(
            str(tmp_path / f"paramsSCM_{res}Mpc.dat"),
            [np.array(scm.shape, np.int32).tobytes(), scm.T.tobytes()])
    if clump_t == 5:
        cube = 1.0 + rng.random((mesh,) * 3)
        write_stream_cube(str(tmp_path / f"{fortran_f6_3(9.0)}_scat.dat"),
                          cube.astype(np.float32))
    if lls_t == 2:
        cube = rng.random((mesh,) * 3) * 0.1
        write_stream_cube(
            str(tmp_path / f"{fortran_f6_3(9.0)}cross_section_normalized.bin"),
            cube.astype(np.float32))
    (tmp_path / "test_sources.dat").write_text(
        f"2\n{mesh // 2} {mesh // 2} {mesh // 2} 1e56 0.0\n"
        f"{mesh // 4} {mesh // 2} {mesh // 2} 3e55 0.0\n")

    def ad(mod, c):
        a = mod.test_adapter(c, source_dir=str(tmp_path) + "/")
        a.dir_clump = a.dir_lls = str(tmp_path)
        return a
    return ad


@pytest.mark.parametrize("clump_t,lls_t,sigma", [
    (4, 0, 0.0),       # tests/test_round3.py: sigma 0, exp(mu) exactly
    (4, 0, 0.2),       # the threefry draw through the driver
    (3, 0, 0.0),
    (5, 0, 0.0),
    (1, 2, 0.0),       # a type-2 LLS cube from the adapter's files
])
def test_driver_clumping_and_lls_models(tmp_path, clump_t, lls_t, sigma):
    mesh = 10 if clump_t == 4 and sigma == 0.0 else 16
    jcfg = jax_config(mesh=mesh, dtype="float64", use_lls=lls_t == 2,
                      type_of_clumping=clump_t, type_of_lls=max(lls_t, 1),
                      lls_model=1)
    ad = clumping_inputs(tmp_path, jcfg, clump_t, lls_t, mesh, sigma)
    run = run_both(tmp_path, jcfg, ad, 1, number_timesteps=2)
    compare_runs(tmp_path, *run)
    if clump_t == 4 and sigma == 0.0:
        grid = run[2].clumping_model.evaluate(9.0, np.ones((mesh,) * 3), 1.0)
        np.testing.assert_allclose(grid, 1.5, rtol=1e-12)
    if clump_t in (2, 3, 4):
        assert run[2].clumping_model.params_dcm is not None


def test_type2_clumping_loads_at_init(tmp_path):
    jcfg = jax_config(mesh=8, dtype="float64", type_of_clumping=2)
    res = f"{jcfg.dr_comoving / const.MPC:5.3f}"
    gcm = np.array([0.6, 0.02, 0.002, 0.0, 0.0, 0.0])
    write_unformatted_records(str(tmp_path / f"paramsGCM_{res}Mpc.dat"),
                              [gcm.tobytes()])
    cfg = port_cfg(jcfg)
    ad = nbody.test_adapter(cfg, source_dir=str(tmp_path) + "/")
    ad.dir_clump = str(tmp_path)
    drv = C2RayDriver(cfg, adapter=ad, driver_cfg=DriverConfig(
        results_dir=str(tmp_path / "results") + "/"), verbose=False,
        device="cpu")
    c = drv.clumping_model.evaluate(9.0)
    assert abs(c - (0.6 * np.exp(0.02 * 9 + 0.002 * 81) + 1.0)) < 1e-12


def test_memory_lines_in_run_log(tmp_path):
    cfg = port_cfg(jax_config(mesh=8, dtype="float64", use_lls=False))
    (tmp_path / "test_sources.dat").write_text("1\n4 4 4 1e56 0.0\n")
    drv = C2RayDriver(cfg, adapter=nbody.test_adapter(
        cfg, source_dir=str(tmp_path) + "/"), driver_cfg=DriverConfig(
        number_timesteps=2, results_dir=str(tmp_path / "results") + "/"),
        verbose=False, device="cpu")
    drv.run(max_slices=1)
    log = (tmp_path / "results" / "C2Ray.log").read_text()
    mem = [ln for ln in log.splitlines() if "memory:" in ln]
    assert len(mem) >= 2 and "VmRSS" in mem[0]
    timings = (tmp_path / "results" / "Timings.log").read_text()
    assert "Time after iteration 1" in timings
    assert "CPU time" in timings


CLI_CASES = {
    "smoke": [],
    "physics flags": ["--cosmology", "WMAP5", "--rate-eval", "table",
                      "--sweep-backend", "grid", "--compressed-xfrac",
                      "--type-of-lls", "1", "--lls-model", "5"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_against_jax(tmp_path, case):
    (tmp_path / "test_sources.dat").write_text("1\n4 4 4 1e56 0.0\n")
    inp = tmp_path / "input"
    inp.write_text("n\nn\n1\n7\n1\n1\n")
    common = [str(inp), "--mesh", "8", "--dtype", "float64",
              "--source-dir", str(tmp_path) + "/", "--max-slices", "1"]
    common += CLI_CASES[case]
    assert jax_main(common + ["--results-dir",
                              str(tmp_path / "jax") + "/"]) == 0
    assert port_main(common + ["--results-dir", str(tmp_path / "port") + "/",
                               "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert "PhotonCounts2.out" in names
    for name in names:
        if name.startswith("PhotonCounts"):
            np.testing.assert_allclose(
                np.array(photon_rows(tmp_path / "port" / name)),
                np.array(photon_rows(tmp_path / "jax" / name)), rtol=RTOL)
        elif name.startswith("xfrac"):
            np.testing.assert_allclose(
                read_sm3d(str(tmp_path / "port" / name)),
                read_sm3d(str(tmp_path / "jax" / name)), rtol=RTOL)


@pytest.mark.parametrize("flags", [
    ["--layout", "src", "--src-devices", "2"],
    ["--layout", "halo", "--dom-devices", "2"],
    ["--shard-sources", "--src-devices", "2"],
    ["--layout", "dom", "--dom-devices", "2"],
])
def test_cli_multi_device_flags_raise(tmp_path, flags):
    """A layout that asks for more ranks than the run has (one process,
    no C2RAY_* environment) raises; it does not run on fewer."""
    (tmp_path / "input.txt").write_text("n\nn\n1\n7\n2\n1\n")
    with pytest.raises(ValueError, match="rank grid needs 2 ranks, the "
                                         "run has 1"):
        port_main([str(tmp_path / "input.txt"), "--mesh", "8", "--device",
                   "cpu", "--results-dir", str(tmp_path) + "/"] + flags)


def test_cli_needs_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["--mesh", "8", "--results-dir", str(tmp_path) + "/"])
