"""The command line (python -m c2ray_tpu_torch) under the parallel
layouts, on the CPU: ranks spawned with the C2RAY_* environment over
gloo (parallel.launch.spawn, one thread each), each running the CLI in
process (parallel.launch.cli_task, as main runs it) with --device cpu.

Held, float64, 16^3, the test N-body adapter, three sources, two
timesteps of one slice:
  * --layout src, --shard-sources, --layout dom --dom-devices 2,
    --layout halo --dom-devices 2 and --layout halo --src-devices 2
    --dom-devices 2 against the serial command line: niter per step
    equal, the final xh1 bitwise, and one set of output files (rank 0
    writes; PhotonCounts holds each row once) whose sm3d cubes and
    PhotonCounts files are byte for byte the serial run's;
  * the per-cell clumping models 3 and 4 under halo (each slab evaluates
    its own rows; type 4's threefry draw takes the cells' global
    counters) against the serial run, bitwise (tests/test_round5.py
    holds the JAX halo layout to its serial run at rtol 1e-12);
  * the halo run against the JAX package's command line under its halo
    layout (1 x 2 on conftest's virtual CPU devices): niter equal, xh1
    within rtol 1e-9.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from c2ray_tpu import constants as jconst
from c2ray_tpu.__main__ import main as jax_main
from c2ray_tpu.config import test_problem_config as jax_config

from c2ray_tpu_torch.parallel.launch import cli_task, spawn
from c2ray_tpu_torch.utils.io_fortran import (read_sm3d,
                                              write_unformatted_records)

N = 16
TASK = "c2ray_tpu_torch.parallel.launch:jobs_task"
HALO = ["--layout", "halo", "--dom-devices", "2"]
RUNS = {  # name: (ranks, layout flags, clumping type)
    "src": (2, ["--layout", "src"], 1),
    "shard": (2, ["--shard-sources"], 1),
    "dom": (2, ["--layout", "dom", "--dom-devices", "2"], 1),
    "halo": (2, HALO, 1),
    "halo22": (4, ["--layout", "halo", "--src-devices", "2",
                   "--dom-devices", "2"], 1),
    "halo-clump3": (2, HALO, 3),
    "halo-clump4": (2, HALO, 4),
}


def _write_inputs(d):
    """The input file, three sources and the clumping parameter files."""
    (d / "input.txt").write_text("n\nn\n1\n7\n2\n1\n")
    (d / "test_sources.dat").write_text(
        f"3\n{N // 2} {N // 2} {N // 2} 1e56 0.0\n"
        f"{N // 4} {N // 2} 3 3e55 0.0\n1 {N} {N - 2} 5e55 0.0\n")
    cfg = jax_config(mesh=N, dtype="float64")
    res = f"{cfg.dr_comoving / jconst.MPC:5.3f}"
    dcm = np.array([[6.0, 0.05, 0.1, 1.2, 0, 0, 0],
                    [12.0, 0.05, 0.1, 1.2, 0, 0, 0]], np.float64)
    write_unformatted_records(str(d / f"paramsDCM_{res}Mpc.dat"),
                              [np.array(dcm.shape, np.int32).tobytes(),
                               dcm.T.tobytes()])
    scm = np.zeros((2, 3, 5))
    for iz in range(2):
        scm[iz] = [[np.log(1.3), 0.2, 0.0, 0.8, 0.5],
                   [np.log(1.5), 0.3, 0.8, 1.5, 1.0],
                   [np.log(1.8), 0.2, 1.5, 9.0, 2.0]]
    write_unformatted_records(str(d / f"paramsSCM_{res}Mpc.dat"),
                              [np.array(scm.shape, np.int32).tobytes(),
                               scm.T.tobytes()])


def _argv(d, name, flags, clump):
    return [str(d / "input.txt"), "--nbody", "test", "--mesh", str(N),
            "--dtype", "float64", "--source-dir", str(d) + "/",
            "--results-dir", str(d / name) + "/", "--clump-dir", str(d),
            "--type-of-clumping", str(clump), "--max-slices", "1"] + flags


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("layouts_cli")
    _write_inputs(d)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as each rank runs
    try:
        out = {}
        groups = {}
        for name, (world, flags, clump) in RUNS.items():
            groups.setdefault(world, []).append(
                (name, ("cli_task", dict(argv=_argv(d, name, flags,
                                                    clump)))))
        with ThreadPoolExecutor(len(groups)) as pool:
            done = {w: pool.submit(spawn, w, TASK,
                                   dict(jobs=[j for _, j in jobs]),
                                   timeout=300)
                    for w, jobs in groups.items()}
            for clump in (1, 3, 4):
                name = f"serial-clump{clump}"
                out[name] = cli_task("cpu", _argv(d, name, [], clump))
            for w, jobs in groups.items():
                res = done[w].result()
                for k, (name, _) in enumerate(jobs):
                    out[name] = [r[k] for r in res]
        out["dir"] = d
        return out
    finally:
        torch.set_num_threads(threads)


def _files(path):
    return sorted(f for f in os.listdir(path) if f != "C2Ray.log"
                  and f != "Timings.log")


@pytest.mark.parametrize("name", [n for n in RUNS if "clump" not in n])
def test_cli_layout_matches_serial_outputs_byte_for_byte(runs, name):
    d = runs["dir"]
    ranks = runs[name]
    ref = runs["serial-clump1"]
    world, flags, _ = RUNS[name]
    assert len(ranks) == world
    kind = "src" if name == "shard" else flags[1]
    assert ranks[0]["describe"].startswith(f"layout {kind}")
    for got in ranks:
        assert got["niter"] == ref["niter"]
        np.testing.assert_array_equal(got["xh1"], ref["xh1"])
    serial_dir, got_dir = d / "serial-clump1", d / name
    names = _files(serial_dir)
    assert _files(got_dir) == names
    assert any(f.startswith("xfrac3D") for f in names)
    assert any(f.startswith("IonRates3D") for f in names)
    for f in names:
        assert (got_dir / f).read_bytes() == (serial_dir / f).read_bytes(), f
    # the run log: rank 0's alone, with the layout's description
    log = (got_dir / "C2Ray.log").read_text()
    assert log.count("layout ") == 1 and "backend gloo" in log


@pytest.mark.parametrize("clump", [3, 4])
def test_halo_percell_clumping_bitwise_to_serial(runs, clump):
    ref = runs[f"serial-clump{clump}"]
    for got in runs[f"halo-clump{clump}"]:
        assert got["niter"] == ref["niter"]
        np.testing.assert_array_equal(got["xh1"], ref["xh1"])
    assert ref["xh1"].max() > 0.5          # the sources ionized their cells


def _niters(log):
    return [int(w.split("=")[1]) for w in log.split() if
            w.startswith("niter=")]


def test_cli_halo_matches_jax_halo_cli(runs, tmp_path):
    """The JAX package's command line with the same arguments (its halo
    layout, 1 x 2, on the virtual devices): niter per step (from the run
    logs) equal, the xh1 cube within rtol 1e-9."""
    d = runs["dir"]
    argv = _argv(d, "halo", HALO, 1)
    at = argv.index("--results-dir")
    argv[at + 1] = str(tmp_path / "jax") + "/"
    jax_main(argv)
    jdir, pdir = tmp_path / "jax", d / "halo"
    assert _niters((pdir / "C2Ray.log").read_text()) == runs["halo"][0][
        "niter"] == _niters((jdir / "C2Ray.log").read_text())
    name = next(f for f in _files(pdir) if f.startswith("xfrac3D"))
    np.testing.assert_allclose(read_sm3d(str(pdir / name), np.float64),
                               read_sm3d(str(jdir / name), np.float64),
                               rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("compressed,isothermal", [(False, True),
                                                   (True, False)])
def test_slice_restart_reads_a_slab(tmp_path, compressed, isothermal):
    """A slice restart under the halo layout reads each rank's rows of the
    xfrac (and temperature) cubes alone: the same values as those rows of
    the whole read, compressed storage included."""
    from c2ray_tpu_torch.config import test_problem_config
    from c2ray_tpu_torch.utils.checkpoint import load_slice_restart
    from c2ray_tpu_torch.utils.output import OutputWriter

    cfg = test_problem_config(mesh=8, dtype="float64",
                              isothermal=isothermal).replace(
        compressed_xfrac=compressed)
    rng = np.random.default_rng(5)
    x = rng.uniform(0.0, 1.0, (8, 8, 8))
    x[0, 0, 0], x[1, 1, 1] = 1.0, 0.9999
    t = None if isothermal else torch.as_tensor(
        rng.uniform(1e3, 1e4, (8, 8, 8)).astype(np.float32))
    OutputWriter(cfg, results_dir=str(tmp_path) + "/").write_stream2(
        9.0, torch.as_tensor(x), t)
    whole = load_slice_restart(cfg, str(tmp_path), 9.0, device="cpu")
    for x0 in (0, 4):
        part = load_slice_restart(cfg, str(tmp_path), 9.0, device="cpu",
                                  rows=(x0, 4))
        for a, b in zip(whole, part):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a[x0:x0 + 4], b)
