"""The port's file writers and readers against the JAX package's, on the
CPU: from the same arrays (made from seeds with numpy) both write the
same bytes (Fortran records and subrecord framing, sm3d and stream cubes,
output streams 1-5, PhotonCounts.out and PhotonCounts2.out,
suppressed-source lists, iteration dumps' arrays), and each package reads
the other's files.  Also the import boundary of the new modules."""

import dataclasses
import subprocess
import sys
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.models import sources as jax_sources
from c2ray_tpu.ops.photonstats import PhotonStatistics as JaxStats
from c2ray_tpu.utils import io_fortran as jax_io
from c2ray_tpu.utils.checkpoint import IterDumper as JaxIterDumper
from c2ray_tpu.utils.checkpoint import load_slice_restart as jax_restart
from c2ray_tpu.utils.output import OutputWriter as JaxWriter

from c2ray_tpu_torch.convert import config_from_dict
from c2ray_tpu_torch.models import sources
from c2ray_tpu_torch.ops.photonstats import PhotonStatistics
from c2ray_tpu_torch.state import xh0_of
from c2ray_tpu_torch.utils import io_fortran
from c2ray_tpu_torch.utils.checkpoint import IterDumper, load_slice_restart
from c2ray_tpu_torch.utils.output import OutputWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def test_fortran_records_and_cubes_byte_identical(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    cube = rng.random((6, 5, 7))
    for name, write, args in (
            ("sm3d64", "write_sm3d", (cube, np.float64)),
            ("sm3d32", "write_sm3d", (cube, np.float32)),
            ("stream", "write_stream_cube", (cube, np.float32)),
            ("stream_nohdr", "write_stream_cube", (cube, np.float32, False)),
            ("records", "write_unformatted_records",
             ([b"abc", cube.tobytes(), b""],))):
        p, j = str(tmp_path / f"p_{name}"), str(tmp_path / f"j_{name}")
        getattr(io_fortran, write)(p, *args)
        getattr(jax_io, write)(j, *args)
        assert same_bytes(p, j), name
    # each reads the other's files
    np.testing.assert_array_equal(
        io_fortran.read_sm3d(str(tmp_path / "j_sm3d64"), np.float64,
                             expect_mesh=(6, 5, 7)), cube)
    np.testing.assert_array_equal(
        jax_io.read_sm3d(str(tmp_path / "p_sm3d64"), np.float64), cube)
    np.testing.assert_array_equal(
        io_fortran.read_stream_cube(str(tmp_path / "j_stream"), (6, 5, 7)),
        cube.astype(np.float32))
    assert io_fortran.read_unformatted_records(
        str(tmp_path / "j_records")) == [b"abc", cube.tobytes(), b""]
    # gfortran subrecords past the 2 GiB limit, at a lowered limit
    for mod in (io_fortran, jax_io):
        monkeypatch.setattr(mod, "_SUBRECORD_MAX", 40)
    io_fortran.write_sm3d(str(tmp_path / "p_sub"), cube)
    jax_io.write_sm3d(str(tmp_path / "j_sub"), cube)
    assert same_bytes(str(tmp_path / "p_sub"), str(tmp_path / "j_sub"))
    io_fortran.write_sm3d_stream(str(tmp_path / "p_subs"), (6, 5, 7),
                                 np.float64,
                                 (cube[:, :, k:k + 2] for k in range(0, 7, 2)))
    assert same_bytes(str(tmp_path / "p_subs"), str(tmp_path / "j_sub"))
    np.testing.assert_array_equal(io_fortran.read_sm3d(
        str(tmp_path / "j_sub")), cube)
    np.testing.assert_array_equal(io_fortran.read_sm3d_slab(
        str(tmp_path / "j_sub"), np.float64, (6, 5, 7), 2, 3), cube[2:5])


def writer_pair(tmp_path, **cfg_kw):
    jcfg = jax_config(mesh=8, dtype="float64", **cfg_kw)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    streams = (1, 1, 1, 1, 1)
    pw = OutputWriter(cfg, results_dir=str(tmp_path / "port") + "/",
                      streams=streams)
    jw = JaxWriter(jcfg, results_dir=str(tmp_path / "jax") + "/",
                   streams=streams)
    pw.setup()
    jw.setup()
    return cfg, jcfg, pw, jw


@pytest.mark.parametrize("isothermal", [True, False])
def test_output_streams_byte_identical(tmp_path, isothermal):
    """Streams 1-5 and both PhotonCounts files, from the same arrays (the
    port's as torch tensors, JAX's as jax arrays), byte for byte."""
    cfg, jcfg, pw, jw = writer_pair(tmp_path, isothermal=isothermal)
    rng = np.random.default_rng(1)
    x1, nd, ph, he, t = (rng.random((8, 8, 8)) for _ in range(5))
    t = 1e4 * (1.0 + t)
    z = 8.884
    coords = (np.arange(8) + 0.5) * 1e22
    for w, conv in ((pw, torch.from_numpy), (jw, jnp.asarray)):
        w.write_stream1(z, coords, conv(x1[:, 2, 3]),
                        None if isothermal else conv(t[:, 2, 3]),
                        conv(nd[:, 2, 3]))
        w.write_stream2(z, conv(x1), conv(t))
        w.write_stream3(z, conv(ph), conv(he))
        w.write_stream4(z, conv(x1))
        w.write_stream5(z, conv(nd))
    flags = []
    for w, stats_cls, c, conv in ((pw, PhotonStatistics, cfg,
                                   torch.from_numpy),
                                  (jw, JaxStats, jcfg, jnp.asarray)):
        st = stats_cls(c)
        st.h0_before, st.h0_after, st.totrec = 5e60, 3e60, 4e58
        st.totcollisions, st.dh0, st.total_ion = 1e55, 2e60, 2.04e60
        st.grtotal_ion, st.grtotal_src = 1.9e60, 2.2e60
        for time_, loss in ((0.0, 0.1), (3e13, 0.2), (6e13, 0.01)):
            flags.append(w.write_photonstatistics(
                z, time_, 3e13, st, loss, 0.05, 1.1e4, conv(nd), conv(x1),
                1e66))
        w.close_down()
    assert flags[:3] == flags[3:]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert ("Temper3D_8.884.bin" in names) == (not isothermal)
    assert len(names) == (11 if isothermal else 13)
    for name in names:
        assert same_bytes(tmp_path / "port" / name,
                          tmp_path / "jax" / name), name


def test_suppressed_source_lists_byte_identical(tmp_path):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 999, (20, 3)).astype(np.int32)
    pos[3] = [1200, 5, 5]                # past the Fortran edit descriptor
    flux = 10.0 ** rng.uniform(2, 9, 20)
    p_cat = sources.SourceCatalog(pos, flux, np.zeros(20))
    j_cat = jax_sources.SourceCatalog(pos, flux, np.zeros(20))
    sources.write_suppressed_source_list(str(tmp_path / "p.dat"), p_cat)
    jax_sources.write_suppressed_source_list(str(tmp_path / "j.dat"), j_cat)
    assert same_bytes(tmp_path / "p.dat", tmp_path / "j.dat")
    back = sources.read_suppressed_source_list(str(tmp_path / "j.dat"))
    jback = jax_sources.read_suppressed_source_list(str(tmp_path / "p.dat"))
    np.testing.assert_array_equal(back.srcpos, jback.srcpos)
    np.testing.assert_array_equal(back.normflux_stellar,
                                  jback.normflux_stellar)


def test_iterdump_double_buffer_and_cross_read(tmp_path):
    """iterdump1, iterdump2, iterdump1, ... with JAX's keys and arrays:
    each package loads the other's dumps."""
    d = IterDumper(dump_dir=str(tmp_path), interval_s=0.0)
    g = np.random.default_rng(3).random((4, 4, 4))
    p1 = d.dump(3, 0.5, torch.from_numpy(g), g * 2, g * 3)
    p2 = d.dump(4, 0.6, g, torch.from_numpy(g * 2), g * 3,
                phiheat=g, temper=g * 5, temper_av=g * 6)
    assert p1.endswith("iterdump1.npz") and p2.endswith("iterdump2.npz")
    assert d.maybe_dump(5, 0.7, g, g, g).endswith("iterdump1.npz")
    late = IterDumper(dump_dir=str(tmp_path))     # 15 minutes not passed
    assert late.maybe_dump(6, 0.7, g, g, g) is None
    loaded = JaxIterDumper.load(str(tmp_path), 2)
    assert int(loaded["niter"]) == 4
    np.testing.assert_array_equal(loaded["xh_av"], g * 2)
    np.testing.assert_array_equal(loaded["temper_av"], g * 6)
    jd = JaxIterDumper(dump_dir=str(tmp_path / "j"), interval_s=0.0)
    (tmp_path / "j").mkdir()
    jd.dump(4, 0.6, jnp.asarray(g), jnp.asarray(g * 2), jnp.asarray(g * 3),
            jnp.asarray(g), jnp.asarray(g * 5), jnp.asarray(g * 6))
    mine = IterDumper.load(str(tmp_path / "j"), 1)
    assert sorted(mine) == sorted(loaded)
    for key in loaded:
        np.testing.assert_array_equal(mine[key], loaded[key])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_slice_restart_reads_jax_output(tmp_path, dtype):
    """load_slice_restart of a cube JAX wrote, dense and compressed
    (encoded from the float64 cube before the cast: the neutral tail
    survives, a saturated cell stays ionized), equal to JAX's."""
    cube = np.full((4, 4, 4), 2e-4)
    cube[0, 0, 0] = 1.0 - 1e-10
    cube[1, 1, 1] = 1.0
    cube[2, 2, 2] = 0.7
    t = np.random.default_rng(4).uniform(1e2, 1e4, (4, 4, 4))
    for comp in (False, True):
        jcfg = jax_config(mesh=4, dtype=dtype, use_lls=False,
                          compressed_xfrac=comp, isothermal=False)
        cfg = config_from_dict(dataclasses.asdict(jcfg))
        jw = JaxWriter(jcfg, results_dir=str(tmp_path) + "/")
        jw.write_stream2(8.5, jnp.asarray(cube), jnp.asarray(t))
        got = load_slice_restart(cfg, str(tmp_path) + "/", 8.5, device="cpu")
        ref = jax_restart(jcfg, str(tmp_path) + "/", 8.5)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if comp:
            x0 = xh0_of(got.xh1).double().numpy()
            assert x0[0, 0, 0] == pytest.approx(1e-10, rel=1e-6)
            assert x0[1, 1, 1] == 0.0


NEW_MODULES = ["c2ray_tpu_torch.__main__", "c2ray_tpu_torch.driver",
               "c2ray_tpu_torch.models.clumping",
               "c2ray_tpu_torch.models.nbody",
               "c2ray_tpu_torch.models.sources",
               "c2ray_tpu_torch.utils.io_fortran",
               "c2ray_tpu_torch.utils.output",
               "c2ray_tpu_torch.utils.checkpoint",
               "c2ray_tpu_torch.utils.clocks",
               "c2ray_tpu_torch.utils.report_memory",
               "c2ray_tpu_torch.parallel.multihost",
               "c2ray_tpu_torch.parallel.layout",
               "c2ray_tpu_torch.parallel.source_shard",
               "c2ray_tpu_torch.parallel.domain",
               "c2ray_tpu_torch.parallel.launch",
               "c2ray_tpu_torch.ops.sweep_sharded"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_leave_jax_out(module):
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'c2ray_tpu' or "
            "m.startswith('c2ray_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
