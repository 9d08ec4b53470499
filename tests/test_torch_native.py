"""The port's native reader (c2ray_tpu_torch.native, csrc/io_native.cpp)
against the JAX package's (c2ray_tpu.native) and the port's numpy
readers (the plain versions), byte for byte: density cubes with and
without the mesh header and with empty cells, source catalogs with
Fortran D exponents, short rows, blank lines and more columns than asked
for; a bad mesh header raises.  The reader builds with g++ at first
use."""

import os
import shutil

import numpy as np
import pytest

from c2ray_tpu import native as jax_native

from c2ray_tpu_torch import _build, native
from c2ray_tpu_torch.config import test_problem_config as port_config
from c2ray_tpu_torch.models.nbody import (NbodyAdapter,
                                          read_density_cube_numpy)
from c2ray_tpu_torch.models.sources import (read_source_file,
                                            read_source_file_numpy)
from c2ray_tpu_torch.utils.io_fortran import write_stream_cube


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native reader builds with g++")


def _cube(mesh, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 3.0, mesh).astype(np.float32)
    a[rng.uniform(size=mesh) < 0.1] = 0.0          # empty cells
    a[0, 0, 0] = -1.0
    return a


@pytest.mark.parametrize("header", [True, False])
@pytest.mark.parametrize("mesh", [(12, 12, 12), (5, 7, 9)])
def test_cube_reader_bytes(tmp_path, gxx, header, mesh):
    a = _cube(mesh, seed=sum(mesh) + header)
    path = str(tmp_path / "dens.bin")
    write_stream_cube(path, a, np.float32, header=header)
    conv = 7.3e-3
    got = native.read_cube_f32(path, mesh, header=header, conv=conv,
                               floor_val=0.1 * conv)
    want = jax_native.read_cube_f32(path, mesh, header=header, conv=conv,
                                    floor_val=0.1 * conv)
    plain = read_density_cube_numpy(path, mesh, header, conv)
    assert got.dtype == np.float32 and got.shape == mesh
    assert got.tobytes() == want.tobytes() == plain.tobytes()
    assert np.all(got[a <= 0] == np.float32(0.1 * conv))
    # the writer, byte for byte with the JAX package's
    native.write_cube_f32(str(tmp_path / "p.bin"), got, header=header)
    jax_native.write_cube_f32(str(tmp_path / "j.bin"), got, header=header)
    assert (tmp_path / "p.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()


def test_read_density_goes_through_the_reader(tmp_path, gxx):
    cfg = port_config(mesh=8, dtype="float64")
    ad = NbodyAdapter(cfg, nbody_type="cubep3m",
                      dir_dens=str(tmp_path) + "/")
    path = ad.density_filename(9.0, 0)
    a = _cube(cfg.mesh, seed=3)
    write_stream_cube(path, a, np.float32, header=True)
    got = ad.read_density(9.0, 0)
    conv = ad.density_conversion(9.0)
    want = read_density_cube_numpy(path, cfg.mesh, True, conv)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want.astype(np.float64))


def test_bad_mesh_header_raises(tmp_path, gxx):
    path = str(tmp_path / "bad.bin")
    write_stream_cube(path, _cube((6, 6, 6), 1), np.float32, header=True)
    with open(path, "r+b") as f:
        f.write(np.asarray([6, 6, 5], np.int32).tobytes())
    with pytest.raises(ValueError, match="mesh header"):
        native.read_cube_f32(path, (6, 6, 6))
    with pytest.raises(OSError, match=r"\(-3\)"):
        native.read_cube_f32(path, (6, 6, 7))
    with pytest.raises(OSError, match=r"\(-1\)"):
        native.read_cube_f32(str(tmp_path / "missing.bin"), (6, 6, 6))


CATALOG = """5
  12  3 7  1.5D+05  2.25d-3
4 5 6 7.0E+01

1 2 3 4 5 6 7 8
9\t10 11 1e55 -2.5
"""


@pytest.mark.parametrize("ncols", [5, 3, 8])
def test_catalog_reader_bytes(tmp_path, gxx, ncols):
    path = str(tmp_path / "sources.dat")
    with open(path, "w") as f:
        f.write(CATALOG)
    got = native.read_source_catalog(path, ncols)
    plain = read_source_file_numpy(path, ncols)
    want = jax_native.read_source_catalog(path, ncols)
    assert got.shape == (5, ncols) and got.dtype == np.float64
    assert got.tobytes() == plain.tobytes()
    if want is not None:
        assert got.tobytes() == want.tobytes()
    assert got[0, 2] == 7.0 and got[3, 2] == 3.0   # D exponents, tabs ok
    if ncols > 3:
        assert got[0, 3] == 1.5e5 and got[4, 3] == 1e55
    assert not got[2].any()                        # the blank line
    assert read_source_file(path, ncols).tobytes() == got.tobytes()


def test_catalog_errors_raise(tmp_path, gxx):
    empty = str(tmp_path / "empty.dat")
    open(empty, "w").close()
    with pytest.raises((OSError, IndexError)):
        native.read_source_catalog(empty)
    with pytest.raises(OSError):
        native.read_source_catalog(str(tmp_path / "missing.dat"))


def test_build_is_keyed_and_ignored(gxx):
    _build.build([native.LIBRARY])
    path = _build.library_path(native.LIBRARY)
    assert path.exists() and path.name.startswith("libio_native-")
    assert _build.library_path(native.LIBRARY, ("C2R_OTHER",)) != path
    assert path.parent.name == "_build"
    # the library is built into the git-ignored build directory
    root = os.path.dirname(os.path.dirname(os.path.dirname(path)))
    assert "c2ray_tpu_torch/_build/" in open(
        os.path.join(root, ".gitignore")).read()
