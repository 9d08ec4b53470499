"""The native (C++) readers of density cubes and source catalogs.

The port's twin of c2ray_tpu/native: csrc/io_native.cpp behind ctypes,
with the JAX binding's three functions and signatures.  _build compiles
the library with g++ at first use into c2ray_tpu_torch/_build/, as it
does the CUDA kernels.  A failed build raises, and so does a failed read,
with the C error code; nothing falls back to numpy
(the numpy readers, models.nbody.read_density_cube_numpy and
models.sources.read_source_file_numpy, are the plain versions the tests
hold these against).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build

LIBRARY = "io_native"          # csrc/io_native.cpp
# the C functions' error codes
_READ = {-1: "cannot open", -2: "cannot stat", -4: "mmap failed"}
ERRORS = {"read_cube_f32": {**_READ, -3: "file too short",
                            -5: "mesh header mismatch"},
          "read_source_catalog": {**_READ, -3: "empty file",
                                  -5: "no row count"},
          "write_cube_f32": {-1: "cannot open", -2: "header not written",
                             -3: "data not written"}}

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(LIBRARY)
        i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        lib.read_cube_f32.argtypes = [ctypes.c_char_p, i64, i64, i64,
                                      ctypes.c_int, ctypes.c_double,
                                      ctypes.c_double, f32p]
        lib.read_cube_f32.restype = ctypes.c_int
        lib.write_cube_f32.argtypes = [ctypes.c_char_p, i64, i64, i64,
                                       ctypes.c_int, f32p]
        lib.write_cube_f32.restype = ctypes.c_int
        lib.read_source_catalog.argtypes = [
            ctypes.c_char_p, i64, ctypes.POINTER(ctypes.c_double), i64]
        lib.read_source_catalog.restype = i64
        _lib = lib
    return _lib


def _raise(fn: str, path: str, rc: int):
    raise OSError(f"{fn} {path}: {ERRORS[fn].get(rc, 'error')} ({rc})")


def read_cube_f32(path: str, mesh, header: bool = True, conv: float = 1.0,
                  floor_val: float = 0.0) -> np.ndarray:
    """Read a Fortran-ordered stream cube of float32 (with the 3 x int32
    mesh header when `header`) into C order: out = float32(v * conv) in
    float64, floor_val where v * conv <= 0."""
    n1, n2, n3 = (int(m) for m in mesh)
    out = np.empty((n1, n2, n3), np.float32)
    rc = _load().read_cube_f32(
        os.fsencode(path), n1, n2, n3, int(header), float(conv),
        float(floor_val), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc == -5:
        raise ValueError(f"{path}: mesh header mismatch (expected {mesh}) "
                         f"({rc})")
    if rc != 0:
        _raise("read_cube_f32", path, rc)
    return out


def read_source_catalog(path: str, ncols: int = 5) -> np.ndarray:
    """Parse an ASCII source catalog (the count on the first line, then
    one source a line): (count, ncols) float64; short rows and blank lines
    pad with zeros, extra columns are dropped, Fortran D exponents read."""
    with open(path) as f:
        n = int(f.readline().split()[0])
    out = np.zeros((n, ncols), np.float64)
    got = _load().read_source_catalog(
        os.fsencode(path), ncols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
    if got < 0:
        _raise("read_source_catalog", path, got)
    if got != n:
        raise OSError(f"read_source_catalog {path}: {got} of {n} rows")
    return out


def write_cube_f32(path: str, data: np.ndarray, header: bool = True) -> None:
    """Write a C-ordered cube as float32 in Fortran order (with the mesh
    header when `header`)."""
    a = np.ascontiguousarray(data, np.float32)
    rc = _load().write_cube_f32(
        os.fsencode(path), a.shape[0], a.shape[1], a.shape[2], int(header),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        _raise("write_cube_f32", path, rc)
