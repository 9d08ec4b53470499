"""Build the port's native libraries at first use.

Each CUDA source csrc/<name>.cu compiles with nvcc into its own shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds); the one C++ source, csrc/io_native.cpp (the
native reader), compiles with g++ the same way.  Libraries go to
c2ray_tpu_torch/_build/, keyed by a hash of the source, the shared CUDA
headers (csrc/*.cuh, for the .cu sources) and the flags, written to a
temporary file and moved into place, so several processes may build at
once; sources build in parallel, one compiler process each.  A failed
build raises.  A variant build adds preprocessor defines (-D) to one
source and is keyed by them too: the float64 and table-rate builds
(ops/sweep_cuda.build_for names them) and the timing builds that only
measurement code asks for.  Each build is compiled at its first use, so a
run builds only what it launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("march", "consume", "window", "window_sweep", "chemistry",
           "loop_graph")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_loaded: dict = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "c2ray_tpu_torch build on a machine with the "
                           "CUDA toolkit")
    return found


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native reader of "
                           "c2ray_tpu_torch builds with g++")
    return found


def _source(name: str) -> Path:
    """csrc/<name>.cu, or csrc/<name>.cpp for a C++ library."""
    cu = SRC_DIR / f"{name}.cu"
    return cu if cu.exists() else SRC_DIR / f"{name}.cpp"


def _is_cuda(name: str) -> bool:
    return _source(name).suffix == ".cu"


def _spec(spec) -> tuple:
    """A kernel name, or (name, defines) for a variant build."""
    return (spec, ()) if isinstance(spec, str) else (spec[0], tuple(spec[1]))


def _flags(name: str, defines=()) -> tuple:
    return ((NVCC_FLAGS if _is_cuda(name) else CXX_FLAGS)
            + tuple(f"-D{d}" for d in defines))


def library_path(name: str, defines=()) -> Path:
    src = _source(name).read_bytes()
    if _is_cuda(name):
        src += b"".join(h.read_bytes()
                        for h in sorted(SRC_DIR.glob("*.cuh")))
    flags = " ".join(_flags(name, defines)).encode()
    key = hashlib.sha256(src + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(specs=KERNELS) -> dict:
    """Compile every library in specs (a name, or (name, defines)) whose
    library is missing, all compiler runs started together.  Returns
    {label: compiler log (ptxas -v for the CUDA ones)}."""
    todo = [_spec(sp) for sp in specs]
    todo = [(nm, dfs) for nm, dfs in todo
            if not library_path(nm, dfs).exists()]
    logs = {}
    if not todo:
        return logs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for nm, dfs in todo:
        label = nm + "".join(f" -D{d}" for d in dfs)
        tmp = library_path(nm, dfs).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path() if _is_cuda(nm) else gxx_path(),
               *_flags(nm, dfs), "-o", str(tmp), str(_source(nm))]
        procs[label] = (library_path(nm, dfs), tmp,
                        subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    failed = []
    for label, (path, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[label] = out
        if proc.returncode != 0:
            failed.append(f"--- {label} ({Path(proc.args[0]).name} exit "
                          f"{proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return logs


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library `name` (built with `defines`), built first if
    needed."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        build([key])
        lib = ctypes.CDLL(str(library_path(*key)))
        if _is_cuda(name):
            lib.c2r_error_string.argtypes = [ctypes.c_int]
            lib.c2r_error_string.restype = ctypes.c_char_p
        _loaded[key] = lib
    return lib


def timed_build(variants=()) -> tuple:
    """Build all kernels and the given variant builds together; returns
    (seconds, {label: compiler log})."""
    t0 = time.perf_counter()
    logs = build(KERNELS + tuple(variants))
    return time.perf_counter() - t0, logs
