"""Build the port's CUDA kernels at first use.

Each source csrc/<name>.cu compiles with nvcc into its own shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds).  Libraries go to c2ray_tpu_torch/_build/, keyed by
a hash of the source and the flags; sources build in parallel, one nvcc
process each.  A failed build raises.  A variant build adds preprocessor
defines (-D) to one source; it is keyed by them too, and only measurement
code asks for one.
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
KERNELS = ("march", "consume", "window")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

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


def _spec(spec) -> tuple:
    """A kernel name, or (name, defines) for a variant build."""
    return (spec, ()) if isinstance(spec, str) else (spec[0], tuple(spec[1]))


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines=()) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    flags = " ".join(_flags(defines)).encode()
    key = hashlib.sha256(src + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(specs=KERNELS) -> dict:
    """Compile every kernel library in specs (a name, or (name, defines))
    whose library is missing, all nvcc runs started together.  Returns
    {label: compiler log (ptxas -v)}."""
    todo = [_spec(sp) for sp in specs]
    todo = [(nm, dfs) for nm, dfs in todo
            if not library_path(nm, dfs).exists()]
    logs = {}
    if not todo:
        return logs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for nm, dfs in todo:
        label = nm + "".join(f" -D{d}" for d in dfs)
        tmp = library_path(nm, dfs).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(dfs), "-o", str(tmp), str(SRC_DIR / f"{nm}.cu")]
        procs[label] = (library_path(nm, dfs), tmp,
                        subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    failed = []
    for label, (path, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[label] = out
        if proc.returncode != 0:
            failed.append(f"--- {label} (nvcc exit {proc.returncode}) ---\n"
                          f"{out}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of kernel `name` (built with `defines`), built
    first if needed."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        build([key])
        lib = ctypes.CDLL(str(library_path(*key)))
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
