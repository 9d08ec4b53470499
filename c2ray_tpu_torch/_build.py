"""Build the port's CUDA kernels at first use.

Each source csrc/<name>.cu compiles with nvcc into its own shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds).  Libraries go to c2ray_tpu_torch/_build/, keyed by
a hash of the source and the flags; sources build in parallel, one nvcc
process each.  A failed build raises.
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


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names=KERNELS) -> dict:
    """Compile every named kernel whose library is missing, all nvcc runs
    started together.  Returns {name: compiler log (ptxas -v)}."""
    todo = [nm for nm in names if not library_path(nm).exists()]
    logs = {}
    if not todo:
        return logs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for nm in todo:
        tmp = library_path(nm).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{nm}.cu")]
        procs[nm] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    failed = []
    for nm, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[nm] = out
        if proc.returncode != 0:
            failed.append(f"--- {nm}.cu (nvcc exit {proc.returncode}) ---\n"
                          f"{out}")
            continue
        os.replace(tmp, library_path(nm))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.c2r_error_string.argtypes = [ctypes.c_int]
        lib.c2r_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def timed_build() -> tuple:
    """Build all kernels; returns (seconds, {name: compiler log})."""
    t0 = time.perf_counter()
    logs = build(KERNELS)
    return time.perf_counter() - t0, logs
