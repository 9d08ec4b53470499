"""Start the ranks of a layout on one machine, and the task most runs
give them: a few evolve3d timesteps under a layout.

spawn(world, "module:function", kwargs) starts `world` Python processes
with the C2RAY_* environment (a free localhost port as the coordinator),
each of which joins the process group (multihost.init_distributed on
its device: cpu, or cuda:{rank % cards}), calls function(**kwargs) and
hands its result back; the parent waits for all of them, and raises with
a rank's error output if any fails or the time runs out (every child is
killed then).

evolve_task runs Evolve3D.evolve3d under a layout (or none) on inputs
made on the host: the same ndens, sources and timesteps for a serial run
and every layout, so their results compare.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np


def spawn(world: int, task: str, kwargs: dict, device: str = "cpu",
          threads: int = 1, timeout: float = 600.0,
          backend: Optional[str] = None):
    """Run task ("module:function") on `world` ranks -> [each rank's
    return value].  The ranks import this copy of the package (its root
    goes first on their PYTHONPATH)."""
    from .multihost import free_port

    tmp = tempfile.mkdtemp(prefix="c2ray_ranks_")
    job = os.path.join(tmp, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump(dict(task=task, kwargs=kwargs, device=device,
                         threads=threads), f)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    port = free_port()
    procs = []
    try:
        for r in range(world):
            e = dict(os.environ, PYTHONPATH=path,
                     C2RAY_COORDINATOR=f"localhost:{port}",
                     C2RAY_NUM_PROCESSES=str(world),
                     C2RAY_PROCESS_ID=str(r), C2RAY_RANK_JOB=job,
                     OMP_NUM_THREADS=str(threads))
            if backend:
                e["C2RAY_BACKEND"] = backend
            log = open(os.path.join(tmp, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c",
                 "from c2ray_tpu_torch.parallel.launch import _child; "
                 "_child()"], env=e, stdout=log, stderr=subprocess.STDOUT),
                log))
        t_end = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad or None not in codes or time.monotonic() > t_end:
                break
            time.sleep(0.05)
        if not bad and None not in codes:
            out = []
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        which = bad[0] if bad else 0
        procs[which][1].flush()
        with open(os.path.join(tmp, f"rank{which}.log")) as f:
            text = f.read()
        why = (f"rank {which} exited {codes[which]}" if bad
               else f"timed out after {timeout} s")
        raise RuntimeError(f"{task} on {world} ranks: {why}\n{text[-6000:]}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def _child() -> None:
    """A rank's entry point (spawn): join, run the task, save its result."""
    import importlib

    import torch

    from . import multihost as mh

    job = os.environ["C2RAY_RANK_JOB"]
    with open(job, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(spec["threads"])
    device = mh.rank_device(spec["device"])
    mh.init_distributed(device=device)
    mod, fn = spec["task"].split(":")
    result = getattr(importlib.import_module(mod), fn)(
        device=str(device), **spec["kwargs"])
    with open(os.path.join(os.path.dirname(job),
                           f"rank{mh.process_index()}.pkl"), "wb") as f:
        pickle.dump(result, f)
    mh.sync()
    torch.distributed.destroy_process_group()


def evolve_task(device: str, cfg, inputs: dict, steps: int, kind: str = "none",
                n_src: int = 0, n_dom: int = 0, whole: bool = True,
                timed: bool = False, tables: Optional[dict] = None) -> dict:
    """evolve3d timesteps under a layout.  inputs: host numpy arrays and
    floats (ndens, srcpos, nflux, dt, dr; optionally xh1, the starting
    ionized fraction, clumping, lls_grid, nflux_xray, lls_coldens).
    tables: the rate tables as numpy arrays (convert.tables_from_numpy),
    else built here.  -> per step niter, rungs and mean_xh1, the
    per-source losses and photon statistics of the last step, the xh1
    grid gathered whole (whole=True; on every rank), the kernel launches
    and, with timed, the seconds of each step (a CUDA sync before each
    clock read) and the rank grid's collective counts."""
    import torch

    from ..ops import sweep_cuda, window_cuda
    from ..ops.photonstats import PhotonStatistics
    from ..ops.tables import build_rad_tables
    from ..solver import Evolve3D
    from ..state import initial_state
    from .layout import LayoutRuntime, ParallelLayout, replicate_to_host

    dev = torch.device(device)
    lay = LayoutRuntime(cfg, ParallelLayout(kind, n_src, n_dom), dev)
    if tables is not None:
        from ..convert import tables_from_numpy
        tables = tables_from_numpy(tables, dev)
    else:
        tables = build_rad_tables(cfg, device=dev)
    solver = Evolve3D(cfg, tables, dev, raytracer=lay.raytracer,
                      chemistry=lay.chemistry, windowed=lay.windowed,
                      rate_sharding=lay.rate_sharding)
    dtype = cfg.torch_dtype

    def grid(key):
        x = inputs.get(key)
        if x is None or not isinstance(x, np.ndarray) or x.ndim != 3:
            return x
        return lay.shard_grid(torch.as_tensor(x, dtype=dtype, device=dev))

    ndens = grid("ndens")
    state = lay.shard_state(initial_state(cfg, device=dev))
    if "xh1" in inputs:                     # a starting ionized fraction
        state = state._replace(xh1=grid("xh1"))
    stats = PhotonStatistics(cfg)
    for d in (sweep_cuda.LAUNCHES, window_cuda.LAUNCHES):
        for k in d:
            d[k] = 0
    if lay.grid is not None:
        lay.grid.reset_stats()
    out = dict(niter=[], rungs=[], mean_xh1=[], seconds=[],
               describe=lay.describe())
    for _ in range(steps):
        if timed and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, info = solver.evolve3d(
            state, ndens, inputs["dr"], inputs["srcpos"], inputs["nflux"],
            inputs["dt"], clumping=grid("clumping") if "clumping" in inputs
            else 1.0, lls_coldens=inputs.get("lls_coldens", 0.0),
            lls_grid=grid("lls_grid"), nflux_xray=inputs.get("nflux_xray"),
            stats=stats)
        if timed and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["seconds"].append(time.perf_counter() - t0)
        out["niter"].append(info.niter)
        out["rungs"].append(info.rungs)
        out["mean_xh1"].append(info.mean_xh1)
    out["per_source_loss"] = info.per_source_loss
    out["photon_stats"] = info.photon_stats
    if whole:
        out["xh1"] = replicate_to_host(state.xh1, lay)
    out["launches"] = dict(sweep_cuda.LAUNCHES, **window_cuda.LAUNCHES)
    if lay.grid is not None:
        out["comm"] = dict(lay.grid.stats)
        out["backend"] = lay.grid.backend
    if lay.windowed is not None:
        out["windowed_buckets"] = dict(lay.windowed._cache)
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def cli_task(device: str, argv, max_slices=None, whole: bool = True) -> dict:
    """The command line (python -m c2ray_tpu_torch argv) run in this
    process, as main runs it.  -> per step niter, rungs and mean_xh1, the
    final xh1 gathered whole (whole=True), the kernel launches and the
    layout's description."""
    from ..__main__ import build_driver
    from ..ops import sweep_cuda, window_cuda
    from .layout import replicate_to_host

    for d in (sweep_cuda.LAUNCHES, window_cuda.LAUNCHES):
        for k in d:
            d[k] = 0
    driver, slices = build_driver(list(argv) + ["--device", device])
    state = driver.run(max_slices=max_slices or slices)
    lay = driver.layout
    out = dict(niter=[h["niter"] for h in driver.history],
               rungs=[h["rungs"] for h in driver.history],
               mean_xh1=[h["mean_xh1"] for h in driver.history],
               seconds=[h["wall_end"] - h["wall_start"]
                        for h in driver.history],
               describe=lay.describe(),
               launches=dict(sweep_cuda.LAUNCHES, **window_cuda.LAUNCHES))
    if whole:
        out["xh1"] = replicate_to_host(driver._x1_dev(state), lay)
    if lay.grid is not None:
        out["comm"] = dict(lay.grid.stats)
    if driver.device.type == "cuda":
        import torch
        out["peak_bytes"] = torch.cuda.max_memory_allocated(driver.device)
    return out


def halo_columns_task(device: str, cfg, ndhi: np.ndarray, cases,
                      n_src: int, n_dom: int) -> list:
    """The halo march's columns (ops.sweep_sharded.compute_columns_slab)
    of each (position, max_shell) case on this rank grid's slabs,
    gathered whole: -> [(n, n, n) column cube, grid rows in order, axes
    1, 2 centred on the source]."""
    import torch

    from ..ops.sweep import sweep_scalars
    from ..ops.sweep_sharded import compute_columns_slab
    from .domain import slab_rows_of
    from .multihost import RankGrid

    grid = RankGrid(n_src, n_dom, device)
    n = cfg.mesh[0]
    c = n // 2
    x0, m = slab_rows_of(grid, n)
    sc = sweep_scalars(cfg, 2.9e23)
    nd = torch.as_tensor(ndhi, device=device)[x0:x0 + m]
    out = []
    for (px, py, pz), shells in cases:
        nd_c = torch.roll(nd, (c - py, c - pz), dims=(1, 2))
        cdo = compute_columns_slab(cfg, nd_c[None], sc, None, shells, [px],
                                   x0, grid)[0]
        out.append(grid.gather(cdo, "dom").cpu().numpy())
    return out


def jobs_task(device: str, jobs) -> list:
    """Several tasks in one set of ranks (one process start): jobs is a
    list of (function name in this module, kwargs)."""
    return [globals()[name](device=device, **kw) for name, kw in jobs]
