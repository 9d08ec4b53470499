"""The port's parallel layouts (c2ray_tpu_torch.parallel) against the
port's serial run and against the JAX package's layouts.

The port's ranks are processes spawned with the C2RAY_* environment and
joined over gloo on the CPU (parallel.launch.spawn, one thread each);
the JAX layouts run in this process on conftest's 8 virtual CPU devices
with the same (n_src, n_dom).  Inputs are made with numpy from a seed;
float64.  The matrix is tests/test_round4.py's scaled to at most four
ranks: src 2, dom 1 x 2, halo 1 x 2 and 2 x 2, each on a full-cube
problem (4 sources, two timesteps) and on an adaptive one (12 sources on
the windowed rungs, one timestep).

Held: against the port's serial run, niter and the rung history equal
and xh1 bitwise (the JAX package's own layouts are bitwise to its serial
run where tests/test_round5.py asserts it and within rtol 1e-12 in
tests/test_parallel.py; the port is bitwise on both problems: each
window and each cell's rates are computed by one rank, and every rate
or per-source sum over ranks is an all_reduce over two ranks, or over
four of which at most two hold a nonzero partial, so it is a + b in
any order); against the JAX layout, niter equal and xh1 within rtol
1e-9.  Also the halo march's columns
against the port's plain march (1e-13), and the plain slab gather and
scatter-add (K4, K5) against the JAX package's XLA windowed-halo path.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import Evolve3D as JaxEvolve3D
from c2ray_tpu import constants as jconst
from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.ops.sweep import SweepScalars as JaxScalars
from c2ray_tpu.ops.sweep import windowed_batch as jax_windowed_batch
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables
from c2ray_tpu.parallel.layout import LayoutRuntime as JaxLayoutRuntime
from c2ray_tpu.parallel.layout import ParallelLayout as JaxParallelLayout
from c2ray_tpu.state import initial_state as jax_initial_state

from c2ray_tpu_torch.convert import config_from_dict, tables_from_numpy
from c2ray_tpu_torch.ops.sweep import (SweepScalars, compute_columns_facemajor,
                                       windowed_batch)
from c2ray_tpu_torch.ops.window_cuda import (fold_padded_acc,
                                             padded_acc_shape,
                                             window_gather)
from c2ray_tpu_torch.parallel.launch import evolve_task, spawn
from c2ray_tpu_torch.parallel.multihost import pick_backend
from c2ray_tpu_torch.parallel.source_shard import pad_sources

N = 16
TASK = "c2ray_tpu_torch.parallel.launch:jobs_task"
LAYOUTS = [("src", 2, 0), ("dom", 1, 2), ("halo", 1, 2), ("halo", 2, 2)]
PROBLEMS = {"full": dict(s=4, adaptive=False, steps=2),
            "adaptive": dict(s=12, adaptive=True, steps=1)}
COLUMN_CASES = [((8, 8, 8), 8), ((0, 3, 15), 8), ((15, 0, 0), 8),
                ((3, 9, 2), 4), ((4, 4, 12), 8)]


def _jax_cfg(adaptive):
    # the full-cube problem's 4 sources march as one batch (one ring
    # exchange a shell under halo)
    cfg = jax_config(mesh=N, dtype="float64", use_lls=False, source_batch=4)
    if adaptive:
        cfg = cfg.replace(adaptive_sweep=True, source_batch=4,
                          adaptive_min_shell=2)
    return cfg


def _inputs(s, seed=3):
    """A lumpy density and 0.3 Myr timesteps; 4 equal sources, or 12 of
    spread fluxes (11 at r = 2 and 1 at r = 4, both windowed)."""
    rng = np.random.default_rng(seed)
    nd = 1.87e-1 * (0.5 + rng.random((N, N, N)))
    pos = rng.integers(0, N, (s, 3)).astype(np.int32)
    nf = np.full(s, 3e9) if s <= 4 else rng.uniform(3e8, 1e10, s)
    return dict(ndens=nd, srcpos=pos, nflux=nf, dt=3e5 * jconst.YEAR,
                dr=3.1e23)


@functools.lru_cache(maxsize=None)
def _tables():
    jt = jax_tables(_jax_cfg(False))
    return jt, {k: np.asarray(v) for k, v in jt._asdict().items()
                if v is not None}


def _port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _job(problem, kind, n_src, n_dom):
    pr = PROBLEMS[problem]
    cfg = _port_cfg(_jax_cfg(pr["adaptive"]))
    return ("evolve_task", dict(cfg=cfg, inputs=_inputs(pr["s"]),
                                steps=pr["steps"], kind=kind, n_src=n_src,
                                n_dom=n_dom, tables=_tables()[1]))


@pytest.fixture(scope="module")
def runs():
    """The port's serial runs in this process, and every layout's on
    spawned ranks: one set of 2 ranks and one of 4, each running its
    layouts' jobs one after the other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as each rank runs
    try:
        out = {}
        for problem in PROBLEMS:
            name, kw = _job(problem, "none", 0, 0)
            out[(problem, "none", 0, 0)] = evolve_task("cpu", **kw)
        cfg = _port_cfg(_jax_cfg(False))
        rng = np.random.default_rng(11)
        ndhi = rng.uniform(1e-4, 3e-4, (N, N, N))
        spawns = {}
        for world in (2, 4):
            lays = [lay for lay in LAYOUTS
                    if lay[1] * (lay[2] or 1) == world]
            jobs = [_job(problem, *lay) for lay in lays
                    for problem in PROBLEMS]
            jobs.append(("halo_columns_task",
                         dict(cfg=cfg, ndhi=ndhi, cases=COLUMN_CASES,
                              n_src=1, n_dom=world)))
            spawns[world] = (lays, jobs)
        # the two sets of ranks at once
        with ThreadPoolExecutor(2) as pool:
            done = {w: pool.submit(spawn, w, TASK, dict(jobs=jobs),
                                   timeout=300)
                    for w, (_, jobs) in spawns.items()}
        for world, (lays, _) in spawns.items():
            res = done[world].result()
            k = 0
            for lay in lays:
                for problem in PROBLEMS:
                    out[(problem,) + lay] = res[0][k]
                    out[(problem,) + lay + ("ranks",)] = [r[k] for r in res]
                    k += 1
            out[("columns", world)] = res[0][k]
        out["ndhi"] = ndhi
        return out
    finally:
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_run(problem, kind, n_src, n_dom):
    pr = PROBLEMS[problem]
    cfg = _jax_cfg(pr["adaptive"])
    inp = _inputs(pr["s"])
    lr = JaxLayoutRuntime(cfg, JaxParallelLayout(kind, n_src, n_dom))
    sol = JaxEvolve3D(cfg, _tables()[0], raytracer=lr.raytracer,
                      chemistry=lr.chemistry, windowed=lr.windowed,
                      rate_sharding=lr.rate_sharding)
    st = lr.shard_state(jax_initial_state(cfg))
    nd = lr.shard_grid(jnp.asarray(inp["ndens"]))
    niter = []
    for _ in range(pr["steps"]):
        st, info = sol.evolve3d(st, nd, inp["dr"], inp["srcpos"],
                                inp["nflux"], inp["dt"])
        niter.append(info.niter)
    return np.asarray(st.xh1), niter


@pytest.mark.parametrize("problem", list(PROBLEMS))
@pytest.mark.parametrize("kind,n_src,n_dom", LAYOUTS)
def test_layout_matches_serial_and_jax(runs, problem, kind, n_src, n_dom):
    ref = runs[(problem, "none", 0, 0)]
    got = runs[(problem, kind, n_src, n_dom)]
    ranks = runs[(problem, kind, n_src, n_dom, "ranks")]
    assert got["describe"].startswith(f"layout {kind}, {n_src or 2} x "
                                      f"{n_dom or 1} ranks")
    assert got["backend"] == "gloo"
    # the port's serial run: the same iterations, the same bits
    assert got["niter"] == ref["niter"]
    assert got["rungs"] == ref["rungs"]
    np.testing.assert_array_equal(got["xh1"], ref["xh1"])
    np.testing.assert_array_equal(got["per_source_loss"],
                                  ref["per_source_loss"])
    # every rank holds the same run
    for r in ranks[1:]:
        assert r["niter"] == got["niter"]
        np.testing.assert_array_equal(r["xh1"], got["xh1"])
    if PROBLEMS[problem]["adaptive"]:
        # the windowed rungs went through the layout's sweeper, and the
        # halo sweeper only at radii within the slab
        assert got["windowed_buckets"], "buckets fell through to sweeps"
        if kind == "halo":
            assert all(r <= N // n_dom for r, _ in got["windowed_buckets"])
    else:
        assert got["comm"]["collectives"] > 0
    if kind == "halo":
        assert got["comm"]["p2p"] > 0       # the ring exchanges ran
    # the JAX package's layout on the same inputs (the adaptive problem
    # for src and halo: each JAX windowed bucket compiles anew, and dom's
    # buckets take the src layout's sweeper, held here under src)
    if not PROBLEMS[problem]["adaptive"] or kind in ("src", "halo"):
        jx, jniter = _jax_run(problem, kind, n_src, n_dom)
        assert got["niter"] == jniter
        np.testing.assert_allclose(got["xh1"], jx, rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_march_columns_match_plain_march(runs, world):
    """The halo march on 2 and 4 slabs (m = 8 and 4 rows, one ring
    exchange per shell) against the port's plain march of the centred
    cube, sources at slab edges and at the periodic wrap, full and capped
    radius: the same arithmetic in another arrangement (the JAX package
    holds its halo march to its face-major march at 1e-13)."""
    cfg = _port_cfg(_jax_cfg(False))
    c = N // 2
    sc = SweepScalars(*[float(v) for v in (2.9e23, 0.0, 0.0, 0.0)])
    ndhi = torch.as_tensor(runs["ndhi"])
    for ((px, py, pz), shells), got in zip(COLUMN_CASES,
                                            runs[("columns", world)]):
        cube = torch.roll(ndhi, (c - px, c - py, c - pz), dims=(0, 1, 2))
        ref = compute_columns_facemajor(cfg, cube, sc, None, shells)
        ref_rows = torch.roll(ref, px - c, dims=0).numpy()
        np.testing.assert_allclose(got, ref_rows, rtol=1e-13, atol=0,
                                   err_msg=f"pos {(px, py, pz)}")


@pytest.mark.parametrize("r,m", [(4, 4)])
def test_slab_window_kernels_plain_match_jax_halo_path(r, m):
    """K4 and K5 on a halo slab, their plain versions (radius = slab
    height, the sweeper's limit): the windows
    gathered from an (m+2r, n+2r, n+2r) padded slab and a batch's rates
    added into the padded slab accumulator, against the JAX package's
    XLA windowed-halo path (windowed_batch with padded_acc=True), windows
    at the slab's first and last rows, at the periodic wrap of axes 1
    and 2, and twice at one cell; then the slab fold of axes 1 and 2."""
    jcfg = jax_config(mesh=N, dtype="float64", use_lls=False,
                      cosmological=False)
    cfg = _port_cfg(jcfg)
    jt, tnp = _tables()
    rng = np.random.default_rng(r * 10 + m)
    ext = rng.uniform(1e-4, 3e-4, padded_acc_shape(N, r, m))
    pos = np.array([[0, 0, 0], [m - 1, N - 1, 5], [m // 2, 3, N - 1],
                    [m // 2, 3, N - 1], [1, 7, 8]], np.int32)
    nf = np.array([1e9, 3e9, 2e9, 5e8, 1e9])
    dr = 2.9e23
    jsc = JaxScalars(dr=jnp.float64(dr),
                     rate_scale=jnp.float64(jcfg.sed.s_star / dr**3),
                     lls_coldens=jnp.float64(0.0),
                     rmax2_cells=jnp.float64(0.0))
    sc = SweepScalars(dr, jcfg.sed.s_star / dr**3, 0.0, 0.0)
    acc0 = np.zeros(padded_acc_shape(N, r, m))
    batch = jax.jit(lambda e, q, f, a: jax_windowed_batch(
        jcfg, jt, e, None, q, f, None, jsc, r, a, jnp.zeros(()),
        padded_acc=True))
    jacc, _, jloss, _, jper = batch(jnp.asarray(ext), jnp.asarray(pos),
                                    jnp.asarray(nf), jnp.asarray(acc0))
    p = 2 * r + 1
    want_wins = np.stack([ext[q0:q0 + p, q1:q1 + p, q2:q2 + p]
                          for q0, q1, q2 in pos])
    ext_t = torch.as_tensor(ext)
    pos_t = torch.as_tensor(pos)
    np.testing.assert_array_equal(window_gather(ext_t, pos_t, r).numpy(),
                                  want_wins)
    acc = torch.zeros(padded_acc_shape(N, r, m), dtype=torch.float64)
    loss, _, per = windowed_batch(
        cfg, tables_from_numpy(tnp, "cpu"), ext_t, pos_t,
        torch.as_tensor(nf), sc, r, acc)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-9,
                               atol=0)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=1e-9)
    # the slab fold: axes 1 and 2 only, as the JAX package's axes=(1, 2)
    from c2ray_tpu.ops.window_pallas import fold_padded_acc as jax_fold
    np.testing.assert_array_equal(
        fold_padded_acc(acc, N, r, axes=(1, 2)).numpy(),
        np.asarray(jax_fold(jnp.asarray(acc.numpy()), N, r, axes=(1, 2))))


def test_pad_sources_is_neutral():
    pos = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    nf = np.array([1.0, 2.0])
    p_pos, p_nf, s = pad_sources(pos, nf, 8)
    assert s == 2 and len(p_nf) == 8 and p_pos.shape == (8, 3)
    assert not p_nf[2:].any() and not p_pos[2:].any()


@pytest.mark.parametrize("devices,want", [
    (["cpu", "cpu"], "gloo"),
    (["cuda:GPU-a", "cuda:GPU-a"], "gloo"),         # ranks share a card
    (["cuda:GPU-a", "cuda:GPU-b"], "nccl"),
    (["cuda:GPU-a"], "nccl"),
    # 2 hosts x 8 cards, world 16: more ranks than one host's cards
    ([f"cuda:GPU-{h}{c}" for h in "ab" for c in range(8)], "nccl"),
    ([f"cuda:GPU-{h}{c % 4}" for h in "ab" for c in range(8)], "gloo"),
    (["cuda:GPU-a", "cpu"], "gloo"),
])
def test_pick_backend_from_every_ranks_device(devices, want):
    """nccl exactly when every rank, on any host, has a card of its own
    (the ranks exchange their device_identity at the rendezvous)."""
    assert pick_backend(devices) == want
