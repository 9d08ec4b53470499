"""The port's device-resident convergence loop (Evolve3D's device loop) on
the CPU: against the JAX package's _evolve_device_loop on the same inputs
(made with numpy from a seed), against the port's own host loop
(on_device_loop=False, bitwise), the choice between the two loops case by
case in both packages, the dump after the loop, an iteration restart
followed by the loop, the max_global_iterations cap, and the launch
counts of the captured form (its graph emulated on the CPU)."""

import dataclasses
import functools
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.config import SEDConfig as JaxSED
from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.ops.photonstats import PhotonStatistics as JaxStats
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables
from c2ray_tpu.ops.thermal import setup_cool as jax_setup_cool
from c2ray_tpu.solver import Evolve3D as JaxEvolve3D
from c2ray_tpu.state import initial_state as jax_initial_state

import c2ray_tpu_torch as port
from c2ray_tpu_torch import cuda_graph
from c2ray_tpu_torch.convert import (config_from_dict, cooling_from_numpy,
                                     tables_from_numpy)
from c2ray_tpu_torch.ops import chemistry_cuda
from c2ray_tpu_torch.ops.photonstats import PhotonStatistics

torch.set_num_threads(2)

N = 32
DT = 3.0e13
DR = 4.4e23
ZRED = 9.0

# name -> the variant's options
VARIANTS = {
    "iso": dict(),
    "non-iso": dict(isothermal=False),
    "compressed": dict(compressed_xfrac=True),
    "grid-lls-xray": dict(type_of_lls=2, sed=JaxSED(use_xray_sed=True)),
}


class Recorder:
    """A Clocks and an IterDumper in one: records the stamps' labels and
    every maybe_dump's arguments on the host, writes nothing.  enabled
    False: the choice rule never waits for its dump."""

    enabled = False
    interval_s = 900.0

    def __init__(self):
        self._last_wall = time.time()
        self.labels = []
        self.dumps = []

    def stamp(self, label):
        self.labels.append(label)

    def maybe_dump(self, niter, photon_loss, phih, xh_av, xh_intermed,
                   phiheat=None, temper=None, temper_av=None):
        host = (lambda x: None if x is None else np.array(
            x.numpy() if isinstance(x, torch.Tensor) else x))
        self.dumps.append(dict(
            niter=int(niter), photon_loss=float(photon_loss),
            phih=host(phih), xh_av=host(xh_av), xh_intermed=host(xh_intermed),
            phiheat=host(phiheat), temper=host(temper),
            temper_av=host(temper_av)))


def _solvers(mesh=N, **kw):
    """The JAX and the port's Evolve3D on identical configuration, rate
    tables and (non-isothermal) cooling table: f64, expsum rates, LLS."""
    opts = dict(dtype="float64", use_lls=True, type_of_lls=1,
                cosmological=False, rate_eval="expsum", source_batch=2)
    opts.update(kw)
    jcfg = jax_config(mesh=mesh, **opts)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    jtabs = jax_tables(jcfg)
    ptabs = tables_from_numpy({k: np.asarray(v) for k, v in
                               jtabs._asdict().items()}, "cpu")
    if jcfg.isothermal:
        return jcfg, cfg, (lambda: JaxEvolve3D(jcfg, jtabs),
                           lambda c=cfg: port.Evolve3D(c, ptabs,
                                                       device="cpu"))
    jcool = jax_setup_cool(jcfg)
    pcool = cooling_from_numpy({"cie_cool": np.asarray(jcool.cie_cool),
                                "mintemp": jcool.mintemp,
                                "dtemp": jcool.dtemp}, "cpu")
    return jcfg, cfg, (lambda: JaxEvolve3D(jcfg, jtabs, cool=jcool),
                       lambda c=cfg: port.Evolve3D(c, ptabs, device="cpu",
                                                   cool=pcool))


def _problem(cfg, mesh=N, seed=21):
    rng = np.random.default_rng(seed)
    ndens = rng.uniform(1.5e-4, 2.5e-4, (mesh,) * 3)
    srcpos = rng.integers(0, mesh, (3, 3)).astype(np.int32)
    srcpos[0] = [0, mesh - 1, 5]                 # a periodic corner
    nflux = 10.0 ** rng.uniform(5.5, 6.5, 3)
    kw = dict(lls_coldens=1e17)
    if cfg.type_of_lls == 2:
        sigma = rng.lognormal(0.0, 0.5, (mesh,) * 3)
        raw = port.set_lls(cfg, ZRED, DR, sigma)
        kw["lls_grid"] = raw.grid * (1e17 / raw.coldensh_lls)
    if cfg.sed.use_xray_sed:
        kw["nflux_xray"] = 0.3 * nflux * rng.uniform(0.5, 2.0, 3)
    if not cfg.isothermal:
        kw["cosmo_cool_coeff"] = 1e-17
    return ndens, srcpos, nflux, kw


def _run(make, state, ndens, srcpos, nflux, kw, steps=2, jax=False,
         stats=None, restart=None):
    """`steps` timesteps of one solver with photon statistics, a Recorder
    as clocks and dumper; -> (state, infos, recorders)."""
    solver = make()
    infos, recs = [], []
    for i in range(steps):
        rec = Recorder()
        opts = dict(kw)
        if jax:
            opts = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                    for k, v in opts.items()}
            nd = jnp.asarray(ndens)
        else:
            if "lls_grid" in opts:
                opts["lls_grid"] = torch.from_numpy(opts["lls_grid"])
            nd = torch.from_numpy(ndens)
        state, info = solver.evolve3d(
            state, nd, DR, srcpos, nflux, DT, stats=stats, clocks=rec,
            dumper=rec, iter_restart=restart if i == 0 else None, **opts)
        infos.append(info)
        recs.append(rec)
    return state, infos, recs


def _spy(monkeypatch, cls):
    calls = []
    orig = cls._evolve_device_loop

    def spy(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(cls, "_evolve_device_loop", spy)
    return calls


@functools.lru_cache(maxsize=None)
def _runs(variant):
    """Two timesteps of JAX's device loop, the port's device loop and the
    port's host loop on the variant's inputs."""
    mp = pytest.MonkeyPatch()
    try:
        jcfg, cfg, (jmake, pmake) = _solvers(**VARIANTS[variant])
        ndens, srcpos, nflux, kw = _problem(cfg)
        jcalls = _spy(mp, JaxEvolve3D)
        pcalls = _spy(mp, port.Evolve3D)
        jax_run = _run(jmake, jax_initial_state(jcfg), ndens, srcpos, nflux,
                       kw, jax=True, stats=JaxStats(jcfg))
        dev = _run(pmake, port.initial_state(cfg, device="cpu"), ndens,
                   srcpos, nflux, kw, stats=PhotonStatistics(cfg))
        assert len(jcalls) == 2 and len(pcalls) == 2, (jcalls, pcalls)
        hcfg = cfg.replace(on_device_loop=False)
        host = _run(lambda: pmake(hcfg), port.initial_state(hcfg, device="cpu"),
                    ndens, srcpos, nflux, kw, stats=PhotonStatistics(hcfg))
        assert len(pcalls) == 2
    finally:
        mp.undo()
    return dict(jax=jax_run, dev=dev, host=host, cfg=cfg,
                flux=float(nflux.sum() + kw.get("nflux_xray",
                                                np.zeros(1)).sum()))


def _fields(state, iso):
    names = ["xh1"] + ([] if iso else ["temper_current", "temper_av",
                                        "temper_intermed"])
    return {n: np.asarray(getattr(state, n)) for n in names}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_device_loop_matches_jax_device_loop(variant):
    """niter and conv_flag exact; xh1 and T, the photon reports and the
    per-source losses at rtol 1e-9; the Timings labels equal."""
    r = _runs(variant)
    (jstate, jinfos, jrecs), (pstate, pinfos, precs) = r["jax"], r["dev"]
    for ji, pi, jr, pr in zip(jinfos, pinfos, jrecs, precs):
        assert pi.niter == ji.niter
        assert pi.conv_flag == ji.conv_flag
        assert pi.converged == ji.converged
        assert pi.mean_xh1 == pytest.approx(ji.mean_xh1, rel=1e-9)
        np.testing.assert_allclose(pi.per_source_loss, ji.per_source_loss,
                                   rtol=1e-9, atol=1e-12 * r["flux"])
        assert set(pi.photon_stats) == set(ji.photon_stats)
        for key, v in ji.photon_stats.items():
            assert pi.photon_stats[key] == pytest.approx(
                v, rel=1e-9, abs=1e-12), key
        assert pr.labels == jr.labels
        assert len(pr.labels) == pi.niter
    iso = r["cfg"].isothermal
    want, got = _fields(jstate, iso), _fields(pstate, iso)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-9, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_device_loop_equals_host_loop(variant):
    """The port's two loops run the same iterations on the same ops: the
    same state bits, niter, conv_flag, reports and Timings labels."""
    r = _runs(variant)
    (dstate, dinfos, drecs), (hstate, hinfos, hrecs) = r["dev"], r["host"]
    for name in ("xh1", "temper_current", "temper_av", "temper_intermed"):
        d, h = getattr(dstate, name), getattr(hstate, name)
        assert (d is None) == (h is None)
        if d is not None:
            assert torch.equal(d, h), name
    for di, hi, dr, hr in zip(dinfos, hinfos, drecs, hrecs):
        assert (di.niter, di.conv_flag, di.converged) == \
            (hi.niter, hi.conv_flag, hi.converged)
        assert di.photon_stats == hi.photon_stats
        assert np.array_equal(di.per_source_loss, hi.per_source_loss)
        assert torch.equal(di.phih, hi.phih)
        assert dr.labels == hr.labels


@pytest.mark.parametrize("variant", ["iso", "non-iso"])
def test_dump_after_loop_carries_last_pre_chemistry_iterates(variant):
    """The device loop offers the dumper one dump, after the loop, with
    the last iteration's post-sweep, pre-chemistry iterates and rate
    grids: the host loop's last offer, bit for bit."""
    r = _runs(variant)
    for drec, hrec in zip(r["dev"][2], r["host"][2]):
        assert len(drec.dumps) == 1
        assert len(hrec.dumps) > 1
        d, h = drec.dumps[0], hrec.dumps[-1]
        assert d.keys() == h.keys()
        for key in d:
            if isinstance(d[key], np.ndarray):
                assert np.array_equal(d[key], h[key]), key
            else:
                assert d[key] == h[key], key
        assert not np.array_equal(d["xh_intermed"],
                                  hrec.dumps[-2]["xh_intermed"])


def test_iter_restart_then_device_loop():
    """A step resumed from an iteration dump runs its pending chemistry
    pass first, then the device loop: the host loop's bits, and JAX's
    device loop at rtol 1e-9 with niter exact."""
    jcfg, cfg, (jmake, pmake) = _solvers(mesh=16, isothermal=False)
    ndens, srcpos, nflux, kw = _problem(cfg, mesh=16)
    hcfg = cfg.replace(on_device_loop=False)
    _, _, recs = _run(lambda: pmake(hcfg), port.initial_state(hcfg, "cpu"),
                      ndens, srcpos, nflux, kw, steps=1)
    dump = recs[0].dumps[1]                 # after the second iteration
    restart = {k: v for k, v in dump.items() if v is not None}
    assert restart["niter"] == 2
    mp = pytest.MonkeyPatch()
    try:
        jcalls, pcalls = _spy(mp, JaxEvolve3D), _spy(mp, port.Evolve3D)
        j = _run(jmake, jax_initial_state(jcfg), ndens, srcpos, nflux, kw,
                 steps=1, jax=True, restart=restart)
        d = _run(pmake, port.initial_state(cfg, "cpu"), ndens, srcpos, nflux,
                 kw, steps=1, restart=restart)
        assert len(jcalls) == 1 and len(pcalls) == 1
    finally:
        mp.undo()
    h = _run(lambda: pmake(hcfg), port.initial_state(hcfg, "cpu"), ndens,
             srcpos, nflux, kw, steps=1, restart=restart)
    assert d[1][0].niter == h[1][0].niter == j[1][0].niter > 2
    assert d[2][0].labels == h[2][0].labels == j[2][0].labels
    for name in ("xh1", "temper_current"):
        assert torch.equal(getattr(d[0], name), getattr(h[0], name))
        np.testing.assert_allclose(getattr(d[0], name).numpy(),
                                   np.asarray(getattr(j[0], name)),
                                   rtol=1e-9, atol=0)


def test_max_global_iterations_cap():
    """A step that does not converge within max_global_iterations stops at
    niter = cap + 1, unconverged, in both packages and both loops."""
    jcfg, cfg, (jmake, pmake) = _solvers(mesh=16, max_global_iterations=1)
    ndens, srcpos, nflux, kw = _problem(cfg, mesh=16)
    mp = pytest.MonkeyPatch()
    try:
        jcalls, pcalls = _spy(mp, JaxEvolve3D), _spy(mp, port.Evolve3D)
        j = _run(jmake, jax_initial_state(jcfg), ndens, srcpos, nflux, kw,
                 steps=1, jax=True, stats=JaxStats(jcfg))
        d = _run(pmake, port.initial_state(cfg, "cpu"), ndens, srcpos, nflux,
                 kw, steps=1, stats=PhotonStatistics(cfg))
        assert len(jcalls) == 1 and len(pcalls) == 1
    finally:
        mp.undo()
    hcfg = cfg.replace(on_device_loop=False)
    h = _run(lambda: pmake(hcfg), port.initial_state(hcfg, "cpu"), ndens,
             srcpos, nflux, kw, steps=1, stats=PhotonStatistics(hcfg))
    for info in (j[1][0], d[1][0], h[1][0]):
        assert info.niter == 2 and not info.converged
    assert d[1][0].photon_stats == h[1][0].photon_stats
    assert torch.equal(d[0].xh1, h[0].xh1)
    np.testing.assert_allclose(d[0].xh1.numpy(), np.asarray(j[0].xh1),
                               rtol=1e-9, atol=0)


# --- the choice between the loops -----------------------------------------

CASES = {
    "default": (dict(), dict(), True),
    "adaptive": (dict(adaptive_sweep=True, adaptive_min_shell=2), dict(),
                 False),
    "verbose": (dict(), dict(verbose=True), False),
    "dump-due": (dict(), dict(dumper="due"), False),
    "dump-not-due": (dict(), dict(dumper="later"), True),
    "timings-fidelity": (dict(timings_fidelity=True), dict(clocks=True),
                         False),
    "fidelity-no-clocks": (dict(timings_fidelity=True), dict(), True),
    "host-loop": (dict(on_device_loop=False), dict(), False),
}


def _call_options(opts):
    out = dict(opts)
    if "dumper" in out:
        rec = Recorder()
        rec.enabled = True
        # the next dump due in 30 s (within the minute) or in an hour
        rec.interval_s = 100.0 if out["dumper"] == "due" else 3600.0
        rec._last_wall = time.time() - 70.0
        out["dumper"] = rec
    if out.get("clocks"):
        out["clocks"] = Recorder()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_loop_choice_matches_jax(case, monkeypatch, capsys):
    """Both packages pick the device loop exactly in the same cases: not
    adaptive, not verbose, no dump due within a minute, no Clocks under
    timings_fidelity, on_device_loop on."""
    cfg_kw, call_kw, want = CASES[case]
    jcfg, cfg, (jmake, pmake) = _solvers(mesh=16, **cfg_kw)
    ndens, srcpos, nflux, kw = _problem(cfg, mesh=16)
    jcalls = _spy(monkeypatch, JaxEvolve3D)
    pcalls = _spy(monkeypatch, port.Evolve3D)
    jmake().evolve3d(jax_initial_state(jcfg), jnp.asarray(ndens), DR,
                     srcpos, nflux, DT, **kw, **_call_options(call_kw))
    psolver = pmake()
    psolver.evolve3d(port.initial_state(cfg, "cpu"), torch.from_numpy(ndens),
                     DR, srcpos, nflux, DT, **kw, **_call_options(call_kw))
    assert bool(jcalls) == bool(pcalls) == want
    if want:
        assert psolver.last_loop["form"] == "eager"


def test_loop_choice_mesh_limit():
    """The device loop runs up to a 512^3 mesh (the predicate alone: no
    run at these sizes)."""
    _, cfg, (_, pmake) = _solvers(mesh=16)
    solver = pmake()
    for mesh, want in ((512, True), (520, False), (1024, False)):
        solver.cfg = cfg.replace(mesh=(mesh,) * 3)
        assert solver.device_loop_ok(False) is want
    solver.cfg = cfg
    assert solver.device_loop_ok(False)
    assert not solver.device_loop_ok(True)


# --- launch counts and step scalars across the captured form ------------

class FakeWhileGraph:
    """cuda_graph.WhileGraph emulated on the CPU: the capture runs the
    body's Python once without doing its work (as a capture records
    launches without making them), run() repeats the body while go holds
    (as a graph launch replays every recorded launch, reading the static
    buffers' current values)."""

    mode = "eager"
    captures = 0

    def __init__(self, body, go):
        self.body, self.go = body, go
        FakeWhileGraph.mode = "capture"
        FakeWhileGraph.captures += 1
        try:
            body()
        finally:
            FakeWhileGraph.mode = "eager"
        self.nodes, self.capture_s = 7, 0.0

    def run(self):
        FakeWhileGraph.mode = "replay"
        try:
            while bool(self.go):
                self.body()
        finally:
            FakeWhileGraph.mode = "eager"

    def close(self):
        pass


def _fake_graph(monkeypatch, key="chemistry"):
    """The captured form on the CPU: each body run that does its work
    counts one launch of `key` where it runs, as a kernel wrapper's
    counter add, captured beside its kernel, counts at every replay."""
    orig = port.Evolve3D._loop_body

    def body(self, a, c):
        if FakeWhileGraph.mode != "capture":
            chemistry_cuda.LAUNCHES.add(key, 1, torch.device("cpu"))
            orig(self, a, c)

    monkeypatch.setattr(port.Evolve3D, "_loop_body", body)
    monkeypatch.setattr(port.Evolve3D, "_graph_loop", lambda self: True)
    monkeypatch.setattr(cuda_graph, "WhileGraph", FakeWhileGraph)
    FakeWhileGraph.captures = 0


def test_launch_counts_across_graph_runs(monkeypatch):
    """The captured form's launch counts are the launches made: the
    solver adds nothing to them (a capture counts none, each replay its
    own), and the captured form's state is the host loop's, bitwise."""
    _, cfg, (_, pmake) = _solvers(mesh=16)
    ndens, srcpos, nflux, kw = _problem(cfg, mesh=16)
    key = "chemistry"
    _fake_graph(monkeypatch, key)
    solver = pmake()
    state = port.initial_state(cfg, "cpu")
    seen = []
    for step in range(2):
        before = chemistry_cuda.LAUNCHES[key]
        state, info = solver.evolve3d(state, torch.from_numpy(ndens), DR,
                                      srcpos, nflux, DT, **kw)
        seen.append((info.niter, chemistry_cuda.LAUNCHES[key] - before,
                     dict(solver.last_loop)))
    (n0, l0, s0), (n1, l1, s1) = seen
    assert l0 == n0 and l1 == n1
    assert s0["form"] == "graph" and s0["warmup"] == 1 and s0["nodes"] == 7
    assert s0["host_reads"] == 2 and s0["graph_launches"] == 1
    assert s1["warmup"] == 0 and s1["host_reads"] == 1
    assert s0["iterations"] == n0 and s1["iterations"] == n1
    assert FakeWhileGraph.captures == 1
    # the captured form against the host loop, bitwise
    hcfg = cfg.replace(on_device_loop=False)
    hstate = port.initial_state(hcfg, "cpu")
    hsolver = pmake(hcfg)
    for _ in range(2):
        hstate, hinfo = hsolver.evolve3d(hstate, torch.from_numpy(ndens), DR,
                                         srcpos, nflux, DT, **kw)
    assert hinfo.niter == n1
    assert torch.equal(state.xh1, hstate.xh1)


def test_launch_counts_mapping():
    """LaunchCounts: a fixed set of keys, launches added per device,
    set and cleared from the host, read as a dict."""
    from c2ray_tpu_torch.ops.launches import LaunchCounts
    counts = LaunchCounts(["a", "b"])
    cpu = torch.device("cpu")
    counts.add("a", 3, cpu)
    counts.add("b", 1, cpu)
    counts.add("a", 2, cpu)
    assert dict(counts) == {"a": 5, "b": 1} and len(counts) == 2
    counts["a"] = 0
    assert counts["a"] == 0 and counts["b"] == 1
    counts.clear()
    assert dict(counts) == {"a": 0, "b": 0}
    with pytest.raises(KeyError):
        counts.add("c", 1, cpu)
    with pytest.raises(TypeError):
        del counts["a"]
    assert set(chemistry_cuda.LAUNCHES) == {"chemistry", "chemistry_heat",
                                            "chemistry_f64",
                                            "chemistry_f64_heat"}


@pytest.mark.parametrize("isothermal", [True, False])
def test_graph_form_reads_step_scalars(monkeypatch, isothermal):
    """One capture serves steps of another dr, dt, LLS column and
    cosmo_cool_coeff (the per-step scalars live in a static buffer that
    the body reads at each replay): bitwise the host loop's steps with the
    same scalars; a new source count captures anew."""
    _, cfg, (_, pmake) = _solvers(mesh=16, isothermal=isothermal)
    ndens, srcpos, nflux, kw = _problem(cfg, mesh=16)
    nd = torch.from_numpy(ndens)
    _fake_graph(monkeypatch)
    plan = [(DR, DT, 1e17, 1e-17), (1.01 * DR, 0.8 * DT, 2e17, 2e-17),
            (1.02 * DR, 1.1 * DT, 1.5e17, 3e-17)]
    runs = {}
    for mode in ("graph", "host"):
        rcfg = cfg if mode == "graph" else cfg.replace(on_device_loop=False)
        solver = pmake(rcfg)
        state = port.initial_state(rcfg, "cpu")
        out = []
        for i, (dr, dt, lls, coeff) in enumerate(plan):
            opts = dict(kw, lls_coldens=lls)
            if not isothermal:
                opts["cosmo_cool_coeff"] = coeff
            pos = srcpos if i < 2 else srcpos[:2]
            state, info = solver.evolve3d(state, nd, dr, pos,
                                          nflux[:len(pos)], dt, **opts)
            out.append((info.niter, info.conv_flag, state.xh1.clone(),
                        None if isothermal else state.temper_current.clone()))
        runs[mode] = out
    for (gn, gc, gx, gt), (hn, hc, hx, ht) in zip(runs["graph"],
                                                    runs["host"]):
        assert (gn, gc) == (hn, hc)
        assert torch.equal(gx, hx)
        assert isothermal or torch.equal(gt, ht)
    assert FakeWhileGraph.captures == 2
