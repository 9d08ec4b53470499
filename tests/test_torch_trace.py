"""The program's own tracing (c2ray_tpu_torch/ops/launches.py): the
convergence loop's phase clock and its store.

On the CPU, at 12^3 and at most 4 iterations a step: nothing is stored without a profiler; under
torch.profiler each evolve3d call stores one row per convergence
iteration (the host's clock) on the eager device loop, the host loop and
the graph form (its graph stood in for on the CPU), with every phase of
the path, and the host's work between iterations in none; the state and
EvolveInfo are bitwise those of an untraced run.
The tests marked `card` run the captured loop on a CUDA card and skip
without one (on the card: python -m pytest tests/test_torch_trace.py -m
card --noconftest): toggling the profiler captures no new graph, the
rows' chemistry counts are those of a direct call, the stamps are
monotone.  This file imports no JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import c2ray_tpu_torch as port
from c2ray_tpu_torch import cuda_graph
from c2ray_tpu_torch.ops import launches
from c2ray_tpu_torch.ops.photonstats import PhotonStatistics
from c2ray_tpu_torch.ops.tables import build_rad_tables
from c2ray_tpu_torch.ops.thermal import setup_cool

N = 12
DT = 3.0e13
DR = 4.4e23


def _config(n=N, **kw):
    opts = dict(dtype="float64", use_lls=True, type_of_lls=1,
                cosmological=False, source_batch=2, max_global_iterations=3)
    opts.update(kw)
    return port.test_problem_config(mesh=n, **opts)


def _problem(device, n=N, seed=3):
    rng = np.random.default_rng(seed)
    ndens = torch.from_numpy(rng.uniform(1.5e-4, 2.5e-4, (n,) * 3))
    srcpos = rng.integers(0, n, (3, 3)).astype(np.int32)
    nflux = 10.0 ** rng.uniform(5.5, 6.5, 3)
    return SimpleNamespace(ndens=ndens.to(device), srcpos=srcpos,
                           nflux=nflux)


_TABLES = {}


def _solver(cfg, device):
    key = (cfg.dtype, str(device))
    if key not in _TABLES:
        _TABLES[key] = build_rad_tables(cfg, device=device)
    cool = None if cfg.isothermal else setup_cool(cfg, device=device)
    return port.Evolve3D(cfg, _TABLES[key], device=device, cool=cool)


def _step(solver, state, p, traced):
    """One evolve3d call, under torch.profiler when traced -> (state,
    info, store entries)."""
    cfg = solver.cfg
    kw = dict(lls_coldens=1e17, stats=PhotonStatistics(cfg))
    if not cfg.isothermal:
        kw["cosmo_cool_coeff"] = 1e-17
    launches.take()
    if not traced:
        state, info = solver.evolve3d(state, p.ndens, DR, p.srcpos,
                                      p.nflux, DT, **kw)
        return state, info, launches.take()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if solver.device.type == "cuda" else [])
    with profile(activities=acts):
        state, info = solver.evolve3d(state, p.ndens, DR, p.srcpos,
                                      p.nflux, DT, **kw)
        if solver.device.type == "cuda":
            torch.cuda.synchronize()
    return state, info, launches.take()


def _rows(entry, name):
    return entry["rows"][:, launches.COLUMNS.index(name)]


def _same(a, b):
    """Two (state, info) pairs bitwise alike."""
    (sa, ia), (sb, ib) = a, b
    for x, y in zip(sa, sb):
        assert (x is None and y is None) or torch.equal(x, y)
    for name in ia._fields:
        x, y = getattr(ia, name), getattr(ib, name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y), name
        else:
            assert x == y, name


class _Replay:
    """cuda_graph.WhileGraph stood in for on the CPU: no capture; run()
    repeats the body while go holds."""

    captures = 0

    def __init__(self, body, go):
        self.body, self.go = body, go
        self.nodes, self.capture_s = 0, 0.0
        _Replay.captures += 1

    def run(self):
        while bool(self.go):
            self.body()

    def close(self):
        pass


@pytest.fixture(scope="module")
def runs():
    """Per loop form, one step untraced and one traced from the same
    state: {form: (untraced, traced)}, each (state, info, entries)."""
    p = _problem("cpu")
    out = {}
    for form, cfg in (("eager", _config()),
                      ("host", _config(on_device_loop=False))):
        solver = _solver(cfg, "cpu")
        state = port.initial_state(cfg, "cpu")
        out[form] = tuple(_step(solver, state, p, traced)
                          for traced in (False, True))
    return out


def test_store_stays_empty_without_a_profiler(runs):
    assert not launches.tracing()
    for untraced, _ in runs.values():
        assert untraced[2] == []


@pytest.mark.parametrize("form", ["eager", "host"])
def test_a_row_per_iteration_with_every_phase(runs, form):
    _, (state, info, entries) = runs[form]
    assert len(entries) == 1
    e = entries[0]
    assert e["form"] == form and e["clock"] == "host"
    assert e["anchors"] is None and e["columns"] == launches.COLUMNS
    assert e["rows"].shape == (info.niter, len(launches.COLUMNS))
    assert info.niter > 1
    for phase in launches.PHASES:
        assert (_rows(e, phase) > 0).all(), phase
    assert (e["rows"] >= 0).all()
    # the plain chemistry keeps no counts
    assert not e["rows"][:, len(launches.PHASES):-2].any()
    first, last = _rows(e, "first"), _rows(e, "last")
    assert (first < last).all() and (first[1:] >= last[:-1]).all()
    # each iteration's phases fill its interval: the host's reads and
    # replay between iterations are in none
    spent = sum(_rows(e, ph) for ph in launches.PHASES)
    assert (spent == last - first).all()


@pytest.mark.parametrize("form", ["eager", "host"])
def test_tracing_changes_no_bit(runs, form):
    untraced, traced = runs[form]
    _same(untraced[:2], traced[:2])


def test_graph_form_rows_and_one_capture(monkeypatch):
    """The graph form (its graph stood in for on the CPU): the loop's
    clock is made with the captured carry, a traced step stores its rows,
    and turning tracing on and off builds no second graph."""
    monkeypatch.setattr(port.Evolve3D, "_graph_loop", lambda self: True)
    monkeypatch.setattr(cuda_graph, "WhileGraph", _Replay)
    _Replay.captures = 0
    cfg = _config(isothermal=False)
    p = _problem("cpu")
    solver = _solver(cfg, "cpu")
    state = port.initial_state(cfg, "cpu")
    # the host loop, untraced: the same bits
    hcfg = cfg.replace(on_device_loop=False)
    plain = _solver(hcfg, "cpu")
    pstate = port.initial_state(hcfg, "cpu")
    for traced in (False, True, False, True):
        state, info, entries = _step(solver, state, p, traced)
        pstate, pinfo, _ = _step(plain, pstate, p, False)
        _same((state, info), (pstate, pinfo))
        assert solver.last_loop["form"] == "graph"
        if traced:
            (e,) = entries
            assert e["form"] == "graph"
            assert e["rows"].shape[0] == info.niter
            for phase in launches.PHASES:
                assert (_rows(e, phase) > 0).all(), phase
        else:
            assert entries == []
    assert _Replay.captures == 1 and len(solver._loop_cache) == 1


def test_phase_clock_charges_and_counts():
    """A mark charges the time since the previous one to its phase in the
    current row; counts add; a step begun without a profiler marks
    nothing."""
    clock = launches.PhaseClock(3, torch.device("cpu"))
    with clock.active():
        clock.begin()
        clock.row = 0
        launches.mark("march")
        clock.end()
        clock.collect(1, "eager")
        assert not clock.on and not clock.rows.any()
        assert launches.take() == []
        with profile(activities=[ProfilerActivity.CPU]):
            clock.begin()
        assert clock.on
        for row in (0, 1):
            clock.row = row
            launches.mark("march")
            launches.mark("chemistry", torch.tensor([4, 5]))
            launches.mark("chemistry", torch.tensor([1, 1]))
            launches.mark("carry")
        clock.end()
    launches.mark("carry")            # no active clock: nothing
    clock.collect(2, "eager")
    (e,) = launches.take()
    r = e["rows"]
    assert r.shape == (2, len(launches.COLUMNS))
    assert _rows(e, "passes").tolist() == [5, 5]
    assert _rows(e, "substeps").tolist() == [6, 6]
    assert (_rows(e, "consume") == 0).all()
    spent = sum(_rows(e, p) for p in launches.PHASES)
    assert (spent == _rows(e, "last") - _rows(e, "first")).all()
    assert _rows(e, "first")[1] == _rows(e, "last")[0]


def test_a_restart_leaves_the_gap_in_no_phase():
    """An uncaptured loop restarts the clock at each iteration's start:
    the time since the previous mark goes to no phase, and the row's
    interval starts at the restart."""
    import time
    clock = launches.PhaseClock(2, torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]):
        clock.begin()
    with clock.active():
        for row in (0, 1):
            time.sleep(0.02)          # the host between iterations
            clock.restart()
            clock.row = row
            launches.mark("march")
            launches.mark("carry")
    clock.collect(2, "host")
    (e,) = launches.take()
    first, last = _rows(e, "first"), _rows(e, "last")
    assert first[1] - last[0] >= 20_000_000
    spent = sum(_rows(e, p) for p in launches.PHASES)
    assert (spent == last - first).all() and (spent < 20_000_000).all()


# --- on the card -------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_card_toggling_captures_no_graph(cuda):
    """Untraced and traced steps in turns: one graph, no capture after the
    first step, a row per iteration, the bits of an untraced twin."""
    cfg = _config(n=64, dtype="float32")
    p = _problem(cuda, n=64)
    solver, twin = _solver(cfg, cuda), _solver(cfg, cuda)
    state = port.initial_state(cfg, cuda)
    tstate = port.initial_state(cfg, cuda)
    graph = None
    for k, traced in enumerate((False, True, False, True)):
        state, info, entries = _step(solver, state, p, traced)
        tstate, tinfo, _ = _step(twin, tstate, p, False)
        _same((state, info), (tstate, tinfo))
        (entry,) = solver._loop_cache.values()
        graph = graph or entry.graph
        assert entry.graph is graph
        assert solver.last_loop["form"] == "graph"
        if k:
            assert solver.last_loop["capture_s"] == 0.0
        if traced:
            (e,) = entries
            assert e["clock"] == "globaltimer"
            assert e["rows"].shape[0] == info.niter
            for phase in launches.PHASES:
                assert (_rows(e, phase) > 0).all(), phase
        else:
            assert entries == []


@pytest.mark.card
def test_card_counts_are_the_chemistry_kernels(cuda):
    """The first row's chemistry counts equal the counters of a direct
    call of the chemistry on that iteration's inputs (the sweep of the
    step's initial state)."""
    from c2ray_tpu_torch.ops.chemistry import global_chemistry
    from c2ray_tpu_torch.ops.sweep import raytrace_all_sources, sweep_scalars
    cfg = _config(n=64, isothermal=False)
    p = _problem(cuda, n=64)
    solver = _solver(cfg, cuda)
    state = port.initial_state(cfg, cuda)
    _step(solver, state, p, False)               # the capture
    _, info, (e,) = _step(solver, state, p, True)
    sc = sweep_scalars(cfg, DR, 1e17, 0.0)
    phih, phiheat, _, _, _ = raytrace_all_sources(
        cfg, solver.tables, p.ndens, state.xh1,
        torch.as_tensor(p.srcpos, device=cuda),
        torch.as_tensor(p.nflux, dtype=cfg.torch_dtype, device=cuda), sc)
    chem = global_chemistry(cfg, DT, p.ndens, state.xh1, state.xh1,
                            state.xh1, phih, phiheat, state.temper_current,
                            state.temper_av, 1.0, solver.cool,
                            float(cfg.np_dtype(1e-17)))
    want = chem.counters[2:4].tolist()
    got = [int(_rows(e, c)[0]) for c in launches.COUNTS]
    assert got == want and want[1] > 0


@pytest.mark.card
def test_card_stamps_are_monotone(cuda):
    cfg = _config(n=64, dtype="float32")
    p = _problem(cuda, n=64)
    solver = _solver(cfg, cuda)
    state = port.initial_state(cfg, cuda)
    for traced in (True, True):                  # capture step, then replay
        state, info, (e,) = _step(solver, state, p, traced)
        first, last = _rows(e, "first"), _rows(e, "last")
        a0, a1 = e["anchors"]
        assert a0 <= first[0] and last[-1] <= a1
        assert (first < last).all() and (first[1:] >= last[:-1]).all()
        assert (e["rows"] >= 0).all()
        spent = sum(_rows(e, ph) for ph in launches.PHASES)
        assert (spent == last - first).all()
