"""The stamp metrics' readers (harness/stamps.py) on a synthetic trace
and store: the alignment by each step's anchor pair, the union with the
stamped iterations (an iteration the profiler dropped counts busy), the
per-phase means, the time outside the loop, the chemistry counts, and
None from an empty store or a program without one."""

from types import SimpleNamespace

import numpy as np
import pytest

from harness import stamps
from harness.cells import metric_reader
from harness.trace import Trace

COLUMNS = ("sweep_glue", "march", "consume", "chemistry", "carry",
           "passes", "substeps", "first", "last")
# the card's globaltimer runs 5 s (in ns) ahead of the trace's clock
SHIFT = 5_000_000_000


def _row(t0_us, phases_us, counts=(0, 0)):
    """A row starting at t0_us (trace clock), phases in us."""
    ns = [int(1e3 * p) for p in phases_us]
    first = int(1e3 * t0_us) + SHIFT
    return ns + list(counts) + [first, first + sum(ns)]


def _entry(rows, anchors_us):
    return dict(form="graph", clock="globaltimer", columns=COLUMNS,
                rows=np.array(rows, dtype=np.int64),
                anchors=tuple(int(1e3 * a) + SHIFT for a in anchors_us))


def _run(entries, kernels, window=(0.0, 1000.0), window_s=1.0, steps=4):
    """A traced run: the trace (kernels in us), the store's entries
    already taken, and the untraced window's seconds and steps."""
    trace = Trace(sorted(kernels, key=lambda k: k[1]), [], *window)
    return SimpleNamespace(trace=trace, stamps=entries,
                           traced=SimpleNamespace(steps=entries),
                           window_s=window_s, steps=steps)


# two steps: step 1 of 2 iterations (the profiler keeps the first: K1
# 100-140 us, the chemistry 150-160), step 2 of 1 iteration
PHASES_A = (2.0, 40.0, 8.0, 10.0, 5.0)      # 65 us
PHASES_B = (2.0, 30.0, 6.0, 8.0, 4.0)       # 50 us
ENTRIES = [
    _entry([_row(100.0, PHASES_A, (7, 9)), _row(165.0, PHASES_A, (5, 5))],
           (99.0, 232.0)),
    _entry([_row(500.0, PHASES_B, (4, 4))], (499.0, 552.0)),
]
KERNELS = [("clock_anchor", 99.0, 99.5), ("march_grid_shell", 100.0, 140.0),
           ("chemistry_persistent", 150.0, 160.0),
           ("clock_anchor", 232.0, 232.5), ("clock_anchor", 499.0, 499.5),
           ("march_grid_shell", 500.0, 530.0), ("clock_anchor", 552.0,
                                                  552.5),
           ("memcpy", 600.0, 610.0)]


def test_alignment_from_each_steps_anchor_pair():
    run = _run(ENTRIES, KERNELS)
    maps = stamps.clock_maps(run.trace, ENTRIES)
    assert [m[1:] for m in maps] == pytest.approx([(99.0, 1e-3),
                                                   (499.0, 1e-3)])
    spans = stamps.iteration_intervals(run.trace, ENTRIES)
    assert spans == pytest.approx([(100.0, 165.0), (165.0, 230.0),
                                   (500.0, 550.0)])
    # a trace without the anchor pairs: no alignment
    assert stamps.clock_maps(_run(ENTRIES, KERNELS[1:]).trace,
                             ENTRIES) is None


def test_clocks_drifting_apart_map_on_the_anchor_line():
    """The card's clock runs 0.1% slow against the trace's: each stamp
    maps on the line through its step's two anchors."""
    def card(t_us):              # the card's ns at trace time t_us
        return SHIFT + int(499e3 + 0.999 * (1e3 * t_us - 499e3))

    row = [0] * len(COLUMNS)
    row[-2:] = [card(500.0), card(550.0)]
    e = dict(form="graph", clock="globaltimer", columns=COLUMNS,
             rows=np.array([row], dtype=np.int64),
             anchors=(card(499.0), card(552.0)))
    kernels = [("clock_anchor", 499.0, 499.5), ("clock_anchor", 552.0,
                                                 552.5)]
    (span,) = stamps.iteration_intervals(_run([e], kernels).trace, [e])
    assert span == pytest.approx((500.0, 550.0), abs=2e-3)


def test_a_dropped_iteration_counts_busy():
    run = _run(ENTRIES, KERNELS)
    # the trace alone: anchors 2 us, K1 70, chemistry 10, copy 10
    assert metric_reader("device_idle_share")(SimpleNamespace(
        trace=run.trace, traced=SimpleNamespace(launches={}))) == \
        pytest.approx(100.0 * (1000.0 - 92.0) / 1000.0)
    # with the stamps: each step's anchors, 100-230 and 500-550, the copy
    busy = 4 * 0.5 + 130.0 + 50.0 + 10.0
    assert stamps.idle_share(run) == pytest.approx(
        100.0 * (1000.0 - busy) / 1000.0)
    assert metric_reader("device_idle_share_stamped")(run) == \
        pytest.approx(100.0 * (1000.0 - busy) / 1000.0)


@pytest.mark.parametrize("name, want_us", [
    ("loop_march_ms", (40 + 40 + 30) / 3),
    ("loop_consume_ms", (8 + 8 + 6) / 3),
    ("loop_chemistry_ms", (10 + 10 + 8) / 3),
    ("loop_glue_ms", ((2 + 5) * 2 + (2 + 4)) / 3),
])
def test_phase_means_over_every_iteration(name, want_us):
    got = metric_reader(name)(_run(ENTRIES, KERNELS))
    assert got == pytest.approx(1e-3 * want_us)


def test_substeps_per_pass_and_none_when_isothermal():
    run = _run(ENTRIES, KERNELS)
    assert metric_reader("chem_substeps_per_pass")(run) == \
        pytest.approx((9 + 5 + 4) / (7 + 5 + 4))
    iso = [dict(e, rows=e["rows"].copy()) for e in ENTRIES]
    for e in iso:
        e["rows"][:, COLUMNS.index("substeps")] = 0
    assert metric_reader("chem_substeps_per_pass")(
        _run(iso, KERNELS)) is None


def test_host_ms_is_the_step_less_its_stamped_loop():
    """The untraced window's ms per step less the stamped iterations'
    time per step: 2 steps of 130 and 50 us in the traced cycle."""
    run = _run(ENTRIES, KERNELS, window_s=0.0012, steps=8)
    assert metric_reader("step_host_ms")(run) == pytest.approx(
        1e3 * 0.0012 / 8 - 1e-3 * (130.0 + 50.0) / 2)
    assert stamps.outside_loop_ms(_run([], KERNELS)) is None


NEW = ("loop_march_ms", "loop_consume_ms", "loop_chemistry_ms",
       "loop_glue_ms", "step_host_ms", "device_idle_share_stamped",
       "chem_substeps_per_pass")


@pytest.mark.parametrize("name", NEW)
def test_none_on_an_empty_store(name):
    assert metric_reader(name)(_run([], KERNELS)) is None


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_programs_store(name, monkeypatch):
    """A program that keeps no store (or has none to import) reads
    None, and nothing raises."""
    import sys
    monkeypatch.setitem(sys.modules, "c2ray_tpu_torch.ops.launches", None)
    run = _run([], KERNELS)
    del run.stamps
    run.traced = SimpleNamespace(steps=[None] * 4)
    assert metric_reader(name)(run) is None
    assert run.stamps == []
