"""The program's own trace of the traced cycle: the phase clock of each
timestep's convergence loop (c2ray_tpu_torch/ops/launches.py), which the
stamp metrics read.

Under torch.profiler the program leaves one entry per evolve3d call in
its store: a row per convergence iteration with the ns of each phase,
the chemistry kernel's counts and the iteration's first and last stamp
on the card's %globaltimer, and the globaltimer values of two anchor
kernels launched on the stream before and after the loop.  The profiler
records the anchors, so each entry's stamps map onto the trace's clock
by the line through its own pair (stamp, trace start): the two clocks
were seen to drift apart by up to 70 us over a step of 160 ms.  A
program without the store (or a run without a trace) gives no entries,
and every reader then returns None.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import trace as tr

# the anchor kernel's name in the trace (csrc/loop_graph.cu)
ANCHOR = "clock_anchor"


def entries(run) -> list:
    """The traced cycle's entries of the program's store, one per
    timestep, taken from it once and kept on the run (run.stamps)."""
    got = getattr(run, "stamps", None)
    if got is not None:
        return got
    got = []
    if run.traced is not None:
        try:
            from c2ray_tpu_torch.ops.launches import take
        except ImportError:
            take = None
        if take is not None:
            # the newest, one per step of the traced cycle
            got = take()[-len(run.traced.steps):] if run.traced.steps \
                else []
    run.stamps = got
    return got


def column(entry: dict, name: str) -> np.ndarray:
    """One column of an entry's rows (int64, one value per iteration)."""
    rows = np.asarray(entry["rows"], dtype=np.int64).reshape(
        -1, len(entry["columns"]))
    return rows[:, list(entry["columns"]).index(name)]


def iterations(ents: list) -> int:
    return sum(len(column(e, "first")) for e in ents)


def phase_ms(run, phases) -> Optional[float]:
    """The ms of `phases` summed over every stamped iteration of the
    traced cycle, over its iterations."""
    ents = entries(run)
    n = iterations(ents)
    if not n:
        return None
    ns = sum(int(column(e, p).sum()) for e in ents for p in phases)
    return 1e-6 * ns / n


def count_sums(run, names) -> Optional[tuple]:
    """The chemistry counts `names`, each summed over the traced cycle."""
    ents = entries(run)
    if not iterations(ents):
        return None
    return tuple(sum(int(column(e, c).sum()) for e in ents) for c in names)


def clock_maps(trace: tr.Trace, ents: list) -> Optional[list]:
    """Per anchored entry, (stamp ns, trace us, trace us per stamp ns) of
    the line through its two anchors: their %globaltimer stamps against
    their trace starts.  None unless the trace holds exactly the
    entries' anchors, in order."""
    anchored = [e for e in ents if e.get("anchors")]
    starts = sorted(s for name, s, _ in trace.kernels if ANCHOR in name)
    if not anchored or len(starts) != 2 * len(anchored):
        return None
    out = []
    for k, e in enumerate(anchored):
        (a, b), (ta, tb) = e["anchors"], starts[2 * k:2 * k + 2]
        out.append((a, ta, (tb - ta) / (b - a) if b > a else 1e-3))
    return out


def iteration_intervals(trace: tr.Trace, ents: list) -> Optional[list]:
    """(start_us, end_us) of every stamped iteration on the trace's clock:
    its first stamp (the end of the stamp before it) to its last, each
    mapped by its step's anchor line."""
    maps = clock_maps(trace, ents)
    if maps is None:
        return None
    anchored = [e for e in ents if e.get("anchors")]
    return [(t0 + k * (f - g0), t0 + k * (la - g0))
            for e, (g0, t0, k) in zip(anchored, maps)
            for f, la in zip(column(e, "first"), column(e, "last"))]


def idle_share(run) -> Optional[float]:
    """1 - the union of the trace's device intervals and every stamped
    iteration's interval, over the traced window, in %: an iteration the
    profiler dropped counts busy."""
    if run.trace is None:
        return None
    spans = iteration_intervals(run.trace, entries(run))
    if not spans:
        return None
    t = run.trace
    merged = t._replace(kernels=sorted(
        t.kernels + [("stamped iteration", s, e) for s, e in spans],
        key=lambda k: k[1]))
    w = t.window_s
    return 100.0 * (w - tr.busy_s(merged)) / w


def outside_loop_ms(run) -> Optional[float]:
    """The window's ms per timestep (untraced, host clock) less the
    traced cycle's stamped loop time per timestep (each iteration's first
    to last stamp): the step's time outside the convergence loop's
    iterations, which the profiler does not slow.  The window runs the
    same cycle of steps as the traced one."""
    ents = entries(run)
    if not ents or not run.steps:
        return None
    loop_ns = sum(int((column(e, "last") - column(e, "first")).sum())
                  for e in ents)
    return 1e3 * run.window_s / run.steps - 1e-6 * loop_ns / len(ents)
