"""The convergence loop's phase clock (c2ray_tpu_torch/ops/launches.py)
against torch.profiler's trace, in the benchmark's cells on a CUDA card.

Usage (from the repository's root, on a machine with a CUDA card):

    python3 scripts/trace_loop_stamps.py [--cells a,b] [--seed N] \
        [--cycles 5]

For each cell of BENCHMARK.json (default: all): the benchmark's inputs
from the seed and its warm-up step (benchmark/harness/runner.py), then
`cycles` untraced cycles timed by the host's clock, then the benchmark's
traced cycle (one more under torch.profiler).  One JSON line per cell:
the stamped iterations of each step against EvolveInfo.niter; which
iterations of each step the trace holds K1, K2 or chemistry kernels of
(the ones the profiler kept) and how far those kernels lie outside the
iteration's stamped interval once aligned (us; 0: bracketed); how far the
card's clock drifts from the trace's over each step (us, between its two
anchors); how far each kept iteration's last stamp, mapped, lies outside
the recorded stamp kernel that took it (us; 0: inside); each phase's ms
per iteration of each step; the stamp metrics; and the traced cycle's
span and wall time against the untraced cycles' wall time.
"""

import argparse
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "benchmark")]

FAMILIES = {"K1": ("march_grid_shell", "march_grid_zfaces"),
            "K2": ("consume_cells", "consume_reduce"),
            "chemistry": ("chemistry_persistent", "reduce_chunks",
                          "reduce_counters")}
METRICS = ("loop_march_ms", "loop_consume_ms", "loop_chemistry_ms",
           "loop_glue_ms", "step_host_ms", "device_idle_share_stamped",
           "chem_substeps_per_pass", "device_idle_share")


def stamp_residuals(trace, ents):
    """Per step, {row: us by which the row's last stamp, mapped, lies
    outside the recorded stamp kernel nearest to it} for the rows whose
    last stamp kernel the trace holds (within 20 us)."""
    from harness import stamps
    spans = stamps.iteration_intervals(trace, ents)
    where = [(k, j) for k, e in enumerate(ents)
             for j in range(len(stamps.column(e, "first")))]
    recs = [(s, e) for name, s, e in trace.kernels if "phase_stamp" in name]
    out = [dict() for _ in ents]
    for (k, j), (_, last) in zip(where, spans or []):
        near = min(recs, key=lambda r: max(r[0] - last, last - r[1], 0.0),
                   default=None)
        if near is not None:
            miss = max(near[0] - last, last - near[1], 0.0)
            if miss < 20.0:
                out[k][j] = round(miss, 3)
    return out


def kept_iterations(trace, ents):
    """Per step, {row: largest us by which its recorded hand kernels lie
    outside the row's stamped interval} for the rows the trace holds
    kernels of (each kernel goes to the row nearest to its middle)."""
    from harness import stamps
    spans = stamps.iteration_intervals(trace, ents)
    where = [(k, j) for k, e in enumerate(ents)
             for j in range(len(stamps.column(e, "first")))]
    out = [dict() for _ in ents]
    for name, s, e in trace.kernels:
        if not spans or not any(p in name for fam in FAMILIES.values()
                                for p in fam):
            continue
        mid = 0.5 * (s + e)
        i = min(range(len(spans)), key=lambda i: max(
            spans[i][0] - mid, mid - spans[i][1], 0.0))
        a, b = spans[i]
        k, j = where[i]
        out[k][j] = max(out[k].get(j, 0.0), a - s, e - b, 0.0)
    return out


def one_cell(name, seed, cycles):
    import torch
    from harness import runner, stamps
    from harness.cells import Cell, benchmark_spec, metric_reader
    from c2ray_tpu_torch.ops import launches

    cell = Cell(benchmark_spec(), name)
    prog = runner.Program(cell.config, cell.traffic, seed, "cuda")
    keep_k = runner.sample_step(seed, len(prog.inp.steps))
    prog.step(prog.fresh_state(), 0)
    torch.cuda.synchronize()
    walls = []
    for _ in range(cycles):
        t0 = time.perf_counter()
        prog.cycle(keep_k, lambda state, info: None)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches.take()
    traced = runner._traced_cycle(prog, keep_k, True)
    # the untraced cycles stand for the benchmark's window
    run = SimpleNamespace(trace=traced.trace, traced=traced,
                          window_s=sum(walls),
                          steps=cycles * len(prog.inp.steps))
    ents = stamps.entries(run)
    niter = [s.niter for s in traced.steps]
    maps = stamps.clock_maps(run.trace, ents)
    drift = [round((1e3 * k - 1.0) * 1e-3 * (e["anchors"][1] - g0), 3)
             for e, (g0, _, k) in zip(ents, maps)] if maps else None
    kept = kept_iterations(run.trace, ents) if maps else None
    phases = {p: [round(1e-6 * float(stamps.column(e, p).sum())
                        / max(1, len(stamps.column(e, p))), 4)
                  for e in ents] for p in launches.PHASES}
    return dict(
        cell=name, seed=seed, device=torch.cuda.get_device_name(0),
        niter=niter, rows=[len(stamps.column(e, "first")) for e in ents],
        kept={k: {str(j): round(v, 3) for j, v in d.items()}
              for k, d in enumerate(kept)} if kept else None,
        outside_us_max=max((v for d in kept for v in d.values()),
                           default=None) if kept else None,
        drift_us=drift,
        last_stamp_outside_us={k: {str(j): v for j, v in d.items()}
                               for k, d in enumerate(
                                   stamp_residuals(run.trace, ents))}
        if maps else None,
        phase_ms_per_iteration=phases,
        counts={c: [int(stamps.column(e, c).sum()) for e in ents]
                for c in launches.COUNTS},
        metrics={m: metric_reader(m)(run) for m in METRICS},
        traced_span_s=run.trace.window_s,
        traced_wall_s=traced.wall_s,
        untraced_wall_s=statistics.median(walls), untraced_walls_s=walls)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=None)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 1234)
    ap.add_argument("--cycles", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_loop_stamps: no CUDA device", file=sys.stderr)
        return 2
    from harness.cells import benchmark_spec
    names = (args.cells.split(",") if args.cells else
             [w["name"] for w in benchmark_spec()["workloads"]])
    for name in names:
        print(json.dumps(one_cell(name, args.seed, args.cycles)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
