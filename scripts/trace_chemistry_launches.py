"""Which chemistry kernels torch.profiler reports for a timestep of the
device loop's captured graph, beside the launches the wrappers count on
the card and the captured body's kernel nodes.

Usage (on a machine with a CUDA card, from the repository's root):

    python3 scripts/trace_chemistry_launches.py

One process, chip_smoke.py's inputs at 256^3 with 16 sources: a
non-isothermal run (phase 12's) through the device loop, captured by a
first timestep, and its next timestep under the profiler, before any
isothermal kernel ran in the process; then an isothermal run (phase
6's), captured likewise, a timestep of it under the profiler, and the
non-isothermal run's next timestep under the profiler once more.  Each
traced step prints its iterations, the chemistry kernels in its trace by
name and count, the chemistry launches counted where they happen
(ops/launches.py, one per iteration) and the kernel nodes of the
captured body, as one JSON line.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import torch
    if not torch.cuda.is_available():
        print("trace_chemistry_launches: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import c2ray_tpu_torch as port
    from c2ray_tpu_torch.ops.photonstats import PhotonStatistics
    from c2ray_tpu_torch.ops.thermal import setup_cool

    _, inp = cs.bench_inputs(256, 16, 16)

    def run(isothermal):
        cfg = cs.make_cfg(256, 16, isothermal=isothermal)
        kw = {} if isothermal else dict(cool=setup_cool(cfg, device="cuda"))
        solver = port.Evolve3D(cfg, cs.rad_tables(cfg, "cuda"),
                               device="cuda", **kw)
        state = port.initial_state(cfg, device="cuda")._replace(
            xh1=torch.as_tensor(inp["xh1"], device="cuda"))
        nd = torch.as_tensor(inp["ndens"], device="cuda")

        def step():
            return solver.evolve3d(state, nd, inp["dr"], inp["srcpos"],
                                   inp["nflux"], inp["dt"], lls_coldens=1e17,
                                   stats=PhotonStatistics(cfg))
        step()                                  # captures the loop's body
        torch.cuda.synchronize()
        return step, solver

    def traced(tag, step, solver):
        cs.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, info = step()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and "chemistry" in e.key}
        launches = {k: v for k, v in cs.read_launches().items()
                    if v and k.startswith("chemistry")}
        print(json.dumps(dict(
            step=tag, niter=info.niter, loop=solver.last_loop["form"],
            profiler_chemistry_kernels=kernels,
            counted_chemistry_launches=launches,
            body_kernel_nodes=cs.body_kernel_nodes(solver))), flush=True)

    heat = run(isothermal=False)
    traced("non-isothermal, alone", *heat)
    iso = run(isothermal=True)
    traced("isothermal", *iso)
    traced("non-isothermal, after the isothermal", *heat)
    return 0


if __name__ == "__main__":
    sys.exit(main())
