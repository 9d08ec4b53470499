"""step_host_ms: the time per timestep outside the convergence loop's
iterations: the host's work (the inputs, the loop's start and launch,
the read of its results, the replay of the reports) and the copies it
waits on; the window's
`step_ms` (untraced) less the traced cycle's stamped loop time per
timestep, first to last stamp of each iteration of the program's loop
clock (harness/stamps.py)."""

from harness import stamps


def read(run):
    return stamps.outside_loop_ms(run)
