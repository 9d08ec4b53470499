"""loop_consume_ms: K2 (the full-cube rate deposition) per convergence
iteration: the `consume` phase of the program's loop clock, summed over
every iteration of the traced cycle, over its iterations
(harness/stamps.py)."""

from harness import stamps


def read(run):
    return stamps.phase_ms(run, ("consume",))
