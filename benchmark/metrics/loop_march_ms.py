"""loop_march_ms: K1 (the full-cube column march) per convergence
iteration: the `march` phase of the program's loop clock (device
%globaltimer stamps inside the captured loop), summed over every
iteration of the traced cycle, over its iterations (harness/stamps.py)."""

from harness import stamps


def read(run):
    return stamps.phase_ms(run, ("march",))
