"""loop_glue_ms: the convergence loop's work outside the hand kernels,
per iteration: the `sweep_glue` (the neutral density, zero fills, the
batches' sums, to the sweep's end) and `carry` (the tail's sums and
packing, the carry's copies and the loop's condition) phases of the
program's loop clock, summed over every iteration of the traced cycle,
over its iterations (harness/stamps.py)."""

from harness import stamps


def read(run):
    return stamps.phase_ms(run, ("sweep_glue", "carry"))
