"""chem_substeps_per_pass: the chemistry kernel's thermal substeps per
cell pass over the traced cycle: its counters' substeps summed over
every convergence iteration, over their passes, as the program's loop
clock keeps them (harness/stamps.py).  None where no substep ran (the
isothermal build)."""

from harness import stamps


def read(run):
    got = stamps.count_sums(run, ("passes", "substeps"))
    if not got or not got[0] or not got[1]:
        return None
    return got[1] / got[0]
