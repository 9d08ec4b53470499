"""loop_chemistry_ms: the chemistry kernel (with the add_photon_losses
redistribution where it is on) per convergence iteration: the
`chemistry` phase of the program's loop clock, summed over every
iteration of the traced cycle, over its iterations (harness/stamps.py)."""

from harness import stamps


def read(run):
    return stamps.phase_ms(run, ("chemistry",))
