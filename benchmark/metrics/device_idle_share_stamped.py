"""device_idle_share_stamped: the share of the traced cycle in which the
device ran nothing, in %: 1 - the union of the trace's device intervals
and every convergence iteration's interval from the program's loop clock
(first to last stamp, mapped onto the trace's clock by the anchor pair
of its timestep), over the traced window.  The iterations the profiler
drops from the captured loop count busy (harness/stamps.py)."""

from harness import stamps


def read(run):
    return stamps.idle_share(run)
