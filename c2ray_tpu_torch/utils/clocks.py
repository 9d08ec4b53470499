"""Wall/CPU clock tracking and the Timings.log stream.

Equivalent of clocks.f90 (a copy of c2ray_tpu/utils/clocks.py): cumulative CPU + wall-clock
accounting with timestamp checkpoints after every phase, written to
Timings.log (file_admin.f90:28) in the same spirit so parity tooling can
compare phase timings.
"""

from __future__ import annotations

import os
import time


class Clocks:
    def __init__(self, timings_path: str = "./results/Timings.log",
                 enabled: bool = True):
        """enabled=False (non-I/O processes in a multi-host run) keeps the
        clocks but writes nothing - the reference's timefile is rank-0
        only (C2Ray.F90 `if (rank == 0) write(timefile,...)`)."""
        self.t0_wall = time.time()
        self.t0_cpu = time.process_time()
        self._f = None
        if enabled:
            os.makedirs(os.path.dirname(timings_path) or ".", exist_ok=True)
            self._f = open(timings_path, "a")

    def timestamp_wallclock(self) -> float:
        """clocks.f90 timestamp_wallclock: seconds since startup."""
        return time.time() - self.t0_wall

    def stamp(self, label: str) -> None:
        if self._f is None:
            return
        self._f.write(f"{label}: {self.timestamp_wallclock():8.1f}\n")
        self._f.flush()

    def report(self) -> None:
        """Final CPU/wall report (clocks.f90:155-187)."""
        if self._f is None:
            return
        wall = time.time() - self.t0_wall
        cpu = time.process_time() - self.t0_cpu
        self._f.write(f"CPU time: {cpu:.1f} s, Wall clock time: {wall:.1f} s\n")
        self._f.flush()
