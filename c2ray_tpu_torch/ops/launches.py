"""The program's own tracing: kernel launch counts and the convergence
loop's phase clock.

Launch counts are kept on the device the kernels run on.

Each kernel wrapper owns a LaunchCounts of its build keys and calls
add(key, n, device) right after it launches n kernels.  On a CUDA device
the count is an int64 on the card and add is an addition there, on the
stream of the launch: a CUDA graph that captures the launch captures the
addition with it, so every replay counts its launches again (the device
loop's graph runs its body many times per graph launch), and a capture,
which launches nothing, counts nothing.  Reading a count copies the
card's counters to the host.  LaunchCounts is a mapping of key -> count;
setting a key (or clear()) resets it.

The phase clock (PhaseClock) times each convergence iteration of
Evolve3D's loops by phase (PHASES): the loop calls mark(phase) after
each phase's work, and the time since the previous mark is charged to
that phase, in the iteration's row.  On a CUDA device a mark is a
one-thread kernel (csrc/loop_graph.cu) that reads the card's
%globaltimer; the device loop's CUDA graph captures the marks once, and
each mark writes only while the clock's device flag is set, so turning
tracing on or off captures nothing anew.  The chemistry's mark also
keeps the chemistry kernel's passes and thermal substeps of the
iteration (COUNTS).  On the CPU a mark reads the host's clock (ns).
Around a traced step's loop, an anchor kernel stamps the stream before
and after (the clock row's `first` and `last` anchors): the profiler
records both, and their trace times against their %globaltimer values
map every stamp onto the trace's clock.

Tracing is on exactly while a torch.profiler session is active (read
once per evolve3d call, where the loop's clock begins): an operator
turns it on by running the program under torch.profiler.profile.  Each
traced call leaves one entry in the module's store (take() empties it):
its rows, one per iteration, their columns (COLUMNS), the clock
(`globaltimer` or `host`) and the anchors.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from collections.abc import MutableMapping
from typing import Iterable, Optional

import torch

from .. import cuda_graph


class LaunchCounts(MutableMapping):
    """Launch counts by build key (a fixed set of keys)."""

    def __init__(self, keys: Iterable[str]):
        self._slot = {k: i for i, k in enumerate(keys)}
        # what was set from the host, plus the launches counted off the
        # card (a CPU tensor's, as in the tests' stand-ins)
        self._host = [0] * len(self._slot)
        self._dev: dict = {}       # torch.device -> int64 (keys,) tensor

    def add(self, key: str, n: int, device: torch.device) -> None:
        """Count n launches of `key` made on `device`, on its current
        stream."""
        i = self._slot[key]
        if device.type != "cuda":
            self._host[i] += n
            return
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        vec = self._dev.get(device)
        if vec is None:
            # a capture would record the zero fill and replay it
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("launch counters are made on a first "
                                   "launch outside a CUDA graph capture")
            vec = torch.zeros(len(self._slot), dtype=torch.int64,
                              device=device)
            self._dev[device] = vec
        vec[i].add_(n)

    def __getitem__(self, key: str) -> int:
        i = self._slot[key]
        return self._host[i] + sum(int(v[i]) for v in self._dev.values())

    def __setitem__(self, key: str, value: int) -> None:
        i = self._slot[key]
        self._host[i] = int(value)
        for v in self._dev.values():
            v[i].zero_()

    def __delitem__(self, key: str) -> None:
        raise TypeError("LaunchCounts has a fixed set of keys; set a "
                        "count to 0 to reset it")

    def __iter__(self):
        return iter(self._slot)

    def __len__(self) -> int:
        return len(self._slot)

    def clear(self) -> None:
        self._host = [0] * len(self._slot)
        for v in self._dev.values():
            v.zero_()

    def __repr__(self) -> str:
        return f"LaunchCounts({dict(self)!r})"


# the phases of one convergence iteration, in the order their marks come:
# the sweep's work before each source batch's column march (the neutral
# density, zero fills, the previous batch's sums), the march (K1) and the
# rate deposition (K2) of each batch; the rest of the sweep, to its end in
# the solver (the last batch's sums; the windowed batches of the adaptive
# path and a layout's raytracer and collectives, which have no marks of
# their own); the chemistry kernel; the carry: the tail's sums and
# packing, the carry's copies and the loop's condition
PHASES = ("sweep_glue", "march", "consume", "chemistry", "carry")
# the chemistry kernel's counts of the iteration (its counters' passes
# and substeps, summed over its calls)
COUNTS = ("passes", "substeps")
# a row: ns per phase, the counts, then the first and last stamp (the
# start of the iteration's first phase, the end of its last)
COLUMNS = PHASES + COUNTS + ("first", "last")
# the clock's own row (the last) holds the previous stamp, then the two
# anchors in these columns
_FIRST_ANCHOR, _LAST_ANCHOR = 1, 2

# traced evolve3d calls, oldest first, until take() (a bounded store: an
# entry nobody takes is dropped at last)
_STORE: deque = deque(maxlen=4096)
# the clock the loop's marks go to (PhaseClock.active)
_ACTIVE: Optional["PhaseClock"] = None
# per CUDA device: the stamps' int32 on-flag and its value as last set
_FLAGS: dict = {}


def tracing() -> bool:
    """Whether a torch.profiler session is active (tracing is on)."""
    return torch._C._autograd._profiler_enabled()


def take() -> list:
    """Every traced call's entry in the store, oldest first; empties it."""
    out = list(_STORE)
    _STORE.clear()
    return out


def mark(phase: str, counts: Optional[torch.Tensor] = None) -> None:
    """End of `phase` in the current iteration of the active clock (none:
    nothing).  counts: the chemistry kernel's (passes, substeps), int64
    on the clock's device."""
    if _ACTIVE is not None:
        _ACTIVE.mark(phase, counts)


def _flag(device: torch.device, on: Optional[bool] = None) -> torch.Tensor:
    """The device's on-flag; set to `on` unless None (written only when
    it changes)."""
    got = _FLAGS.get(device)
    if got is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the stamps' flag is made outside a CUDA "
                               "graph capture")
        got = _FLAGS[device] = [torch.zeros(1, dtype=torch.int32,
                                            device=device), False]
    if on is not None and got[1] != on:
        got[0].fill_(int(on))
        got[1] = on
    return got[0]


class PhaseClock:
    """The phase clock of one loop: int64 rows (iterations, COLUMNS) on
    `device` and the clock's own row.  `row` is the row of the iteration
    that runs (a 0-d int32 tensor on the device, as the carry's iteration
    counter, or an int).  begin() starts a step: it reads whether tracing
    is on and, when on, zeroes the rows and anchors the clock; restart()
    starts the clock anew without charging a phase (an uncaptured loop
    calls it at each iteration's start, so the host's work between
    iterations falls in none); end() anchors the step's end; collect(n)
    copies the first n rows to the store when on."""

    def __init__(self, iterations: int, device: torch.device):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.nrows = int(iterations)
        self.rows = torch.zeros((self.nrows + 1, len(COLUMNS)),
                                dtype=torch.int64, device=device)
        self.on = False
        self.row = 0
        self._index = {p: i for i, p in enumerate(COLUMNS)}
        if device.type == "cuda":
            self._flag = _flag(device)
            # an int row, written on the device
            self._it = torch.zeros((), dtype=torch.int32, device=device)
        else:
            self._prev = 0

    @contextlib.contextmanager
    def active(self):
        """The marks made inside go to this clock."""
        global _ACTIVE
        outer, _ACTIVE = _ACTIVE, self
        try:
            yield self
        finally:
            _ACTIVE = outer

    def begin(self) -> None:
        self.on = on = tracing()
        if self.device.type == "cuda":
            _flag(self.device, on)
            if on:
                self.rows.zero_()
                self._anchor(_FIRST_ANCHOR)
        elif on:
            self.rows.zero_()
            self._prev = time.perf_counter_ns()

    def restart(self) -> None:
        if not self.on:
            return
        if self.device.type == "cuda":
            self._anchor(0)
        else:
            self._prev = time.perf_counter_ns()

    def end(self) -> None:
        if self.on and self.device.type == "cuda":
            self._anchor(_LAST_ANCHOR)

    def collect(self, n: int, form: str) -> None:
        """One copy of the rows to the host; the first n go to the store."""
        if not self.on:
            return
        host = self.rows.cpu().numpy()
        cuda = self.device.type == "cuda"
        _STORE.append(dict(
            form=form, clock="globaltimer" if cuda else "host",
            columns=COLUMNS, rows=host[:n].copy(),
            anchors=(tuple(int(v) for v in host[-1, _FIRST_ANCHOR:
                                                  _LAST_ANCHOR + 1])
                     if cuda else None)))

    def mark(self, phase: str, counts=None) -> None:
        col = self._index[phase]
        if self.device.type == "cuda":
            # a capture records the stamp whatever the flag: it writes at
            # replay while the flag is set
            if self.on or torch.cuda.is_current_stream_capturing():
                self._stamp(col, counts)
            return
        if not self.on:
            return
        now = time.perf_counter_ns()
        row = self.rows[int(self.row)]
        row[col] += now - self._prev
        if row[-2] == 0:
            row[-2] = self._prev
        row[-1] = now
        if counts is not None:
            c = self._index["passes"]
            row[c:c + len(COUNTS)] += counts.to(torch.int64)
        self._prev = now

    def _stamp(self, col: int, counts) -> None:
        row = self.row
        if not isinstance(row, torch.Tensor):
            self._it.fill_(int(row))
            row = self._it
        if counts is not None and (counts.dtype != torch.int64
                                   or counts.numel() != len(COUNTS)
                                   or not counts.is_contiguous()):
            raise ValueError("counts: (passes, substeps) as a contiguous "
                             "int64 tensor")
        lib, fn = cuda_graph._fn("c2r_phase_stamp")
        cuda_graph._check(lib, fn(
            self._flag.data_ptr(), self.rows.data_ptr(), row.data_ptr(),
            self.nrows, len(COLUMNS), col,
            counts.data_ptr() if counts is not None else None,
            self._index["passes"],
            torch.cuda.current_stream(self.device).cuda_stream),
            "a phase stamp")

    def _anchor(self, slot: int) -> None:
        """Start the clock on the stream; keep the time in the clock
        row's column `slot` (0: nowhere else)."""
        lib, fn = cuda_graph._fn("c2r_clock_anchor")
        cuda_graph._check(lib, fn(
            self.rows.data_ptr(), self.nrows, len(COLUMNS), slot,
            torch.cuda.current_stream(self.device).cuda_stream),
            "a clock anchor")
