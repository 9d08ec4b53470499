"""Kernel launch counts, kept on the device the kernels run on.

Each kernel wrapper owns a LaunchCounts of its build keys and calls
add(key, n, device) right after it launches n kernels.  On a CUDA device
the count is an int64 on the card and add is an addition there, on the
stream of the launch: a CUDA graph that captures the launch captures the
addition with it, so every replay counts its launches again (the device
loop's graph runs its body many times per graph launch), and a capture,
which launches nothing, counts nothing.  Reading a count copies the
card's counters to the host.  LaunchCounts is a mapping of key -> count;
setting a key (or clear()) resets it.
"""

from __future__ import annotations

from collections.abc import MutableMapping
from typing import Iterable

import torch


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
