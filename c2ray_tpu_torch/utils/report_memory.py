"""Process memory reporting (report_memory.f90: /proc/self/status VmPeak,
VmSize, VmRSS, VmHWM each timestep), with the card's memory from
torch.cuda.memory_stats in place of the JAX twin's device stats."""

from __future__ import annotations

from typing import Dict


def report_memory() -> Dict[str, float]:
    """Host VM stats in MB (report_memory.f90:52) and, once the process
    has used the card, its allocated device memory in MB."""
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                key = line.split(":")[0]
                if key in ("VmPeak", "VmSize", "VmRSS", "VmHWM"):
                    out[key] = float(line.split()[1]) / 1024.0
    except OSError:
        pass
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats()
        if stats:
            out["hbm_in_use"] = stats.get("allocated_bytes.all.current",
                                          0) / 1e6
            out["hbm_peak"] = stats.get("allocated_bytes.all.peak", 0) / 1e6
    return out


def format_memory_report() -> str:
    m = report_memory()
    return " ".join(f"{k}={v:.0f}MB" for k, v in m.items())
