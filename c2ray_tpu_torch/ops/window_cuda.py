"""Window gather and scatter-add of the windowed sweep: the hand-written
CUDA kernels and their plain versions.

The port's twin of c2ray_tpu/ops/window_pallas.py:

  window_gather       (csrc/window.cu) <- _gather_kernel, the (2r+1)^3
                                          window at each source's corner
                                          of the padded neutral density
  window_scatter_add  (csrc/window.cu) <- _scatter_kernel, each window's
                                          rate cube added into the padded
                                          accumulator at its corner

The padded field and the accumulator are exactly (n+2r)^3 on the cube,
and (m+2r, n+2r, n+2r) on the halo layout's slab of m rows
(parallel/domain.py): the kernels take axis 0's extent apart from that
of axes 1 and 2.  The TPU's covering blocks, lane and sublane margins
and rotates do not carry over.  fold_padded_acc folds the accumulator's
r-wide ring back mod n once per pass, in plain torch (plain jnp in the
JAX package too); on the slab it folds axes 1 and 2, and axis 0's ring
goes to the neighbouring slabs (WindowedHaloSweeper.ring_fold).

Each wrapper takes its plain PyTorch version (the *_reference function
beside it) only for tensors on the CPU.  For a CUDA tensor it launches the
kernel or raises; it never falls back.  Each kernel has a float32 and a
float64 build (sweep_cuda.build_for), taken by the tensors' dtype.
LAUNCHES counts the kernel launches each wrapper makes, by build:
"window_gather", "window_scatter", and "window_gather_f64",
"window_scatter_f64".
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .sweep_cuda import _DTYPES, _check_cuda, _check_rc, _entry, build_for

LAUNCHES = {build_for(k, d).key: 0 for k in ("window_gather",
                                              "window_scatter")
            for d in _DTYPES}
# (device index, dtype) -> K5's windows per launch
_SCATTER_LIMIT: dict = {}

_vp, _i = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "window_gather": ("window", "c2r_window_gather",
                      [_vp, _i, _i, _vp, _i, _i, _vp, _vp]),
    "window_scatter": ("window", "c2r_window_scatter_add",
                       [_vp, _i, _i, _vp, _i, _i, _vp, _vp]),
    # the most windows one scatter-add launch takes on the current device
    "window_scatter_max": ("window", "c2r_window_scatter_max_windows", []),
}


def padded_acc_shape(n: int, r: int,
                     rows: Optional[int] = None) -> Tuple[int, int, int]:
    """The padded field's and the accumulator's shape: (n+2r)^3, or
    (rows+2r, n+2r, n+2r) on a slab of `rows` grid rows."""
    return (n + 2 * r if rows is None else rows + 2 * r,
            n + 2 * r, n + 2 * r)


def fold_padded_acc(acc_pad: torch.Tensor, n: int, radius: int,
                    axes=(0, 1, 2)) -> torch.Tensor:
    """Fold the r-wide pad ring of a padded accumulator back into the
    grid with periodic wrapping, axis by axis over `axes`: the low pad
    adds to the high end, the high pad to the low end (the JAX
    fold_padded_acc).  axes=(1, 2) folds a slab's accumulator on its
    periodic axes only."""
    r = radius
    a = acc_pad
    if r == 0:
        return a
    for ax in axes:
        core = a.narrow(ax, r, n).clone()
        core.narrow(ax, n - r, r).add_(a.narrow(ax, 0, r))
        core.narrow(ax, 0, r).add_(a.narrow(ax, n + r, r))
        a = core
    return a


def _check_windows(field_pad: torch.Tensor, pos: torch.Tensor, p: int):
    m0, m = field_pad.shape[0], field_pad.shape[-1]
    b = pos.shape[0]
    _check_cuda("field_pad", field_pad, field_pad.dtype, (m0, m, m))
    _check_cuda("pos", pos, torch.int32, (b, 3))
    if pos.device != field_pad.device:
        raise ValueError("pos and field_pad must be on one device")
    if not 1 <= p <= min(m0, m) or b < 1:
        raise ValueError(f"{b} windows of extent {p} in a padded field of "
                         f"shape {tuple(field_pad.shape)}")


# ---------------------------------------------------------------------------
# K4: the window gather
# ---------------------------------------------------------------------------

def window_gather_reference(field_pad: torch.Tensor, pos: torch.Tensor,
                            radius: int) -> torch.Tensor:
    """Plain version of window_gather: one block slice per window."""
    p = 2 * radius + 1
    return torch.stack([field_pad[q0:q0 + p, q1:q1 + p, q2:q2 + p]
                        for q0, q1, q2 in pos.tolist()])


def window_gather(field_pad: torch.Tensor, pos: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """(n+2r)^3 padded field, or a slab's (m+2r, n+2r, n+2r), + (B,3)
    cells (in [0, n), or [0, m) on axis 0) -> (B,p,p,p) windows, p =
    2r+1; the window of cell q has its corner at q in padded
    coordinates, so the source sits at its centre."""
    if field_pad.device.type == "cpu":
        return window_gather_reference(field_pad, pos, radius)
    out = _window_gather(field_pad, pos, radius)
    LAUNCHES[build_for("window_gather", field_pad.dtype).key] += 1
    return out


def _window_gather(field_pad: torch.Tensor, pos: torch.Tensor, radius: int,
                   defines=()) -> torch.Tensor:
    """Launch K4 (the build of field_pad's dtype, with the timing
    `defines` added, none by default) -> the (B,p,p,p) windows."""
    p = 2 * radius + 1
    _check_windows(field_pad, pos, p)
    build = build_for("window_gather", field_pad.dtype)
    lib, fn = _entry("window_gather", _SIGNATURES,
                     build.defines + tuple(defines))
    b = pos.shape[0]
    out = torch.empty((b, p, p, p), dtype=field_pad.dtype,
                      device=field_pad.device)
    stream = torch.cuda.current_stream(field_pad.device).cuda_stream
    rc = fn(field_pad.data_ptr(), field_pad.shape[0], field_pad.shape[-1],
            pos.data_ptr(), b, p, out.data_ptr(), stream)
    _check_rc(lib, rc, "window gather")
    return out


# ---------------------------------------------------------------------------
# K5: the window scatter-add
# ---------------------------------------------------------------------------

def window_scatter_add_reference(acc_pad: torch.Tensor, rates: torch.Tensor,
                                 pos: torch.Tensor) -> torch.Tensor:
    """Plain version of window_scatter_add: one block add per window, in
    window order."""
    p = rates.shape[1]
    for i, (q0, q1, q2) in enumerate(pos.tolist()):
        acc_pad[q0:q0 + p, q1:q1 + p, q2:q2 + p] += rates[i]
    return acc_pad


def window_scatter_add(acc_pad: torch.Tensor, rates: torch.Tensor,
                       pos: torch.Tensor,
                       max_windows: Optional[int] = None) -> torch.Tensor:
    """acc_pad[q_i : q_i+p, ...] += rates_i for every window, IN PLACE
    (the JAX window_scatter_add donates its accumulator); overlapping and
    repeated windows sum, in window order.  Returns acc_pad.

    On the card each cell is summed by the lowest-index window that
    covers it, in window order, so the result is bitwise that of the
    plain version and the same from run to run.  The kernel keeps a list
    of the batch's windows in shared memory, 16 bytes each, so one launch
    takes at most the kernel's own limit (some 13,500 windows on the
    H100 in float32, less in float64; max_windows may lower it).  A
    longer batch goes in consecutive launches in window order
    (scatter_in_chunks): the same sums in the same order, so the same
    bits."""
    if acc_pad.device.type == "cpu":
        return window_scatter_add_reference(acc_pad, rates, pos)
    _check_scatter(acc_pad, rates, pos)
    limit = scatter_limit(acc_pad.device, acc_pad.dtype)
    if max_windows is not None:
        limit = min(limit, max_windows)
    if limit < 1:
        raise RuntimeError(f"window scatter-add: the kernel takes {limit} "
                           "windows per launch on this device")
    LAUNCHES[build_for("window_scatter", acc_pad.dtype).key] += \
        scatter_in_chunks(acc_pad, rates, pos, limit, _window_scatter_add)
    return acc_pad


def scatter_limit(dev: torch.device, dtype=torch.float32) -> int:
    """The windows per launch of the dtype's build on `dev`, asked once
    per device and build."""
    key = (dev.index, dtype)
    limit = _SCATTER_LIMIT.get(key)
    if limit is None:
        build = build_for("window_scatter", dtype)
        with torch.cuda.device(dev):
            limit = _entry("window_scatter_max", _SIGNATURES,
                           build.defines)[1]()
        _SCATTER_LIMIT[key] = limit
    return limit


def scatter_in_chunks(acc_pad: torch.Tensor, rates: torch.Tensor,
                      pos: torch.Tensor, limit: int, launch) -> int:
    """launch(acc_pad, rates[a:b], pos[a:b]) on consecutive chunks of at
    most `limit` windows, in window order; -> the launches made.  Each
    cell's sum acc + rates[w1] + rates[w2] + ... runs left to right in
    window order, so the chunks add the same terms in the same order as
    one call."""
    b = rates.shape[0]
    for lo in range(0, b, limit):
        launch(acc_pad, rates[lo:lo + limit], pos[lo:lo + limit])
    return -(-b // limit)


def _check_scatter(acc_pad: torch.Tensor, rates: torch.Tensor,
                   pos: torch.Tensor) -> None:
    b, p = rates.shape[0], rates.shape[1]
    _check_windows(acc_pad, pos, p)
    _check_cuda("rates", rates, acc_pad.dtype, (b, p, p, p))
    if rates.device != acc_pad.device:
        raise ValueError("rates and acc_pad must be on one device")
    if rates.numel() >= 2**31:
        raise ValueError(f"{b} windows of {p}^3 rates: the kernel's offsets "
                         "into them are 32-bit")


def _window_scatter_add(acc_pad: torch.Tensor, rates: torch.Tensor,
                        pos: torch.Tensor, defines=()) -> None:
    """Launch K5 (the build of acc_pad's dtype, with the timing `defines`
    added, none by default) on acc_pad, in place."""
    _check_scatter(acc_pad, rates, pos)
    b, p = rates.shape[0], rates.shape[1]
    build = build_for("window_scatter", acc_pad.dtype)
    lib, fn = _entry("window_scatter", _SIGNATURES,
                     build.defines + tuple(defines))
    stream = torch.cuda.current_stream(acc_pad.device).cuda_stream
    rc = fn(acc_pad.data_ptr(), acc_pad.shape[0], acc_pad.shape[-1],
            pos.data_ptr(), b, p, rates.data_ptr(), stream)
    _check_rc(lib, rc, f"window scatter-add ({b} windows)")
