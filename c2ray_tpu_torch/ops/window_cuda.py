"""Window gather and scatter-add of the windowed sweep: the hand-written
CUDA kernels and their plain versions.

The port's twin of c2ray_tpu/ops/window_pallas.py:

  window_gather       (csrc/window.cu) <- _gather_kernel, the (2r+1)^3
                                          window at each source's corner
                                          of the padded neutral density
  window_scatter_add  (csrc/window.cu) <- _scatter_kernel, each window's
                                          rate cube added into the padded
                                          accumulator at its corner

The padded field and the accumulator are exactly (n+2r)^3: the TPU's
covering blocks, lane and sublane margins and rotates do not carry over.
fold_padded_acc folds the accumulator's r-wide ring back mod n once per
pass, in plain torch (plain jnp in the JAX package too).

Each wrapper takes its plain PyTorch version (the *_reference function
beside it) only for tensors on the CPU.  For a CUDA tensor it launches the
kernel or raises; it never falls back.  LAUNCHES counts the kernel
launches each wrapper makes.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .sweep_cuda import _check_cuda, _check_rc, _entry

LAUNCHES = {"window_gather": 0, "window_scatter": 0}

_vp, _i = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "window_gather": ("window", "c2r_window_gather",
                      [_vp, _i, _vp, _i, _i, _vp, _vp]),
    "window_scatter": ("window", "c2r_window_scatter_add",
                       [_vp, _i, _vp, _i, _i, _vp, _vp]),
}


def padded_acc_shape(n: int, r: int) -> Tuple[int, int, int]:
    """The padded field's and the accumulator's shape: (n+2r)^3."""
    return (n + 2 * r,) * 3


def fold_padded_acc(acc_pad: torch.Tensor, n: int,
                    radius: int) -> torch.Tensor:
    """Fold the r-wide pad ring of a padded accumulator back into the
    (n,n,n) grid with periodic wrapping, axis by axis: the low pad adds
    to the high end, the high pad to the low end (the JAX
    fold_padded_acc)."""
    r = radius
    a = acc_pad
    if r == 0:
        return a
    for ax in range(3):
        core = a.narrow(ax, r, n).clone()
        core.narrow(ax, n - r, r).add_(a.narrow(ax, 0, r))
        core.narrow(ax, 0, r).add_(a.narrow(ax, n + r, r))
        a = core
    return a


def _check_windows(field_pad: torch.Tensor, pos: torch.Tensor, p: int):
    m = field_pad.shape[0]
    b = pos.shape[0]
    _check_cuda("field_pad", field_pad, torch.float32, (m, m, m))
    _check_cuda("pos", pos, torch.int32, (b, 3))
    if pos.device != field_pad.device:
        raise ValueError("pos and field_pad must be on one device")
    if not 1 <= p <= m or b < 1:
        raise ValueError(f"{b} windows of extent {p} in a padded field of "
                         f"extent {m}")


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
    """(n+2r)^3 padded field + (B,3) grid cells in [0, n) -> (B,p,p,p)
    windows, p = 2r+1; the window of cell q has its corner at q in padded
    coordinates, so the source sits at its centre."""
    if field_pad.device.type == "cpu":
        return window_gather_reference(field_pad, pos, radius)
    out = _window_gather(field_pad, pos, radius)
    LAUNCHES["window_gather"] += 1
    return out


def _window_gather(field_pad: torch.Tensor, pos: torch.Tensor, radius: int,
                   defines=()) -> torch.Tensor:
    """Launch K4 (from the library built with `defines`, the shipped one
    by default) -> the (B,p,p,p) windows."""
    p = 2 * radius + 1
    _check_windows(field_pad, pos, p)
    lib, fn = _entry("window_gather", _SIGNATURES, defines)
    b = pos.shape[0]
    out = torch.empty((b, p, p, p), dtype=torch.float32,
                      device=field_pad.device)
    stream = torch.cuda.current_stream(field_pad.device).cuda_stream
    rc = fn(field_pad.data_ptr(), field_pad.shape[0], pos.data_ptr(), b, p,
            out.data_ptr(), stream)
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
                       pos: torch.Tensor) -> torch.Tensor:
    """acc_pad[q_i : q_i+p, ...] += rates_i for every window, IN PLACE
    (the JAX window_scatter_add donates its accumulator); overlapping and
    repeated windows sum, in window order.  Returns acc_pad.

    On the card each cell is summed by the lowest-index window that
    covers it, in window order, so the result is bitwise that of the
    plain version and the same from run to run.  The kernel keeps a list
    of the batch's windows in shared memory, 16 bytes each, beside the
    terms it has in flight: a batch whose list does not fit the card's
    per-block opt-in (some 13,500 windows on the H100) raises."""
    if acc_pad.device.type == "cpu":
        return window_scatter_add_reference(acc_pad, rates, pos)
    _window_scatter_add(acc_pad, rates, pos)
    LAUNCHES["window_scatter"] += 1
    return acc_pad


def _window_scatter_add(acc_pad: torch.Tensor, rates: torch.Tensor,
                        pos: torch.Tensor, defines=()) -> None:
    """Launch K5 (from the library built with `defines`, the shipped one
    by default) on acc_pad, in place."""
    b, p = rates.shape[0], rates.shape[1]
    _check_windows(acc_pad, pos, p)
    _check_cuda("rates", rates, torch.float32, (b, p, p, p))
    if rates.device != acc_pad.device:
        raise ValueError("rates and acc_pad must be on one device")
    if rates.numel() >= 2**31:
        raise ValueError(f"{b} windows of {p}^3 rates: the kernel's offsets "
                         "into them are 32-bit")
    lib, fn = _entry("window_scatter", _SIGNATURES, defines)
    stream = torch.cuda.current_stream(acc_pad.device).cuda_stream
    rc = fn(acc_pad.data_ptr(), acc_pad.shape[0], pos.data_ptr(), b, p,
            rates.data_ptr(), stream)
    _check_rc(lib, rc, f"window scatter-add ({b} windows)")
