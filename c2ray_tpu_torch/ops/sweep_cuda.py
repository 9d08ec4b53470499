"""Hand-written CUDA kernels of the sweep and their plain versions.

The port's twin of c2ray_tpu/ops/sweep_pallas.py:

  compute_columns_grid     (csrc/march.cu)   <- _kernel_grid, the grid-
                                                frame column march (full
                                                radius or radius-capped)
  compute_columns_windows  (csrc/march.cu)   <- _kernel, the same march
                                                on source-centred windows
  consume_rates            (csrc/consume.cu) <- _kernel_consume, the fused
                                                rate deposition (with its
                                                has_heat branch in the
                                                non-isothermal build)

Every branch of the three Pallas kernels has its build: LLS off, a scalar
LLS column (type 1) or a grid LLS cube (type 2, has_lls) in the marches
and the deposition; the R_max barrier (type 3) and the X-ray mixture
(use_xray) in the deposition.

Each wrapper takes its plain PyTorch version (the *_reference function
beside it) only for tensors on the CPU.  For a CUDA tensor it launches the
kernel or raises; it never falls back.  LAUNCHES counts the kernel launches
each wrapper makes, by build: "march" and "window_march" the marches
without a grid LLS cube, "march_lls" and "window_march_lls" with one;
"consume" the deposition's isothermal build without a grid LLS cube or
X-ray, and "consume" + "_lls" (grid LLS) or "_rmax" (the R_max barrier of
type 3) + "_xray" + "_heat" the others.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..config import RunConfig
from .sweep import (MAX_BATCH, SweepScalars, _rate_pass, march_columns,
                    march_windows, roll3)
from .tables import RadTables, use_expsum


def _consume_key(lls: str, xray: bool, heat: bool) -> str:
    """lls: "" (LLS off or a scalar column), "_lls" (a grid LLS cube) or
    "_rmax" (the R_max barrier)."""
    return ("consume" + lls + ("_xray" if xray else "")
            + ("_heat" if heat else ""))


LAUNCHES = {"march": 0, "march_lls": 0, "window_march": 0,
            "window_march_lls": 0,
            **{_consume_key(g, x, h): 0 for g in ("", "_lls", "_rmax")
               for x in (False, True) for h in (False, True)}}

# the most sources one launch takes (CUDA's grid z extent)
MAX_WINDOWS = 65535

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel -> (library, C symbol, argument types)
_SIGNATURES = {
    "march": ("march", "c2r_march",
              [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _f, _f, _i, _vp, _vp,
               _vp, _vp, _vp]),
    "window_march": ("march", "c2r_march_windows",
                     [_vp, _vp, _i, _i, _i, _f, _f, _i, _vp, _vp, _vp,
                      _vp]),
    # 1 if the window march runs its cluster form at window extent p, 0
    # for the per-shell form: the kernel's own choice
    "window_march_cluster": ("march", "c2r_march_windows_cluster", [_i]),
    "consume": ("consume", "c2r_consume",
                [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _vp, _vp,
                 _vp, _i, _i, _i, _i, _f, _f, _f, _i, _i, _i, _f, _f, _vp,
                 _vp, _vp, _vp, _vp]),
    # blocks of the consume kernel's cell launch at mesh n: the size of
    # its loss partials, from the kernel's own launch shape
    "consume_nblocks": ("consume", "c2r_consume_nblocks", [_i]),
}


def _entry(name: str, signatures=_SIGNATURES, defines=()):
    lib_name, sym, argtypes = signatures[name]
    lib = _build.load(lib_name, defines)
    fn = getattr(lib, sym)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.c2r_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def _check_cuda(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _slice_options(cfg: RunConfig) -> None:
    """The options the kernels implement: isothermal or not (the consume
    kernel's heat build), LLS off or types 1-3, X-ray sources or not,
    mixture (expsum) rates in float32."""
    if cfg.use_lls and cfg.type_of_lls not in (1, 2, 3):
        raise NotImplementedError(
            f"LLS type {cfg.type_of_lls} has no CUDA kernel")
    if not use_expsum(cfg, torch.float32):
        raise NotImplementedError(
            f"rate_eval={cfg.rate_eval!r} runs only on the CPU; the CUDA "
            "kernel evaluates the exponential mixture")


def _rmax_on(cfg: RunConfig) -> bool:
    """LLS type 3: each ray stops at the R_max barrier."""
    return cfg.use_lls and cfg.type_of_lls == 3


def _lls_mode(cfg: RunConfig, lls) -> int:
    """The LLS column a cell adds, as the kernels take it: 0 none, 1 the
    scalar sc.lls_coldens, 2 the grid cube (LLS types 1 and 2 add a
    column, the grid's where one is given, as in ops/sweep._rate_pass)."""
    if not (cfg.use_lls and cfg.type_of_lls in (1, 2)):
        return 0
    return 2 if lls is not None else 1


# ---------------------------------------------------------------------------
# K1: the grid-frame column march
# ---------------------------------------------------------------------------

def compute_columns_grid_reference(cfg: RunConfig, ndhi: torch.Tensor,
                                   srcpos_b: torch.Tensor, sc: SweepScalars,
                                   max_shell: int,
                                   lls: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Plain version of compute_columns_grid (ops/sweep.march_columns)."""
    return march_columns(cfg, ndhi, srcpos_b, sc, max_shell, lls)


def compute_columns_grid(cfg: RunConfig, ndhi: torch.Tensor,
                         srcpos_b: torch.Tensor, sc: SweepScalars,
                         max_shell: int,
                         lls: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,N,N) grid-frame neutral density + (B,3) source cells ->
    (B,N,N,N) source-centred coldensh_out, the output of the JAX
    compute_columns_pallas_grid; with max_shell < N/2 the march stops
    there and the cells beyond read zero (what the JAX
    compute_columns_pallas gives on its radius-capped patch).  lls: the
    (N,N,N) grid LLS columns (type 2), read through the density's views,
    or None."""
    if ndhi.device.type == "cpu":
        return compute_columns_grid_reference(cfg, ndhi, srcpos_b, sc,
                                              max_shell, lls)
    out, launches = _grid_march(cfg, ndhi, srcpos_b, sc, max_shell,
                                lls=lls)
    LAUNCHES["march_lls" if _lls_mode(cfg, lls) == 2 else "march"] += \
        launches
    return out


def _grid_march(cfg: RunConfig, ndhi: torch.Tensor, srcpos_b: torch.Tensor,
                sc: SweepScalars, max_shell: int, defines=(),
                lls: Optional[torch.Tensor] = None):
    """Launch K1 (from the library built with `defines`, the shipped one
    by default) -> (out, kernel launches made)."""
    n = ndhi.shape[0]
    b = srcpos_b.shape[0]
    _check_cuda("ndhi", ndhi, torch.float32, (n, n, n))
    _check_cuda("srcpos_b", srcpos_b, torch.int32, (b, 3))
    if srcpos_b.device != ndhi.device:
        raise ValueError("srcpos_b and ndhi must be on one device")
    mode = _lls_mode(cfg, lls)
    if mode == 2:
        _check_cuda("lls", lls, torch.float32, (n, n, n))
        if lls.device != ndhi.device:
            raise ValueError("lls and ndhi must be on one device")
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch of {b} sources; the march takes "
                         f"1..{MAX_BATCH}")
    _slice_options(cfg)
    nshell = _shells(max_shell, n)
    lib, fn = _entry("march", defines=defines)
    out = _columns_out((b, n, n, n), nshell, ndhi.device)
    # zero-filled: a shell reads corners just outside the previous shell's
    # live square (with zero weight), which must hold finite values
    planes = torch.zeros((2, b, 6, n, n), dtype=torch.float32,
                         device=ndhi.device)
    # the z faces' cells, z-major, before their transpose into out
    zst = torch.empty((b, n, n, n), dtype=torch.float32, device=ndhi.device)
    ndhi_zt = ndhi.permute(2, 0, 1).contiguous()     # [z][x][y]
    # the LLS cube's z-major copy, made as the density's
    lls_zt = lls.permute(2, 0, 1).contiguous() if mode == 2 else None
    stream = torch.cuda.current_stream(ndhi.device).cuda_stream
    launches = ctypes.c_int(0)
    rc = fn(ndhi.data_ptr(), ndhi_zt.data_ptr(),
            lls.data_ptr() if mode == 2 else None,
            lls_zt.data_ptr() if mode == 2 else None, srcpos_b.data_ptr(),
            b, n, nshell, sc.dr, sc.lls_coldens, mode, planes.data_ptr(),
            zst.data_ptr(), out.data_ptr(), ctypes.byref(launches), stream)
    _check_rc(lib, rc, "march")
    return out, launches.value


def _shells(max_shell: int, n: int) -> int:
    """Shells the march runs: min(max_shell, n/2), at least one."""
    if max_shell < 1:
        raise ValueError(f"max_shell {max_shell}: the march needs >= 1")
    return min(max_shell, n // 2)


def _columns_out(shape, nshell: int, dev) -> torch.Tensor:
    """The march's output cube: cells beyond a capped radius are never
    written and must read zero, as in the plain version."""
    if nshell < shape[-1] // 2:
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return torch.empty(shape, dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# K3: the march on source-centred windows
# ---------------------------------------------------------------------------

def compute_columns_windows_reference(cfg: RunConfig, wins: torch.Tensor,
                                      sc: SweepScalars, max_shell: int,
                                      lls_wins: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """Plain version of compute_columns_windows (ops/sweep.march_windows)."""
    return march_windows(cfg, wins, sc, max_shell, lls_wins)


def compute_columns_windows(cfg: RunConfig, wins: torch.Tensor,
                            sc: SweepScalars, max_shell: int,
                            lls_wins: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """(B,p,p,p) source-centred neutral-density windows -> (B,p,p,p)
    coldensh_out, marched to min(max_shell, p/2) shells (the JAX
    compute_columns_pallas on the windowed path).  lls_wins: the grid LLS
    columns' windows at the same corners (type 2), or None."""
    if wins.device.type == "cpu":
        return compute_columns_windows_reference(cfg, wins, sc, max_shell,
                                                 lls_wins)
    out, launches = _window_march(cfg, wins, sc, max_shell,
                                  lls_wins=lls_wins)
    LAUNCHES["window_march_lls" if _lls_mode(cfg, lls_wins) == 2
             else "window_march"] += launches
    return out


def _window_march(cfg: RunConfig, wins: torch.Tensor, sc: SweepScalars,
                  max_shell: int, defines=(),
                  lls_wins: Optional[torch.Tensor] = None):
    """Launch K3 (from the library built with `defines`, the shipped one
    by default) -> (out, kernel launches made)."""
    b, p = wins.shape[0], wins.shape[-1]
    _check_cuda("wins", wins, torch.float32, (b, p, p, p))
    mode = _lls_mode(cfg, lls_wins)
    if mode == 2:
        _check_cuda("lls_wins", lls_wins, torch.float32, (b, p, p, p))
        if lls_wins.device != wins.device:
            raise ValueError("lls_wins and wins must be on one device")
    if not 1 <= b <= MAX_WINDOWS:
        raise ValueError(f"batch of {b} windows; the march takes "
                         f"1..{MAX_WINDOWS}")
    _slice_options(cfg)
    nshell = _shells(max_shell, p)
    lib, fn = _entry("window_march", defines=defines)
    out = _columns_out((b, p, p, p), nshell, wins.device)
    # the per-shell form's ping-pong planes (the cluster form keeps its
    # planes in shared memory and ignores these)
    planes = torch.empty((2, b, 6, p, p), dtype=torch.float32,
                         device=wins.device)
    stream = torch.cuda.current_stream(wins.device).cuda_stream
    launches = ctypes.c_int(0)
    rc = fn(wins.data_ptr(), lls_wins.data_ptr() if mode == 2 else None, b,
            p, nshell, sc.dr, sc.lls_coldens, mode, planes.data_ptr(),
            out.data_ptr(), ctypes.byref(launches), stream)
    _check_rc(lib, rc, "window march")
    return out, launches.value


# ---------------------------------------------------------------------------
# K2: the fused rate deposition
# ---------------------------------------------------------------------------

def consume_rates_reference(cfg: RunConfig, tables: RadTables,
                            cdo_b: torch.Tensor, ndhi: torch.Tensor,
                            srcpos_b: torch.Tensor, nflux_b: torch.Tensor,
                            sc: SweepScalars, max_shell: int,
                            lls_grid: Optional[torch.Tensor] = None,
                            nfx_b: Optional[torch.Tensor] = None):
    """Plain version of consume_rates: per source, _rate_pass on the
    centred fields, rolled back to grid frame, summed over the batch."""
    n = ndhi.shape[0]
    c = n // 2
    phih = torch.zeros_like(ndhi)
    phiheat = None if cfg.isothermal else torch.zeros_like(ndhi)
    loss, lls = [], []
    for i, p in enumerate(srcpos_b.tolist()):
        to_centre = [c - q for q in p]
        ndhi_c = roll3(ndhi, to_centre)
        lls_c = roll3(lls_grid, to_centre) if lls_grid is not None else None
        res = _rate_pass(cfg, tables, cdo_b[i], ndhi_c, nflux_b[i], sc, lls_c,
                         max_shell,
                         nflux_xray=nfx_b[i] if nfx_b is not None else None)
        back = [q - c for q in p]
        phih = phih + roll3(res.phih, back)
        if phiheat is not None:
            phiheat = phiheat + roll3(res.phiheat, back)
        loss.append(res.photon_loss)
        lls.append(res.lls_loss)
    return phih, phiheat, torch.stack(loss), torch.stack(lls)


def consume_key(cfg: RunConfig, lls_grid, nfx_b) -> str:
    """The LAUNCHES key of the deposition build these arguments run."""
    lls = ("_lls" if _lls_mode(cfg, lls_grid) == 2
           else "_rmax" if _rmax_on(cfg) else "")
    return _consume_key(lls, cfg.sed.use_xray_sed and nfx_b is not None,
                        not cfg.isothermal)


def consume_rates(cfg: RunConfig, tables: RadTables, cdo_b: torch.Tensor,
                  ndhi: torch.Tensor, srcpos_b: torch.Tensor,
                  nflux_b: torch.Tensor, sc: SweepScalars, max_shell: int,
                  lls_grid: Optional[torch.Tensor] = None,
                  nfx_b: Optional[torch.Tensor] = None):
    """Centred column cubes (B,N,N,N) -> (phih, phiheat, loss_b,
    lls_loss_b): grid-frame per-atom rate and heating cubes summed over
    the batch, and per-source boundary and LLS photon losses (the JAX
    consume_rates_pallas).  phiheat is None when cfg is isothermal; a
    non-isothermal cfg runs the kernel's heat build.  lls_grid: the
    (N,N,N) grid-frame LLS columns (type 2), or None; nfx_b: (B,) X-ray
    fluxes, used when cfg.sed.use_xray_sed, or None.  LLS type 3 stops
    each ray at sc.rmax2_cells."""
    if cdo_b.device.type == "cpu":
        return consume_rates_reference(cfg, tables, cdo_b, ndhi, srcpos_b,
                                       nflux_b, sc, max_shell, lls_grid,
                                       nfx_b)
    _slice_options(cfg)
    b, n = cdo_b.shape[0], cdo_b.shape[1]
    _check_cuda("cdo_b", cdo_b, torch.float32, (b, n, n, n))
    _check_cuda("ndhi", ndhi, torch.float32, (n, n, n))
    _check_cuda("srcpos_b", srcpos_b, torch.int32, (b, 3))
    _check_cuda("nflux_b", nflux_b, torch.float32, (b,))
    k = tables.exp_a.shape[0]
    _check_cuda("tables.exp_a", tables.exp_a, torch.float32, (k,))
    _check_cuda("tables.exp_w", tables.exp_w, torch.float32, (k,))
    heat = not cfg.isothermal
    if heat:
        _check_cuda("tables.heat_exp_w", tables.heat_exp_w, torch.float32,
                    (k,))
    mode = _lls_mode(cfg, lls_grid)
    xray = cfg.sed.use_xray_sed and nfx_b is not None
    kx = tables.xray_exp_a.shape[0] if xray else 0
    checks = [("ndhi", ndhi), ("srcpos_b", srcpos_b), ("nflux_b", nflux_b),
              ("tables", tables.exp_a)]
    if mode == 2:
        _check_cuda("lls_grid", lls_grid, torch.float32, (n, n, n))
        checks.append(("lls_grid", lls_grid))
    if xray:
        _check_cuda("nfx_b", nfx_b, torch.float32, (b,))
        _check_cuda("tables.xray_exp_a", tables.xray_exp_a, torch.float32,
                    (kx,))
        _check_cuda("tables.xray_exp_w", tables.xray_exp_w, torch.float32,
                    (kx,))
        if heat:
            _check_cuda("tables.xray_heat_exp_w", tables.xray_heat_exp_w,
                        torch.float32, (kx,))
        checks += [("nfx_b", nfx_b), ("xray tables", tables.xray_exp_a)]
    dev = cdo_b.device
    for name, t in checks:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cdo_b on {dev}")
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch of {b} sources; the consume kernel takes "
                         f"1..{MAX_BATCH}")
    lib, fn = _entry("consume")
    nblocks = _entry("consume_nblocks")[1](n)
    phih = torch.empty((n, n, n), dtype=torch.float32, device=dev)
    phiheat = (torch.empty((n, n, n), dtype=torch.float32, device=dev)
               if heat else None)
    partial = torch.empty((2, b, nblocks), dtype=torch.float32, device=dev)
    loss = torch.empty((2, b), dtype=torch.float32, device=dev)
    # the R_max barrier: +inf lets every ray through (no type 3)
    rmax2 = sc.rmax2_cells if _rmax_on(cfg) else float("inf")

    def ptr(t, use=True):
        return t.data_ptr() if use else None

    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(cdo_b.data_ptr(), ndhi.data_ptr(), ptr(lls_grid, mode == 2),
            srcpos_b.data_ptr(), nflux_b.data_ptr(), ptr(nfx_b, xray),
            tables.exp_a.data_ptr(), tables.exp_w.data_ptr(),
            ptr(tables.heat_exp_w, heat), k, ptr(tables.xray_exp_a, xray),
            ptr(tables.xray_exp_w, xray),
            ptr(tables.xray_heat_exp_w, xray and heat), kx, b, n,
            max_shell, sc.dr, sc.rate_scale, sc.lls_coldens, mode,
            int(heat), int(xray), rmax2, cfg.max_coldensh, phih.data_ptr(),
            ptr(phiheat, heat), partial.data_ptr(), loss.data_ptr(), stream)
    _check_rc(lib, rc, "consume")
    LAUNCHES[consume_key(cfg, lls_grid, nfx_b)] += 2
    return phih, phiheat, loss[0], loss[1]
