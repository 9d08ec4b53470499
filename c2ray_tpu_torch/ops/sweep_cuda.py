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
  window_rates             (csrc/consume.cu) <- no Pallas kernel: the
                                                vmapped _rate_pass of the
                                                JAX windowed_batch, as the
                                                deposition's window mode
  window_sweep        (csrc/window_sweep.cu) <- _kernel and then that
                                                vmapped _rate_pass, fused:
                                                the window march with the
                                                rate pass as its per-cell
                                                epilogue, where it fits a
                                                block (window_sweep_fits)

Every branch of the three Pallas kernels has its build: LLS off, a scalar
LLS column (type 1) or a grid LLS cube (type 2, has_lls) in the marches
and the deposition; the R_max barrier (type 3) and the X-ray mixture
(use_xray) in the deposition.  Each kernel is built in float32 and in
float64, and the deposition with the exponential mixture or with the
lookup tables of rate_eval "table" (the mode "auto" picks in float64);
build_for maps a kernel, a dtype and the options to its build.

Each wrapper takes its plain PyTorch version (the *_reference function
beside it) only for tensors on the CPU.  For a CUDA tensor it launches the
kernel or raises; it never falls back.  LAUNCHES (launches.LaunchCounts:
counted on the card, so a CUDA graph's replays count too) counts the
kernel launches each wrapper makes, by build (build_for's key): "march" and
"window_march" the marches without a grid LLS cube, + "_lls" with one;
"consume" the deposition's isothermal mixture build without a grid LLS
cube or X-ray, + "_table" (table rates), "_lls" (grid LLS) or "_rmax"
(the R_max barrier of type 3), "_xray" and "_heat" the others, and
"window_rates" its window mode and "window_sweep" the fused window
sweep with the same suffixes; every
float64 build has "_f64" after the kernel's name (and "_table"), as
"march_f64_lls" or "consume_table_f64_heat".
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from .. import _build
from ..config import RunConfig
from .launches import LaunchCounts
from .sweep import (MAX_BATCH, SweepScalars, _rate_pass, march_columns,
                    march_windows, roll3)
from .tables import RadTables, thin_limits, use_expsum

# the kernel builds' element types: (dtype, LAUNCHES key suffix, -D flags)
_DTYPES = {torch.float32: ("", ()), torch.float64: ("_f64", ("C2R_F64",))}
# the wrappers' kernels -> their csrc/ source
_SOURCES = {"march": "march", "window_march": "march", "consume": "consume",
            "window_rates": "consume", "window_sweep": "window_sweep",
            "window_gather": "window",
            "window_scatter": "window", "chemistry": "chemistry"}
# the kernels that evaluate the rate pass (K2's grid and window modes, the
# fused window sweep): their builds follow the rate mode, the R_max
# barrier, X-ray and heat
_RATE_KERNELS = ("consume", "window_rates", "window_sweep")


class Build(NamedTuple):
    """One build of a kernel: the csrc/ source, its -D flags (the library
    _build.load compiles at first use) and its LAUNCHES key."""

    source: str
    defines: tuple
    key: str


def _build_key(kernel: str, dtype, table=False, lls="", xray=False,
               heat=False) -> Build:
    """lls: "" (LLS off or a scalar column), "_lls" (a grid LLS cube) or
    "_rmax" (the R_max barrier, the deposition only)."""
    if dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernels take float32 or float64, not "
                         f"{dtype}")
    suffix, defines = _DTYPES[dtype]
    if table:
        suffix, defines = "_table" + suffix, defines + ("C2R_TABLE",)
    key = (kernel + suffix + lls + ("_xray" if xray else "")
           + ("_heat" if heat else ""))
    return Build(_SOURCES[kernel], defines, key)


def build_for(kernel: str, dtype, cfg: Optional[RunConfig] = None,
              grid_lls: bool = False, xray: bool = False) -> Build:
    """The build that runs `kernel` ("march", "window_march", "consume",
    "window_rates", "window_sweep", "window_gather", "window_scatter") on
    tensors of `dtype` for cfg's options: grid_lls, a grid LLS cube given
    (the marches, the deposition's two modes and the window sweep); xray,
    X-ray fluxes given (taken where cfg.sed.use_xray_sed).  The kernels of
    the rate pass take cfg's rate mode (use_expsum), R_max barrier (LLS
    type 3) and heat (not isothermal)."""
    if kernel in ("window_gather", "window_scatter"):
        return _build_key(kernel, dtype)
    lls = "_lls" if grid_lls and _lls_mode(cfg, True) == 2 else ""
    if kernel not in _RATE_KERNELS:
        return _build_key(kernel, dtype, lls=lls)
    if not lls and _rmax_on(cfg):
        lls = "_rmax"
    return _build_key(kernel, dtype, table=not use_expsum(cfg, dtype),
                      lls=lls, xray=cfg.sed.use_xray_sed and xray,
                      heat=not cfg.isothermal)


LAUNCHES = LaunchCounts(
    [_build_key(k, d, lls=g).key for k in ("march", "window_march")
     for d in _DTYPES for g in ("", "_lls")]
    + [_build_key(k, d, t, g, x, h).key for k in _RATE_KERNELS
       for d in _DTYPES for t in (False, True) for g in ("", "_lls", "_rmax")
       for x in (False, True) for h in (False, True)])

# the most sources one launch takes (CUDA's grid z extent)
MAX_WINDOWS = 65535

_vp, _i, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# kernel -> (library, C symbol, argument types); every build of a library
# has the same C signature (scalars as doubles, arrays as pointers)
_SIGNATURES = {
    "march": ("march", "c2r_march",
              [_vp, _vp, _vp, _i, _i, _i, _d, _d, _vp, _vp, _i, _vp, _vp,
               _vp, _vp, _vp]),
    # grid mode's edge buffer per source at mesh n, and its launches per
    # call to nshell shells: the kernel's own schedule
    "march_grid_edge": ("march", "c2r_march_grid_edge", [_i]),
    "march_grid_launches": ("march", "c2r_march_grid_launches", [_i, _i]),
    "window_march": ("march", "c2r_march_windows",
                     [_vp, _vp, _i, _i, _i, _d, _d, _i, _vp, _vp, _vp,
                      _vp]),
    # 1 if the window march runs its cluster form at window extent p, 0
    # for the per-shell form: the kernel's own choice
    "window_march_cluster": ("march", "c2r_march_windows_cluster", [_i]),
    "consume": ("consume", "c2r_consume",
                [_vp, _vp, _vp, _vp, _vp, _vp,
                 ctypes.POINTER(ctypes.c_void_p), _i, _i, _i, _i, _i, _i,
                 _d, _d, _d, _d, ctypes.POINTER(ctypes.c_void_p), _i, _i, _i,
                 _d, _d, _d, _d, _d, _vp, _vp, _vp, _vp, _vp]),
    # blocks of the consume kernel's cell launch at mesh n: the size of
    # its loss partials, from the kernel's own launch shape
    "consume_nblocks": ("consume", "c2r_consume_nblocks", [_i]),
    "window_rates": ("consume", "c2r_consume_windows",
                     [_vp, _vp, _vp, _vp, _vp,
                      ctypes.POINTER(ctypes.c_void_p), _i, _i, _i, _i, _i,
                      _i, _d, _d, _d, _d, ctypes.POINTER(ctypes.c_void_p),
                      _i, _i, _i, _d, _d, _d, _d, _d, _vp, _vp, _vp, _vp,
                      _vp]),
    # blocks of one window's cells in the window launch at extent p
    "window_rates_nblocks": ("consume", "c2r_consume_windows_nblocks",
                             [_i]),
    "window_sweep": ("window_sweep", "c2r_window_sweep",
                     [_vp, _vp, _vp, _vp, ctypes.POINTER(ctypes.c_void_p),
                      _i, _i, _i, _i, _i, _i, _d, _d, _d, _d,
                      ctypes.POINTER(ctypes.c_void_p), _i, _i, _i, _d, _d,
                      _d, _d, _d, _vp, _vp, _vp, _vp]),
    # 1 if the window sweep runs at extent p with these terms, heat and
    # X-ray: the kernel's own fit rule
    "window_sweep_fits": ("window_sweep", "c2r_window_sweep_fits",
                          [_i, _i, _i, _i, _i]),
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


def step_scalar(name: str, x, dev: torch.device):
    """A per-step scalar for a kernel -> (value, pointer): a Python number
    goes by value (pointer None); a one-element float64 tensor on `dev`
    goes by its address, and the kernel reads it at launch, so a captured
    CUDA graph reads the value it holds at each replay (value 0.0)."""
    if not isinstance(x, torch.Tensor):
        return float(x), None
    if x.device != dev or x.dtype != torch.float64 or x.numel() != 1:
        raise ValueError(f"{name}: a per-step scalar tensor must hold one "
                         f"float64 on {dev}, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")
    return 0.0, x.data_ptr()


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
    mixture or table rates, float32 or float64 (build_for)."""
    if cfg.use_lls and cfg.type_of_lls not in (1, 2, 3):
        raise NotImplementedError(
            f"LLS type {cfg.type_of_lls} has no CUDA kernel")


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
    LAUNCHES.add(build_for("march", ndhi.dtype, cfg, lls is not None).key,
                 launches, ndhi.device)
    return out


def _grid_march(cfg: RunConfig, ndhi: torch.Tensor, srcpos_b: torch.Tensor,
                sc: SweepScalars, max_shell: int,
                lls: Optional[torch.Tensor] = None):
    """Launch K1 (the build of ndhi's dtype) -> (out, kernel launches
    made)."""
    n = ndhi.shape[0]
    b = srcpos_b.shape[0]
    build = build_for("march", ndhi.dtype, cfg, lls is not None)
    dtype = ndhi.dtype
    _check_cuda("ndhi", ndhi, dtype, (n, n, n))
    _check_cuda("srcpos_b", srcpos_b, torch.int32, (b, 3))
    if srcpos_b.device != ndhi.device:
        raise ValueError("srcpos_b and ndhi must be on one device")
    mode = _lls_mode(cfg, lls)
    if mode == 2:
        _check_cuda("lls", lls, dtype, (n, n, n))
        if lls.device != ndhi.device:
            raise ValueError("lls and ndhi must be on one device")
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch of {b} sources; the march takes "
                         f"1..{MAX_BATCH}")
    _slice_options(cfg)
    nshell = _shells(max_shell, n)
    lib, fn = _entry("march", defines=build.defines)
    edge_len = _entry("march_grid_edge", defines=build.defines)[1](n)
    out = _columns_out((b, n, n, n), nshell, ndhi)
    # the two plane sets of the shell groups and the faces' boundary rings
    # of the last shells (the kernel reads only what it wrote: no fill)
    planes = torch.empty((2, b, 6, n, n), dtype=dtype, device=ndhi.device)
    edge = torch.empty((b, edge_len), dtype=dtype, device=ndhi.device)
    stream = torch.cuda.current_stream(ndhi.device).cuda_stream
    launches = ctypes.c_int(0)
    dr, dr_p = step_scalar("sc.dr", sc.dr, ndhi.device)
    lcol, lcol_p = step_scalar("sc.lls_coldens", sc.lls_coldens, ndhi.device)
    rc = fn(ndhi.data_ptr(), lls.data_ptr() if mode == 2 else None,
            srcpos_b.data_ptr(), b, n, nshell, dr, lcol, dr_p, lcol_p, mode,
            planes.data_ptr(), edge.data_ptr(), out.data_ptr(),
            ctypes.byref(launches), stream)
    _check_rc(lib, rc, "march")
    return out, launches.value


def grid_march_launches(max_shell: int, n: int, dtype) -> int:
    """K1's launches per compute_columns_grid call at mesh n to max_shell
    shells, in the build of dtype: one, where the stages of its schedule
    fit a launch's arguments (csrc/march.cu grid_launches)."""
    build = _build_key("march", dtype)
    return _entry("march_grid_launches",
                  defines=build.defines)[1](n, _shells(max_shell, n))


def _shells(max_shell: int, n: int) -> int:
    """Shells the march runs: min(max_shell, n/2), at least one."""
    if max_shell < 1:
        raise ValueError(f"max_shell {max_shell}: the march needs >= 1")
    return min(max_shell, n // 2)


def _columns_out(shape, nshell: int, like: torch.Tensor) -> torch.Tensor:
    """The march's output cube, of like's dtype and device: cells beyond a
    capped radius are never written and must read zero, as in the plain
    version."""
    make = torch.zeros if nshell < shape[-1] // 2 else torch.empty
    return make(shape, dtype=like.dtype, device=like.device)


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
    LAUNCHES.add(build_for("window_march", wins.dtype, cfg,
                           lls_wins is not None).key, launches, wins.device)
    return out


def _window_march(cfg: RunConfig, wins: torch.Tensor, sc: SweepScalars,
                  max_shell: int, defines=(),
                  lls_wins: Optional[torch.Tensor] = None):
    """Launch K3 (the build of wins' dtype, with the timing `defines`
    added, none by default) -> (out, kernel launches made)."""
    b, p = wins.shape[0], wins.shape[-1]
    build = build_for("window_march", wins.dtype, cfg, lls_wins is not None)
    _check_cuda("wins", wins, wins.dtype, (b, p, p, p))
    mode = _lls_mode(cfg, lls_wins)
    if mode == 2:
        _check_cuda("lls_wins", lls_wins, wins.dtype, (b, p, p, p))
        if lls_wins.device != wins.device:
            raise ValueError("lls_wins and wins must be on one device")
    if not 1 <= b <= MAX_WINDOWS:
        raise ValueError(f"batch of {b} windows; the march takes "
                         f"1..{MAX_WINDOWS}")
    _slice_options(cfg)
    nshell = _shells(max_shell, p)
    lib, fn = _entry("window_march", defines=build.defines + tuple(defines))
    out = _columns_out((b, p, p, p), nshell, wins)
    # the per-shell form's ping-pong planes (the cluster form keeps its
    # planes in shared memory and ignores these)
    planes = torch.empty((2, b, 6, p, p), dtype=wins.dtype,
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


def _rate_args(cfg: RunConfig, tables: RadTables, sc: SweepScalars, dtype,
               dev: torch.device, xray: bool):
    """The arguments K2's two modes share, checked: the rate tables the
    build reads (8 pointers, in csrc/consume.cu's order) and their term
    counts K, Kx; the per-step scalars dr, rate_scale, lls_coldens and
    rmax2 as (values, 4 pointers) (the R_max barrier +inf, which lets
    every ray through, unless LLS type 3); the table scalars."""
    table = not use_expsum(cfg, dtype)
    heat = not cfg.isothermal
    if table:
        names = ["photo_thick", "photo_thin"] + (
            ["heat_thick", "heat_thin"] if heat else [None, None])
        names += ([f"xray_{x}" if x else None for x in names] if xray
                  else [None] * 4)
    else:
        names = ["exp_a", "exp_w", "heat_exp_w" if heat else None]
        names += ([f"xray_{x}" if x else None for x in names] if xray
                  else [None] * 3)
        names += [None, None]
    k, kx = _term_counts(cfg, tables, dtype, xray)
    tabs = [getattr(tables, x) if x else None for x in names]
    for name, t in zip(names, tabs):
        if t is not None:
            _check_cuda(f"tables.{name}", t, dtype,
                        (kx if name.startswith("xray") else k,))
            if t.device != dev:
                raise ValueError(f"tables.{name} is on {t.device}, the "
                                 f"columns on {dev}")
    step = [step_scalar(f"sc.{f}", getattr(sc, f), dev)
            for f in ("dr", "rate_scale", "lls_coldens", "rmax2_cells")]
    if not _rmax_on(cfg):
        step[3] = (float("inf"), None)
    photo_limit, heat_limit = thin_limits(cfg, dtype)
    dlogtau = (cfg.maxlogtau - cfg.minlogtau) / cfg.num_tau
    return SimpleNamespace(
        tables=(ctypes.c_void_p * 8)(*[_ptr(t) for t in tabs]), k=k, kx=kx,
        values=[v for v, _ in step],
        pointers=(ctypes.c_void_p * 4)(*[q for _, q in step]),
        table_scalars=(cfg.minlogtau, dlogtau, photo_limit, heat_limit))


def _term_counts(cfg: RunConfig, tables: RadTables, dtype, xray: bool):
    """Entries the rate kernels read per table: the mixture's K and Kx
    terms, or num_tau + 1 in a table build."""
    if not use_expsum(cfg, dtype):
        return cfg.num_tau + 1, cfg.num_tau + 1
    return (tables.exp_a.shape[0],
            tables.xray_exp_a.shape[0] if xray else 0)


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


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
    each ray at sc.rmax2_cells.  The build follows cdo_b's dtype and
    cfg's rate mode (build_for)."""
    if cdo_b.device.type == "cpu":
        return consume_rates_reference(cfg, tables, cdo_b, ndhi, srcpos_b,
                                       nflux_b, sc, max_shell, lls_grid,
                                       nfx_b)
    _slice_options(cfg)
    dtype = cdo_b.dtype
    xray = cfg.sed.use_xray_sed and nfx_b is not None
    build = build_for("consume", dtype, cfg, lls_grid is not None, xray)
    heat = not cfg.isothermal
    mode = _lls_mode(cfg, lls_grid)
    b, n = cdo_b.shape[0], cdo_b.shape[1]
    _check_cuda("cdo_b", cdo_b, dtype, (b, n, n, n))
    _check_cuda("ndhi", ndhi, dtype, (n, n, n))
    _check_cuda("srcpos_b", srcpos_b, torch.int32, (b, 3))
    _check_cuda("nflux_b", nflux_b, dtype, (b,))
    checks = [("ndhi", ndhi), ("srcpos_b", srcpos_b), ("nflux_b", nflux_b)]
    if mode == 2:
        _check_cuda("lls_grid", lls_grid, dtype, (n, n, n))
        checks.append(("lls_grid", lls_grid))
    if xray:
        _check_cuda("nfx_b", nfx_b, dtype, (b,))
        checks.append(("nfx_b", nfx_b))
    dev = cdo_b.device
    for name, t in checks:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cdo_b on {dev}")
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch of {b} sources; the consume kernel takes "
                         f"1..{MAX_BATCH}")
    ra = _rate_args(cfg, tables, sc, dtype, dev, xray)
    lib, fn = _entry("consume", defines=build.defines)
    nblocks = _entry("consume_nblocks", defines=build.defines)[1](n)
    phih = torch.empty((n, n, n), dtype=dtype, device=dev)
    phiheat = (torch.empty((n, n, n), dtype=dtype, device=dev)
               if heat else None)
    partial = torch.empty((2, b, nblocks), dtype=dtype, device=dev)
    loss = torch.empty((2, b), dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(cdo_b.data_ptr(), ndhi.data_ptr(),
            _ptr(lls_grid if mode == 2 else None), srcpos_b.data_ptr(),
            nflux_b.data_ptr(), _ptr(nfx_b if xray else None), ra.tables,
            ra.k, ra.kx, cfg.num_tau, b, n, max_shell, *ra.values,
            ra.pointers, mode, int(heat), int(xray), cfg.max_coldensh,
            *ra.table_scalars, phih.data_ptr(), _ptr(phiheat),
            partial.data_ptr(), loss.data_ptr(), stream)
    _check_rc(lib, rc, "consume")
    LAUNCHES.add(build.key, 2, dev)
    return phih, phiheat, loss[0], loss[1]


# ---------------------------------------------------------------------------
# K2w: the rate pass on source-centred windows (consume.cu's window mode)
# ---------------------------------------------------------------------------

class WindowRates(NamedTuple):
    """The rate pass of a batch of windows: the (B,p,p,p) per-atom rates
    and (non-isothermal) heating rates (None when isothermal), the (B,)
    boundary losses and LLS tallies, and their sums over the batch."""

    phih: torch.Tensor
    phiheat: Optional[torch.Tensor]
    loss: torch.Tensor
    lls_loss: torch.Tensor
    loss_sum: torch.Tensor
    lls_loss_sum: torch.Tensor


def window_rates_reference(cfg: RunConfig, tables: RadTables,
                           cdo: torch.Tensor, wins: torch.Tensor,
                           nf: torch.Tensor, sc: SweepScalars,
                           max_shell: int,
                           lls_wins: Optional[torch.Tensor] = None,
                           nfx: Optional[torch.Tensor] = None
                           ) -> WindowRates:
    """Plain version of window_rates: _rate_pass batched over the windows
    (the JAX windowed_batch vmaps it), the fluxes broadcast as
    (B,1,1,1), the losses summed with torch.sum."""
    res = _rate_pass(cfg, tables, cdo, wins, nf[:, None, None, None], sc,
                     lls_wins, max_shell,
                     nflux_xray=(nfx[:, None, None, None]
                                 if nfx is not None else None))
    return WindowRates(res.phih, None if cfg.isothermal else res.phiheat,
                       res.photon_loss, res.lls_loss,
                       torch.sum(res.photon_loss), torch.sum(res.lls_loss))


def window_rates(cfg: RunConfig, tables: RadTables, cdo: torch.Tensor,
                 wins: torch.Tensor, nf: torch.Tensor, sc: SweepScalars,
                 max_shell: int, lls_wins: Optional[torch.Tensor] = None,
                 nfx: Optional[torch.Tensor] = None) -> WindowRates:
    """The rate pass of B source-centred windows (K2w): the window march's
    columns cdo (B,p,p,p) on the gathered neutral-density windows wins
    (B,p,p,p), the fluxes nf (B,) -> WindowRates.  cfg is the window's
    (mesh (p,p,p), as windowed_batch makes it); lls_wins: the grid LLS
    columns' windows (type 2), or None; nfx: (B,) X-ray fluxes, used when
    cfg.sed.use_xray_sed, or None.  LLS type 3 stops each ray at
    sc.rmax2_cells.  The build is consume's for cdo's dtype and cfg's
    options (build_for("window_rates", ...))."""
    if cdo.device.type == "cpu":
        return window_rates_reference(cfg, tables, cdo, wins, nf, sc,
                                      max_shell, lls_wins, nfx)
    _slice_options(cfg)
    dtype, dev = cdo.dtype, cdo.device
    xray = cfg.sed.use_xray_sed and nfx is not None
    build = build_for("window_rates", dtype, cfg, lls_wins is not None, xray)
    heat = not cfg.isothermal
    mode = _lls_mode(cfg, lls_wins)
    b, p = cdo.shape[0], cdo.shape[-1]
    shape = (b, p, p, p)
    _check_cuda("cdo", cdo, dtype, shape)
    _check_cuda("wins", wins, dtype, shape)
    _check_cuda("nf", nf, dtype, (b,))
    checks = [("wins", wins), ("nf", nf)]
    if mode == 2:
        _check_cuda("lls_wins", lls_wins, dtype, shape)
        checks.append(("lls_wins", lls_wins))
    if xray:
        _check_cuda("nfx", nfx, dtype, (b,))
        checks.append(("nfx", nfx))
    for name, t in checks:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cdo on {dev}")
    if not 1 <= b <= MAX_WINDOWS:
        raise ValueError(f"batch of {b} windows; the window rate pass "
                         f"takes 1..{MAX_WINDOWS}")
    ra = _rate_args(cfg, tables, sc, dtype, dev, xray)
    lib, fn = _entry("window_rates", defines=build.defines)
    nbx = _entry("window_rates_nblocks", defines=build.defines)[1](p)
    phih = torch.empty(shape, dtype=dtype, device=dev)
    phiheat = torch.empty(shape, dtype=dtype, device=dev) if heat else None
    partial = torch.empty((2, b, nbx), dtype=dtype, device=dev)
    loss = torch.empty(2 * b + 2, dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(cdo.data_ptr(), wins.data_ptr(),
            _ptr(lls_wins if mode == 2 else None), nf.data_ptr(),
            _ptr(nfx if xray else None), ra.tables, ra.k, ra.kx,
            cfg.num_tau, b, p, max_shell, *ra.values, ra.pointers, mode,
            int(heat), int(xray), cfg.max_coldensh, *ra.table_scalars,
            phih.data_ptr(), _ptr(phiheat), partial.data_ptr(),
            loss.data_ptr(), stream)
    _check_rc(lib, rc, "window rates")
    LAUNCHES.add(build.key, 1, dev)
    return WindowRates(phih, phiheat, loss[:b], loss[b:2 * b], loss[2 * b],
                       loss[2 * b + 1])


# ---------------------------------------------------------------------------
# The fused window sweep: K3's cluster form with K2w as its epilogue
# ---------------------------------------------------------------------------

def window_sweep_reference(cfg: RunConfig, tables: RadTables,
                           wins: torch.Tensor, nf: torch.Tensor,
                           sc: SweepScalars, max_shell: int,
                           lls_wins: Optional[torch.Tensor] = None,
                           nfx: Optional[torch.Tensor] = None
                           ) -> WindowRates:
    """Plain version of window_sweep: window_rates_reference on the plain
    window march's columns."""
    cdo = compute_columns_windows_reference(cfg, wins, sc, max_shell,
                                            lls_wins)
    return window_rates_reference(cfg, tables, cdo, wins, nf, sc, max_shell,
                                  lls_wins, nfx)


def window_sweep_fits(cfg: RunConfig, tables: RadTables, wins: torch.Tensor,
                      lls_wins: Optional[torch.Tensor] = None,
                      nfx: Optional[torch.Tensor] = None) -> bool:
    """Whether window_sweep takes these windows (its arguments' cfg,
    tables, wins, lls_wins and nfx): on the card the kernel's own fit rule
    for the build (its two planes, staged terms and reduction slots in one
    block's shared memory); the plain version on the CPU takes any."""
    if wins.device.type == "cpu":
        return True
    xray = cfg.sed.use_xray_sed and nfx is not None
    build = build_for("window_sweep", wins.dtype, cfg, lls_wins is not None,
                      xray)
    k, kx = _term_counts(cfg, tables, wins.dtype, xray)
    fits = _entry("window_sweep_fits", defines=build.defines)[1]
    return bool(fits(wins.shape[-1], k, kx, int(not cfg.isothermal),
                     int(xray)))


def window_sweep(cfg: RunConfig, tables: RadTables, wins: torch.Tensor,
                 nf: torch.Tensor, sc: SweepScalars, max_shell: int,
                 lls_wins: Optional[torch.Tensor] = None,
                 nfx: Optional[torch.Tensor] = None) -> WindowRates:
    """The window march and the rate pass of B source-centred windows in
    one launch (csrc/window_sweep.cu): the gathered neutral-density
    windows wins (B,p,p,p) and their fluxes nf (B,) -> WindowRates, what
    window_rates gives on compute_columns_windows' columns, the columns
    kept on chip.  cfg is the window's (mesh (p,p,p), as windowed_batch
    makes it); lls_wins: the grid LLS columns' windows (type 2), or None;
    nfx: (B,) X-ray fluxes, used when cfg.sed.use_xray_sed, or None.  On
    the card the windows must fit the kernel (window_sweep_fits), else it
    raises; the build is build_for("window_sweep", ...)."""
    if wins.device.type == "cpu":
        return window_sweep_reference(cfg, tables, wins, nf, sc, max_shell,
                                      lls_wins, nfx)
    _slice_options(cfg)
    dtype, dev = wins.dtype, wins.device
    xray = cfg.sed.use_xray_sed and nfx is not None
    build = build_for("window_sweep", dtype, cfg, lls_wins is not None, xray)
    heat = not cfg.isothermal
    mode = _lls_mode(cfg, lls_wins)
    b, p = wins.shape[0], wins.shape[-1]
    shape = (b, p, p, p)
    _check_cuda("wins", wins, dtype, shape)
    _check_cuda("nf", nf, dtype, (b,))
    checks = [("nf", nf)]
    if mode == 2:
        _check_cuda("lls_wins", lls_wins, dtype, shape)
        checks.append(("lls_wins", lls_wins))
    if xray:
        _check_cuda("nfx", nfx, dtype, (b,))
        checks.append(("nfx", nfx))
    for name, t in checks:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, wins on {dev}")
    if not 1 <= b <= MAX_WINDOWS:
        raise ValueError(f"batch of {b} windows; the window sweep takes "
                         f"1..{MAX_WINDOWS}")
    ra = _rate_args(cfg, tables, sc, dtype, dev, xray)
    lib, fn = _entry("window_sweep", defines=build.defines)
    # cells beyond a capped radius are never written and must read zero
    make = torch.zeros if _shells(max_shell, p) < p // 2 else torch.empty
    phih = make(shape, dtype=dtype, device=dev)
    phiheat = make(shape, dtype=dtype, device=dev) if heat else None
    loss = torch.empty(2 * b + 2, dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(wins.data_ptr(), _ptr(lls_wins if mode == 2 else None),
            nf.data_ptr(), _ptr(nfx if xray else None), ra.tables, ra.k,
            ra.kx, cfg.num_tau, b, p, max_shell, *ra.values, ra.pointers,
            mode, int(heat), int(xray), cfg.max_coldensh, *ra.table_scalars,
            phih.data_ptr(), _ptr(phiheat), loss.data_ptr(), stream)
    _check_rc(lib, rc, f"window sweep (p = {p}; window_sweep_fits decides "
                       "where it runs)")
    LAUNCHES.add(build.key, 1, dev)
    return WindowRates(phih, phiheat, loss[:b], loss[b:2 * b], loss[2 * b],
                       loss[2 * b + 1])
