"""float64 and table rates in the port's kernel wrappers: the options
check and the build each (kernel, dtype, rate mode, options) takes on a
card, and the plain versions of the rate deposition in those modes
against the JAX package's raytrace, on inputs made with numpy from a
seed.  In these modes the JAX package runs no Pallas kernel: its XLA
march and rate pass are the reference."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sweep import _dead_pairs_case, _stop_bound_case

from c2ray_tpu.config import SEDConfig as JaxSED
from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.ops import sweep as js
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables

from c2ray_tpu_torch.config import test_problem_config as port_config
from c2ray_tpu_torch.convert import config_from_dict, tables_from_numpy
from c2ray_tpu_torch.ops import sweep as ps
from c2ray_tpu_torch.ops import sweep_cuda as pk
from c2ray_tpu_torch.ops import window_cuda as pw
from c2ray_tpu_torch.solver import check_supported

torch.set_num_threads(2)

CUDA = torch.device("cuda")


# --- what runs on a card --------------------------------------------------

@pytest.mark.parametrize("dtype,rate_eval", [
    ("float64", "auto"), ("float64", "table"), ("float64", "expsum"),
    ("float32", "table"), ("float32", "auto")])
def test_check_supported_takes_f64_and_table_on_cuda(dtype, rate_eval):
    """float64 (table rates under "auto") and table rates in float32 are
    accepted on a CUDA device; the check needs no card."""
    cfg = port_config(mesh=8, dtype=dtype, rate_eval=rate_eval,
                      use_lls=True, type_of_lls=2)
    check_supported(cfg, CUDA)
    check_supported(cfg, torch.device("cpu"))


@pytest.mark.parametrize("bad", ["lls4", "noncubic", "float16", "device"])
def test_check_supported_still_refuses(bad):
    cfg = port_config(mesh=8, dtype="float64")
    dev = CUDA
    if bad == "lls4":
        cfg = cfg.replace(use_lls=True, type_of_lls=4)
    elif bad == "noncubic":
        cfg = cfg.replace(mesh=(8, 8, 16))
    elif bad == "float16":
        cfg = cfg.replace(dtype="float16")
    else:
        dev = torch.device("meta")
    with pytest.raises(NotImplementedError):
        check_supported(cfg, dev)


_LLS = {"off": dict(use_lls=False),
        **{name: dict(use_lls=True, type_of_lls=t)
           for name, t in (("scalar", 1), ("grid", 2), ("rmax", 3))}}


def _build_cases():
    for dtype in (torch.float32, torch.float64):
        for rate_eval in ("expsum", "table"):
            for lls in _LLS:
                for xray in (False, True):
                    for heat in (False, True):
                        yield dtype, rate_eval, lls, xray, heat


def test_build_for_covers_every_combination():
    """Every (dtype, rate mode, LLS, X-ray, heat) combination of the
    deposition has a build with its own LAUNCHES key: the -D flags name
    the dtype and the rate mode, LLS off and the scalar column share the
    build (one instance each inside it), and two combinations share a key
    only where they share the build.  The float32 mixture keeps the keys
    of the builds before float64 existed; the marches and the window
    kernels have one build per dtype (and grid LLS)."""
    seen = {}
    for dtype, rate_eval, lls, xray, heat in _build_cases():
        cfg = port_config(
            mesh=8, dtype="float64" if dtype == torch.float64 else "float32",
            rate_eval=rate_eval, isothermal=not heat, **_LLS[lls])
        if xray:
            cfg = cfg.replace(sed=dataclasses.replace(cfg.sed,
                                                      use_xray_sed=True))
        b = pk.build_for("consume", dtype, cfg, grid_lls=lls == "grid",
                         xray=xray)
        f64, table = dtype == torch.float64, rate_eval == "table"
        assert b.source == "consume"
        assert ("C2R_F64" in b.defines) == f64
        assert ("C2R_TABLE" in b.defines) == table
        assert b.key in pk.LAUNCHES
        lls_key = {"grid": "_lls", "rmax": "_rmax"}.get(lls, "")
        build = (f64, table, lls_key, xray, heat)
        assert seen.setdefault(b.key, build) == build, b.key
        if not f64 and not table:
            assert b.key == ("consume" + lls_key + ("_xray" if xray else "")
                             + ("_heat" if heat else ""))
    assert len(seen) == 2 * 2 * 3 * 2 * 2
    assert set(seen) | {k for k in pk.LAUNCHES
                        if not k.startswith("consume")} == set(pk.LAUNCHES)
    cfg = port_config(mesh=8, dtype="float64")
    keys = set()
    for kernel in ("march", "window_march"):
        for dtype in (torch.float32, torch.float64):
            for grid in (False, True):
                b = pk.build_for(kernel, dtype, cfg, grid_lls=grid)
                assert b.source == "march" and b.key in pk.LAUNCHES
                assert ("C2R_F64" in b.defines) == (dtype == torch.float64)
                keys.add(b.key)
    for kernel in ("window_gather", "window_scatter"):
        for dtype in (torch.float32, torch.float64):
            b = pk.build_for(kernel, dtype)
            assert b.source == "window" and b.key in pw.LAUNCHES
            keys.add(b.key)
    assert len(keys) == 2 * 2 * 2 + 2 * 2
    assert pk.build_for("march", torch.float64, cfg).key == "march_f64"
    assert pk.build_for("window_scatter", torch.float64).key == \
        "window_scatter_f64"
    with pytest.raises(ValueError):
        pk.build_for("march", torch.float16, cfg)


def test_f64_tensors_on_a_card_do_not_fall_back():
    """A float64 tensor off the CPU never takes the plain version: the
    wrapper launches the float64 build or raises (here, with no card, it
    raises on the device)."""
    n = 8
    cfg = port_config(mesh=n, dtype="float64")
    psc = ps.sweep_scalars(cfg, 1e22, 1e16)
    ndhi = torch.empty((n, n, n), dtype=torch.float64, device="meta")
    pos = torch.zeros((1, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pk.compute_columns_grid(cfg, ndhi, pos, psc, n // 2)
    with pytest.raises(ValueError):
        pk.consume_rates(cfg, None, ndhi[None], ndhi, pos,
                         torch.empty(1, dtype=torch.float64, device="meta"),
                         psc, n // 2)
    with pytest.raises(ValueError):
        pw.window_gather(ndhi, pos, 2)


# --- the plain rate deposition against the JAX package ---------------------

@pytest.mark.parametrize("dtype,rate_eval,rtol", [
    ("float32", "table", 2e-5), ("float64", "expsum", 1e-12),
    ("float64", "table", 1e-12)])
def test_raytrace_rates_match_jax(dtype, rate_eval, rtol):
    """raytrace_all_sources on the full cube (the plain march and the
    plain K2, consume_rates_reference) == the JAX one at 32^3 x 3, LLS
    type 1, X-ray fluxes beside the stellar ones, heat on: phih and
    phiheat at rtol 2e-5 in float32 and 1e-12 in float64, the boundary
    and LLS losses at the same rtol with a floor of rtol times the total
    flux (they sum differences that cancel along thick rays, see
    tests/test_torch_sweep.py)."""
    n = 32
    base = dict(mesh=n, dtype=dtype, cosmological=False, use_lls=True,
                type_of_lls=1, rate_eval=rate_eval, isothermal=False,
                source_batch=3, sed=JaxSED(use_xray_sed=True))
    jcfg = jax_config(**base)
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    jtabs = jax_tables(jcfg)
    ptabs = tables_from_numpy({k: np.asarray(v) for k, v in
                               jtabs._asdict().items()}, "cpu")
    dr, lls = 2.9e24 / 8, 1e17
    jdt = jcfg.jnp_dtype
    jsc = js.SweepScalars(dr=jnp.asarray(dr, jdt),
                          rate_scale=jnp.asarray(jcfg.sed.s_star / dr**3,
                                                 jdt),
                          lls_coldens=jnp.asarray(lls, jdt),
                          rmax2_cells=jnp.asarray(0.0, jdt))
    psc = ps.sweep_scalars(pcfg, dr, lls)
    npt = pcfg.np_dtype
    rng = np.random.default_rng(31)
    ndens = rng.uniform(1e-4, 3e-4, (n,) * 3).astype(npt)
    xh = rng.uniform(0.0, 0.9, (n,) * 3).astype(npt)
    pos = np.asarray([[0, 0, 0], [n - 1, 3, n // 2], [9, 20, 30]], np.int32)
    nflux = (10.0 ** rng.uniform(-1, 1, 3)).astype(npt)
    nfx = (10.0 ** rng.uniform(-1, 1, 3)).astype(npt)
    want = js.raytrace_all_sources(
        jcfg, jtabs, jnp.asarray(ndens), jnp.asarray(xh), jnp.asarray(pos),
        jnp.asarray(nflux), jsc, nflux_xray=jnp.asarray(nfx))
    got = ps.raytrace_all_sources(
        pcfg, ptabs, torch.from_numpy(ndens), torch.from_numpy(xh),
        torch.from_numpy(pos), torch.from_numpy(nflux), psc,
        nflux_xray=torch.from_numpy(nfx))
    for i in (0, 1):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=rtol, atol=0)
        assert float(got[i].abs().sum()) > 0
    flux = float(nflux.sum() + nfx.sum())
    for i in (2, 3, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=rtol, atol=rtol * flux)
    assert float(got[3]) > 0.0


# --- the premises of K2's dead-pair skip and stop bound --------------------

_MODES = {"f64 table": ("float64", "auto"), "f64 mixture": ("float64",
                                                             "expsum"),
          "f32 table": ("float32", "table")}


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("use_lls,capped,isothermal,rmax", [
    (False, False, True, None), (True, True, True, None),
    (True, False, False, None), (True, False, False, 5.0)])
def test_consume_dead_pairs_contribute_nothing(monkeypatch, mode, use_lls,
                                               capped, isothermal, rmax):
    """tests/test_torch_sweep.py's dead-pair premise in float64 and with
    table rates: with the rate results of every dead (cell, source) pair
    (beyond max_shell or R_max, or incoming column above max_coldensh)
    replaced by NaN, consume_rates_reference returns the same phih,
    phiheat, losses and LLS losses bitwise."""
    dtype, rate_eval = _MODES[mode]
    _dead_pairs_case(monkeypatch, use_lls, capped, isothermal, rmax,
                     dtype=dtype, rate_eval=rate_eval)


@pytest.mark.parametrize("dr", [1e21, 2.9e24 / 4])
def test_consume_stop_bound_is_conservative_f64(dr):
    """K2's stop bound cd - nd * fl(sqrt(3) * dr) > max_coldensh implies
    cin > max_coldensh in float64 too (the rate mode does not enter)."""
    _stop_bound_case(dr, "float64")
