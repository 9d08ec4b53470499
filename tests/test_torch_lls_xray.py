"""The PyTorch port's LLS and X-ray options against the JAX package's, on
inputs made with numpy from a seed: the type-2 LLS setup (set_lls,
set_lls_device), the marches with a grid LLS cube, the fused rate
deposition with a grid LLS cube, the R_max barrier (type 3) and X-ray
sources, and the full-cube and windowed raytraces with all of them.  The
JAX Pallas kernels run in interpret mode, as the JAX package's own tests
run them."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from c2ray_tpu.config import SEDConfig as JaxSED
from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.models import lls as jlls
from c2ray_tpu.ops import sweep as js
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables

import c2ray_tpu_torch as port
from c2ray_tpu_torch.convert import config_from_dict, tables_from_numpy
from c2ray_tpu_torch.ops import sweep as ps
from c2ray_tpu_torch.ops import sweep_cuda as pk

torch.set_num_threads(2)


def _pair(n, dtype, xray=False, **kw):
    base = dict(mesh=n, dtype=dtype, cosmological=False, use_lls=True,
                type_of_lls=2)
    if xray:
        base["sed"] = JaxSED(use_xray_sed=True)
    base.update(kw)
    jcfg = jax_config(**base)
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def _scalars(jcfg, pcfg, dr, lls, rmax=0.0):
    dt = jcfg.jnp_dtype
    jsc = js.SweepScalars(dr=jnp.asarray(dr, dt),
                          rate_scale=jnp.asarray(jcfg.sed.s_star / dr**3, dt),
                          lls_coldens=jnp.asarray(lls, dt),
                          rmax2_cells=jnp.asarray(rmax * rmax, dt))
    return jsc, ps.sweep_scalars(pcfg, dr, lls, rmax)


def _tables(jcfg):
    jtabs = jax_tables(jcfg)
    ptabs = tables_from_numpy({k: np.asarray(v) for k, v in
                               jtabs._asdict().items()}, "cpu")
    return jtabs, ptabs


def _field(n, dtype, seed, lo=0.2, hi=1.0, scale=2e-4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (n, n, n)) * scale).astype(dtype)


POSITIONS = [[3, 11, 7], [0, 0, 15], [8, 8, 8], [15, 1, 0]]


# --- type-2 setup ---------------------------------------------------------

@pytest.mark.parametrize("where", ["host", "device"])
@pytest.mark.parametrize("zred", [6.0, 20.0])
def test_set_lls_type2_matches_jax(where, zred):
    """set_lls's type-2 branch (host numpy) and set_lls_device (a torch
    tensor) against the JAX package's, mfp model 1: at z = 20 its mean
    free path lies below the comoving limit and the grid is zeroed.
    Grid, mean column and mfp at rtol 1e-15."""
    n = 16
    jcfg, pcfg = _pair(n, "float64", lls_model=1)
    dr = 7.25e23
    sigma = np.random.default_rng(7).lognormal(0.0, 0.5, (n,) * 3)
    if where == "host":
        want = jlls.set_lls(jcfg, zred, dr, sigma)
        got = port.set_lls(pcfg, zred, dr, sigma)
        grid = np.asarray(got.grid)
    else:
        want = jlls.set_lls_device(jcfg, zred, dr, jnp.asarray(sigma))
        got = port.set_lls_device(pcfg, zred, dr, torch.from_numpy(sigma))
        assert isinstance(got.grid, torch.Tensor)
        assert got.grid.dtype == torch.float64
        grid = got.grid.numpy()
    np.testing.assert_allclose(grid, np.asarray(want.grid), rtol=1e-15,
                               atol=0)
    assert got.mfp_pmpc == pytest.approx(want.mfp_pmpc, rel=1e-15)
    assert got.coldensh_lls == pytest.approx(want.coldensh_lls, rel=1e-15)
    below = zred == 20.0
    assert (not grid.any()) == below
    assert got.mfp_pmpc < 1.0 / (1.0 + zred) if below else grid.min() > 0


def test_set_lls_type2_needs_a_grid():
    _, pcfg = _pair(8, "float64")
    with pytest.raises(ValueError):
        port.set_lls(pcfg, 9.0, 7.25e23)


# --- the marches with a grid LLS cube -------------------------------------

def test_grid_march_lls_matches_pallas_grid_f32():
    """K1's plain version with an LLS cube == the Pallas grid-frame march
    with lls= (interpret mode; cf. tests/test_pallas.py::
    test_grid_frame_march_with_lls_grid), n = 16, f32, rtol 1e-6."""
    from c2ray_tpu.ops.sweep_pallas import compute_columns_pallas_grid

    n = 16
    c = n // 2
    jcfg, pcfg = _pair(n, "float32")
    jsc, psc = _scalars(jcfg, pcfg, 2.9e24, 0.0)
    ndhi = _field(n, np.float32, seed=6)
    lls = _field(n, np.float32, seed=16, lo=0.0, scale=1e16)
    pos = np.asarray(POSITIONS, np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = compute_columns_pallas_grid(jcfg, jnp.asarray(ndhi),
                                           jnp.asarray(pos), jsc, c,
                                           lls=jnp.asarray(lls))
    got = pk.compute_columns_grid(pcfg, torch.from_numpy(ndhi),
                                  torch.from_numpy(pos), psc, c,
                                  lls=torch.from_numpy(lls))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    # the grid's columns count: without them the columns are smaller
    plain = pk.compute_columns_grid(pcfg.replace(use_lls=False),
                                    torch.from_numpy(ndhi),
                                    torch.from_numpy(pos), psc, c)
    assert bool((got > plain).any())


@pytest.mark.parametrize("n", [15, 16])
def test_facemajor_march_lls_matches_jax_f64(n):
    """The port's grid-frame march with an LLS cube, and its facemajor
    march with the centred cube lls_c, == the JAX facemajor march with
    lls_c, f64, rtol 1e-12, sources at corners, edges and the centre."""
    jcfg, pcfg = _pair(n, "float64")
    c = n // 2
    jsc, psc = _scalars(jcfg, pcfg, 2.9e24 / (n / 16), 0.0)
    ndhi = _field(n, np.float64, seed=n)
    lls = _field(n, np.float64, seed=n + 50, lo=0.0, scale=3e16)
    pos = np.array([[p % n for p in q] for q in POSITIONS + [[n - 1] * 3]],
                   np.int32)
    got = pk.compute_columns_grid(pcfg, torch.from_numpy(ndhi),
                                  torch.from_numpy(pos), psc, c,
                                  lls=torch.from_numpy(lls)).numpy()
    for b, p in enumerate(pos):
        shift = c - jnp.asarray(p)
        cube = js.roll3(jnp.asarray(ndhi), shift)
        lcube = js.roll3(jnp.asarray(lls), shift)
        want = np.asarray(js.compute_columns_facemajor(jcfg, cube, jsc,
                                                       lcube, c))
        np.testing.assert_allclose(got[b], want, rtol=1e-12, atol=0)
        one = ps.compute_columns_facemajor(
            pcfg, torch.from_numpy(np.array(cube)), psc,
            torch.from_numpy(np.array(lcube)), c)
        np.testing.assert_allclose(one.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("p", [9, 17])
def test_window_march_lls_matches_pallas(p):
    """K3's plain version with LLS windows == the Pallas march with
    lls_cb (interpret mode), B = 3, f32, rtol 1e-6."""
    from c2ray_tpu.ops.sweep_pallas import compute_columns_pallas

    r = p // 2
    jcfg, pcfg = _pair(p, "float32")
    jsc, psc = _scalars(jcfg, pcfg, 2.9e24, 0.0)
    rng = np.random.default_rng(p)
    wins = (rng.uniform(0.2, 1.0, (3, p, p, p)) * 2e-4).astype(np.float32)
    lwins = (rng.uniform(0.0, 1.0, (3, p, p, p)) * 1e16).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = compute_columns_pallas(jcfg, jnp.asarray(wins), jsc, r,
                                      lls_cb=jnp.asarray(lwins))
    got = pk.compute_columns_windows(pcfg, torch.from_numpy(wins), psc, r,
                                     lls_wins=torch.from_numpy(lwins))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


# --- the fused rate deposition --------------------------------------------

_CONSUME_CASES = {
    # name: (config overrides, grid LLS, X-ray, R_max in cells)
    "grid-lls": (dict(type_of_lls=2), True, False, 0.0),
    "rmax": (dict(type_of_lls=3), False, False, 10.0),
    "xray": (dict(type_of_lls=1, xray=True), False, True, 0.0),
    "xray-heat": (dict(type_of_lls=1, xray=True, isothermal=False), False,
                  True, 0.0),
    "grid-lls-xray": (dict(type_of_lls=2, xray=True), True, True, 0.0),
}


@pytest.mark.parametrize("case", list(_CONSUME_CASES))
def test_consume_options_match_pallas_consume_f32(case):
    """consume_rates' plain version with a grid LLS cube, the R_max
    barrier (it cuts inside n = 32), X-ray sources (one of them a pure
    X-ray source, nflux = 0), X-ray with heat, and grid LLS with X-ray ==
    consume_rates_pallas in interpret mode, n = 32, B = 3, f32: phih,
    phiheat, the losses and the LLS tally at rtol 2e-5 (the Pallas kernel
    sums nf * phi + nfx * xphi before one divide, the port each mixture's
    rate in turn: a last-place difference).  The columns are the plain
    march's on a thin density (~1.5e17 cm^-2 a cell), so rays reach far
    and the LLS tally is live; cells of 7.25e23 cm and fluxes of
    10^6..10^9 S* keep the heating terms off float32's subnormals (see
    tests/test_torch_sweep.py)."""
    from c2ray_tpu.ops.sweep_pallas import consume_rates_pallas

    kw, grid, xray, rmax = _CONSUME_CASES[case]
    n, b = 32, 3
    c = n // 2
    jcfg, pcfg = _pair(n, "float32", sweep_backend="pallas", source_batch=b,
                       **kw)
    jtabs, ptabs = _tables(jcfg)
    jsc, psc = _scalars(jcfg, pcfg, 7.25e23, 1e16, rmax)
    rng = np.random.default_rng(13)
    pos = rng.integers(0, n, (b, 3)).astype(np.int32)
    pos[1] = [0, n - 1, 0]
    nflux = (10.0 ** rng.uniform(6, 9, b)).astype(np.float32)
    nfx = (10.0 ** rng.uniform(6, 8, b)).astype(np.float32) if xray else None
    if xray:
        nflux[0] = 0.0                           # a pure X-ray source
    ndens = rng.uniform(1e-7, 3e-7, (n,) * 3).astype(np.float32)
    xh = rng.uniform(0.1, 0.9, (n,) * 3).astype(np.float32)
    lls = (rng.uniform(0.0, 3e16, (n,) * 3).astype(np.float32) if grid
           else None)
    ndhi = np.array(js.neutral_density(jcfg, jnp.asarray(ndens),
                                       jnp.asarray(xh)))
    cdo = pk.compute_columns_grid(
        pcfg, torch.from_numpy(ndhi), torch.from_numpy(pos), psc, c,
        lls=torch.from_numpy(lls) if grid else None).numpy()
    ph_w, heat_w, loss_w, lls_w = consume_rates_pallas(
        jcfg, jtabs, jnp.asarray(cdo), jnp.asarray(ndhi),
        jnp.asarray(lls) if grid else None, jnp.asarray(pos),
        jnp.asarray(nflux), jnp.asarray(nfx) if xray else None, jsc, c,
        interpret=True)

    def port_call(p_nflux=nflux, p_nfx=nfx, p_cfg=pcfg):
        return pk.consume_rates(
            p_cfg, ptabs, torch.from_numpy(cdo), torch.from_numpy(ndhi),
            torch.from_numpy(pos), torch.from_numpy(p_nflux), psc, c,
            lls_grid=torch.from_numpy(lls) if grid else None,
            nfx_b=torch.from_numpy(p_nfx) if p_nfx is not None else None)

    ph, heat, loss, lls_loss = port_call()
    assert float(ph.max()) > 0.0
    np.testing.assert_allclose(ph.numpy(), np.asarray(ph_w), rtol=2e-5,
                               atol=0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_w), rtol=2e-5)
    np.testing.assert_allclose(lls_loss.numpy(), np.asarray(lls_w),
                               rtol=2e-5)
    if pcfg.isothermal:
        assert heat is None
    else:
        assert float(heat.max()) > 0.0
        np.testing.assert_allclose(heat.numpy(), np.asarray(heat_w),
                                   rtol=2e-5, atol=0)
    if grid:
        assert float(lls_loss.min()) > 0.0
    if rmax:
        # the barrier cuts inside the cube: without it more cells are lit
        free = port_call(p_cfg=pcfg.replace(type_of_lls=1, use_lls=False))
        assert int((free[0] > 0).sum()) > int((ph > 0).sum())
        assert float(ph.max()) > 0.0
    if xray:
        # the pure X-ray source alone deposits, and only through X-ray
        one = slice(0, 1)
        alone = pk.consume_rates(
            pcfg, ptabs, torch.from_numpy(cdo[one]), torch.from_numpy(ndhi),
            torch.from_numpy(pos[one]), torch.from_numpy(nflux[one]), psc,
            c, lls_grid=torch.from_numpy(lls) if grid else None,
            nfx_b=torch.from_numpy(nfx[one]))
        assert float(alone[0].max()) > 0.0
        assert bool(torch.isfinite(alone[0]).all())
        dark = pk.consume_rates(
            pcfg, ptabs, torch.from_numpy(cdo[one]), torch.from_numpy(ndhi),
            torch.from_numpy(pos[one]), torch.from_numpy(nflux[one]), psc,
            c, lls_grid=torch.from_numpy(lls) if grid else None)
        assert float(dark[0].abs().max()) == 0.0


# --- the full-cube and windowed raytraces ---------------------------------

_RAYTRACE_CASES = {
    # name: (max_shell argument, config overrides, R_max in cells)
    "full": (None, dict(type_of_lls=2), 0.0),
    "windowed": (3, dict(type_of_lls=2), 0.0),
    "capped": (6, dict(type_of_lls=2, window_sweep=False), 0.0),
    "windowed-heat": (3, dict(type_of_lls=2, isothermal=False), 0.0),
    "full-rmax": (None, dict(type_of_lls=3), 4.5),
    "windowed-rmax": (7, dict(type_of_lls=3), 4.5),
}


@pytest.mark.parametrize("case", list(_RAYTRACE_CASES))
def test_raytrace_lls_xray_matches_jax_f64(case):
    """raytrace_all_sources (full cube, windowed at max_shell = r, or the
    capped full cube) with a grid LLS cube (type 2) or the R_max barrier
    (type 3), and X-ray fluxes beside the stellar ones (one source pure
    X-ray), == the JAX one, f64 expsum rates: the rate grids at rtol
    1e-12, the losses at rtol 1e-12 with a floor of 1e-12 of the total
    flux (see tests/test_torch_sweep.py)."""
    shell_arg, kw, rmax = _RAYTRACE_CASES[case]
    n = 16
    jcfg, pcfg = _pair(n, "float64", xray=True, rate_eval="expsum",
                       source_batch=4, **kw)
    jtabs, ptabs = _tables(jcfg)
    jsc, psc = _scalars(jcfg, pcfg, 1e22, 1e17, rmax)
    rng = np.random.default_rng(11)
    ndens = rng.uniform(1e-4, 3e-4, (n,) * 3)
    xh = rng.uniform(0.0, 0.9, (n,) * 3)
    pos = np.asarray(POSITIONS + [[3, 11, 7], [5, 9, 2]], np.int32)
    nflux = 10.0 ** rng.uniform(-1, 1, len(pos))
    nfx = 10.0 ** rng.uniform(-1, 1, len(pos))
    nflux[2] = 0.0                               # a pure X-ray source
    lls = (rng.uniform(0.0, 2e17, (n,) * 3) if pcfg.type_of_lls == 2
           else None)
    want = js.raytrace_all_sources(
        jcfg, jtabs, jnp.asarray(ndens), jnp.asarray(xh), jnp.asarray(pos),
        jnp.asarray(nflux), jsc,
        lls_grid=jnp.asarray(lls) if lls is not None else None,
        max_shell=shell_arg, nflux_xray=jnp.asarray(nfx))
    got = ps.raytrace_all_sources(
        pcfg, ptabs, torch.from_numpy(ndens), torch.from_numpy(xh),
        torch.from_numpy(pos), torch.from_numpy(nflux), psc,
        lls_grid=torch.from_numpy(lls) if lls is not None else None,
        max_shell=shell_arg, nflux_xray=torch.from_numpy(nfx))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-12, atol=0)
    assert float(got[0].abs().sum()) > 0
    flux = nflux.sum() + nfx.sum()
    for i in (2, 3, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-12, atol=1e-12 * flux)
    if lls is not None:
        assert float(got[3]) > 0.0
    if not pcfg.isothermal:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-12, atol=0)
        assert float(got[1].abs().sum()) > 0


def test_windowed_lls_matches_full_sweep():
    """The windowed sweep with a grid LLS cube == the capped full-cube
    sweep at the same radius (cf. tests/test_round2.py::
    test_windowed_with_lls_grid): rates at rtol 1e-12, the LLS loss at
    1e-10, n = 20, r = 6, with X-ray sources."""
    n, r = 20, 6
    _, pcfg = _pair(n, "float64", xray=True, rate_eval="expsum",
                    window_sweep=False)
    from c2ray_tpu_torch.ops.tables import build_rad_tables
    tabs = build_rad_tables(pcfg, device="cpu")
    psc = ps.sweep_scalars(pcfg, 1e22, 1e17)     # thin cells: LLS tally
    rng = np.random.default_rng(2)
    nd = torch.from_numpy(rng.uniform(1e-4, 3e-4, (n,) * 3))
    xa = torch.from_numpy(rng.uniform(0.0, 0.5, (n,) * 3))
    lls = torch.from_numpy(10.0 ** rng.uniform(14, 16, (n,) * 3))
    pos = torch.tensor([[5, 5, 5], [15, 2, 18], [0, 19, 0]],
                       dtype=torch.int32)
    flux = torch.tensor([1.0, 2.0, 0.0], dtype=torch.float64)
    xflux = torch.tensor([0.5, 0.0, 3.0], dtype=torch.float64)
    full = ps.raytrace_all_sources(pcfg, tabs, nd, xa, pos, flux, psc,
                                   lls_grid=lls, max_shell=r,
                                   nflux_xray=xflux)
    win = ps.raytrace_windowed(pcfg, tabs, nd, xa, pos, flux, psc, radius=r,
                               lls_grid=lls, nflux_xray=xflux)
    np.testing.assert_allclose(win[0].numpy(), full[0].numpy(), rtol=1e-12,
                               atol=0)
    assert float(win[3]) == pytest.approx(float(full[3]), rel=1e-10)
    assert float(win[3]) > 0.0
