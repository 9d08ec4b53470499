"""The PyTorch port's sweep against the JAX package's: the plain versions
of the two kernels (the grid-frame column march and the fused rate
deposition) and the full-cube raytrace, on inputs made with numpy from a
seed.  The JAX Pallas kernels run in interpret mode, as the JAX package's
own tests run them."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.ops import sweep as js
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables

from c2ray_tpu_torch.convert import config_from_dict, tables_from_numpy
from c2ray_tpu_torch.ops import sweep as ps
from c2ray_tpu_torch.ops import sweep_cuda as pk

torch.set_num_threads(2)


def _pair(n, dtype, **kw):
    base = dict(mesh=n, dtype=dtype, cosmological=False, use_lls=True,
                type_of_lls=1)
    base.update(kw)
    jcfg = jax_config(**base)
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def _scalars(jcfg, pcfg, dr, lls):
    dt = jcfg.jnp_dtype
    jsc = js.SweepScalars(dr=jnp.asarray(dr, dt),
                          rate_scale=jnp.asarray(jcfg.sed.s_star / dr**3, dt),
                          lls_coldens=jnp.asarray(lls, dt),
                          rmax2_cells=jnp.asarray(0.0, dt))
    return jsc, ps.sweep_scalars(pcfg, dr, lls)


def _tables(jcfg):
    jtabs = jax_tables(jcfg)
    ptabs = tables_from_numpy({k: np.asarray(v) for k, v in
                               jtabs._asdict().items()}, "cpu")
    return jtabs, ptabs


def _field(n, dtype, seed, lo=0.2, hi=1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (n, n, n)) * 2e-4).astype(dtype)


POSITIONS = [[3, 11, 7], [0, 0, 15], [8, 8, 8], [15, 1, 0]]


def test_neutral_density():
    jcfg, pcfg = _pair(12, "float64")
    rng = np.random.default_rng(2)
    nd = rng.uniform(1e-4, 3e-4, (12,) * 3)
    x = rng.uniform(0.0, 1.0, (12,) * 3)
    x[0, 0, :4] = [0.0, 1.0, 1e-20, 1.0 - 1e-16]
    want = js.neutral_density(jcfg, jnp.asarray(nd), jnp.asarray(x))
    got = ps.neutral_density(pcfg, torch.from_numpy(nd), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=0)


def test_face_ownership_partitions_the_shell_surface():
    for n in (15, 16):
        own = np.stack(ps.face_ownership_masks(n, n // 2))
        cnt = own.sum(axis=0)
        c = n // 2
        assert cnt[c, c, c] == 0
        cnt[c, c, c] = 1
        assert (cnt == 1).all()
        for a, b in zip(own, js.face_ownership_masks(n, c)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [15, 16, 24])
def test_march_matches_facemajor_f64(n):
    """The port's plain grid-frame march == the JAX facemajor march on the
    source-centred cube, for sources at corners, edges and the centre."""
    jcfg, pcfg = _pair(n, "float64")
    c = n // 2
    dr = 2.9e24 / (n / 16)
    jsc, psc = _scalars(jcfg, pcfg, dr, 1e16)
    ndhi = _field(n, np.float64, seed=n)
    pos = np.array([[p % n for p in q] for q in POSITIONS + [[n - 1] * 3]],
                   np.int32)
    got = pk.compute_columns_grid(pcfg, torch.from_numpy(ndhi),
                                  torch.from_numpy(pos), psc, c).numpy()
    for b, p in enumerate(pos):
        cube = js.roll3(jnp.asarray(ndhi), c - jnp.asarray(p))
        want = js.compute_columns_facemajor(jcfg, cube, jsc, None, c)
        np.testing.assert_allclose(got[b], np.asarray(want), rtol=1e-12,
                                   atol=0)


def test_march_matches_pallas_grid_f32():
    """The port's plain march == the Pallas grid-frame march kernel
    (interpret mode) in f32."""
    from c2ray_tpu.ops.sweep_pallas import compute_columns_pallas_grid

    n = 16
    c = n // 2
    jcfg, pcfg = _pair(n, "float32", use_lls=False)
    jsc, psc = _scalars(jcfg, pcfg, 2.9e24, 0.0)
    ndhi = _field(n, np.float32, seed=5)
    pos = np.asarray(POSITIONS, np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = compute_columns_pallas_grid(jcfg, jnp.asarray(ndhi),
                                           jnp.asarray(pos), jsc, c)
    got = pk.compute_columns_grid(pcfg, torch.from_numpy(ndhi),
                                  torch.from_numpy(pos), psc, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_consume_matches_pallas_consume_f32():
    """The port's plain consume == consume_rates_pallas (interpret mode),
    n=32, B=3, LLS type 1 (cf. tests/test_consume.py)."""
    from c2ray_tpu.ops.sweep_pallas import consume_rates_pallas

    n, b = 32, 3
    c = n // 2
    jcfg, pcfg = _pair(n, "float32", sweep_backend="pallas", source_batch=b)
    jtabs, ptabs = _tables(jcfg)
    jsc, psc = _scalars(jcfg, pcfg, 2.9e24 / (n / 64), 1e16)
    rng = np.random.default_rng(5)
    pos = rng.integers(0, n, (b, 3)).astype(np.int32)
    nflux = (10.0 ** rng.uniform(4, 6, b)).astype(np.float32)
    ndens = rng.uniform(1e-4, 3e-4, (n,) * 3).astype(np.float32)
    xh = rng.uniform(0.1, 0.9, (n,) * 3).astype(np.float32)
    cdo = np.cumsum(np.random.default_rng(9).uniform(1e15, 2e16,
                                                     (b, n, n, n)),
                    axis=3).astype(np.float32)
    ndhi = js.neutral_density(jcfg, jnp.asarray(ndens), jnp.asarray(xh))
    ph_w, _, loss_w, lls_w = consume_rates_pallas(
        jcfg, jtabs, jnp.asarray(cdo), ndhi, None, jnp.asarray(pos),
        jnp.asarray(nflux), None, jsc, c, interpret=True)
    ph, heat, loss, lls = pk.consume_rates(
        pcfg, ptabs, torch.from_numpy(cdo),
        torch.from_numpy(np.array(ndhi)), torch.from_numpy(pos),
        torch.from_numpy(nflux), psc, c)
    assert heat is None                      # isothermal
    np.testing.assert_allclose(ph.numpy(), np.asarray(ph_w), rtol=2e-5,
                               atol=0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_w), rtol=2e-5)
    np.testing.assert_allclose(lls.numpy(), np.asarray(lls_w), rtol=2e-5)


def test_consume_heat_matches_pallas_consume_f32():
    """The heat build's plain version: phiheat == consume_rates_pallas
    with has_heat (interpret mode) at rtol 2e-5, as tests/test_consume.py
    holds the JAX kernel, n=32, B=2, LLS type 1; phih and the losses as
    well.  At a zero-density cell the heat stays finite (the port divides
    by vol_ph, not by the TPU form's 1/(vol*ndhi)*ndhi).  The fluxes
    (10^6..10^9 S*) and the cell size (7.25e23 cm) are the main path's:
    with tests/test_consume.py's weaker sources in 5.8e24 cm cells the
    heating terms of far cells are float32 subnormals, which XLA's CPU
    backend flushes to zero and torch keeps."""
    from c2ray_tpu.ops.sweep_pallas import consume_rates_pallas

    n, b = 32, 2
    c = n // 2
    jcfg, pcfg = _pair(n, "float32", sweep_backend="pallas", source_batch=b,
                       isothermal=False)
    jtabs, ptabs = _tables(jcfg)
    jsc, psc = _scalars(jcfg, pcfg, 7.25e23, 1e16)
    rng = np.random.default_rng(11)
    pos = rng.integers(0, n, (b, 3)).astype(np.int32)
    nflux = (10.0 ** rng.uniform(6, 9, b)).astype(np.float32)
    ndens = rng.uniform(1e-4, 3e-4, (n,) * 3).astype(np.float32)
    xh = rng.uniform(0.1, 0.9, (n,) * 3).astype(np.float32)
    cdo = np.cumsum(rng.uniform(1e15, 2e16, (b, n, n, n)),
                    axis=3).astype(np.float32)
    ndhi = np.array(js.neutral_density(jcfg, jnp.asarray(ndens),
                                       jnp.asarray(xh)))
    ph_w, heat_w, loss_w, lls_w = consume_rates_pallas(
        jcfg, jtabs, jnp.asarray(cdo), jnp.asarray(ndhi), None,
        jnp.asarray(pos), jnp.asarray(nflux), None, jsc, c, interpret=True)
    args = (torch.from_numpy(pos), torch.from_numpy(nflux), psc, c)
    ph, heat, loss, lls = pk.consume_rates(
        pcfg, ptabs, torch.from_numpy(cdo), torch.from_numpy(ndhi), *args)
    assert heat.dtype == torch.float32 and heat.shape == (n, n, n)
    assert float(heat.max()) > 0.0
    np.testing.assert_allclose(heat.numpy(), np.asarray(heat_w), rtol=2e-5,
                               atol=0)
    np.testing.assert_allclose(ph.numpy(), np.asarray(ph_w), rtol=2e-5,
                               atol=0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_w), rtol=2e-5)
    np.testing.assert_allclose(lls.numpy(), np.asarray(lls_w), rtol=2e-5)
    # one zero-density cell, next to the first source
    nd0 = ndhi.copy()
    cell = tuple((pos[0] + [1, 0, 0]) % n)
    nd0[cell] = 0.0
    ph0, heat0, loss0, _ = pk.consume_rates(
        pcfg, ptabs, torch.from_numpy(cdo), torch.from_numpy(nd0), *args)
    assert bool(torch.isfinite(heat0).all())
    assert bool(torch.isfinite(loss0).all())
    # no gas there absorbs nothing; its per-atom rate is 0/0
    assert float(heat0[cell]) == 0.0 and bool(torch.isnan(ph0[cell]))


@pytest.mark.parametrize("rate_eval", ["table", "expsum"])
def test_sweep_single_source_f64(rate_eval):
    n = 16
    jcfg, pcfg = _pair(n, "float64", rate_eval=rate_eval)
    jtabs, ptabs = _tables(jcfg)
    jsc, psc = _scalars(jcfg, pcfg, 2.9e24 / 4, 1e17)
    ndhi = _field(n, np.float64, seed=7)
    want = js.sweep_single_source(jcfg, jtabs, jnp.asarray(ndhi),
                                  jnp.asarray(0.3), jsc)
    got = ps.sweep_single_source(pcfg, ptabs, torch.from_numpy(ndhi),
                                 torch.tensor(0.3, dtype=torch.float64), psc)
    for name in ("phih", "coldensh_out"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-12, atol=0, err_msg=name)
    # losses: see test_raytrace_all_sources_f64
    for name in ("photon_loss", "lls_loss"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-12, atol=1e-12 * 0.3, err_msg=name)


@pytest.mark.parametrize("source_batch", [1, 3])
def test_raytrace_all_sources_f64(source_batch):
    """The port's full-cube raytrace (plain kernels on the CPU) == the
    JAX one, f64 expsum rates with LLS type 1, 5 sources in batches."""
    n = 16
    jcfg, pcfg = _pair(n, "float64", rate_eval="expsum",
                       source_batch=source_batch)
    jtabs, ptabs = _tables(jcfg)
    jsc, psc = _scalars(jcfg, pcfg, 2.9e24 / 4, 1e17)
    rng = np.random.default_rng(11)
    ndens = rng.uniform(1e-4, 3e-4, (n,) * 3)
    xh = rng.uniform(0.0, 0.9, (n,) * 3)
    pos = np.asarray(POSITIONS + [[5, 9, 2]], np.int32)
    nflux = 10.0 ** rng.uniform(-1, 1, len(pos))
    want = js.raytrace_all_sources(jcfg, jtabs, jnp.asarray(ndens),
                                   jnp.asarray(xh), jnp.asarray(pos),
                                   jnp.asarray(nflux), jsc)
    got = ps.raytrace_all_sources(pcfg, ptabs, torch.from_numpy(ndens),
                                  torch.from_numpy(xh), torch.from_numpy(pos),
                                  torch.from_numpy(nflux), psc)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-12, atol=0)
    # the losses sum photo_out = photo_in - photo_cell, which cancels along
    # optically thick rays: a last-place difference in a column shows up
    # against the source's flux, so the floor is 1e-12 of the total flux
    for i in (2, 3, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-12, atol=1e-12 * nflux.sum())


def test_wrappers_refuse_non_cpu_tensors_without_cuda():
    """A tensor off the CPU never falls back to the plain version: the
    wrapper launches the kernel or raises."""
    n = 8
    _, pcfg = _pair(n, "float32")
    psc = ps.sweep_scalars(pcfg, 1e22, 1e16)
    ndhi = torch.empty((n, n, n), device="meta")
    pos = torch.zeros((1, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pk.compute_columns_grid(pcfg, ndhi, pos, psc, n // 2)
    with pytest.raises((ValueError, NotImplementedError)):
        pk.consume_rates(pcfg, None, torch.empty((1, n, n, n), device="meta"),
                         ndhi, pos, torch.empty(1, device="meta"), psc,
                         n // 2)
    from c2ray_tpu_torch.ops import window_cuda as pw

    wins = torch.empty((1, 5, 5, 5), device="meta")
    with pytest.raises(ValueError):
        pk.compute_columns_windows(pcfg, wins, psc, 2)
    with pytest.raises(ValueError):
        pw.window_gather(ndhi, pos, 2)
    with pytest.raises(ValueError):
        pw.window_scatter_add(ndhi, wins, pos)


def _corner_positions(n):
    """Sources at corners, on wrapping edges and inside."""
    return np.asarray([[0, 0, 0], [n - 1, n - 1, n - 1], [0, n - 1, n // 2],
                       [3 % n, 11 % n, 7 % n]], np.int32)


_LIVE_SQUARE_CASES = [
    pytest.param("grid", n, lls, ms, id=f"{n}-{lls}-{ms}")
    for n, lls, ms in [(15, False, None), (15, True, None), (16, False, None),
                       (16, True, None), (24, False, None), (24, True, None),
                       (16, True, 5)]
] + [
    pytest.param("window", p, lls, ms, id=f"window-{p}-{lls}-{ms}")
    for p, lls, ms in [(9, False, None), (9, True, None), (17, False, None),
                       (17, True, None), (33, False, None), (33, True, None),
                       (17, True, 5)]
]


@pytest.mark.parametrize("mode, n, use_lls, max_shell", _LIVE_SQUARE_CASES)
def test_march_live_square_suffices(monkeypatch, mode, n, use_lls,
                                    max_shell):
    """The premise of the live-square marches, K1's (grid mode, through
    march_columns) and K3's (window mode, through march_windows on a
    batch of p^3 windows): with every plane cell outside |t| <= d-1 zeroed
    before shell d (what the kernels' zero-filled ping-pong planes hold
    there), the plain march gives the bitwise same cube, so shell d need
    only compute |t| <= d."""
    _, pcfg = _pair(n, "float32", use_lls=use_lls)
    c = n // 2
    psc = ps.sweep_scalars(pcfg, 2.9e24 / (n / 16), 1e16)
    if mode == "grid":
        ndhi = torch.from_numpy(_field(n, np.float32, seed=n + 1))
        pos = torch.from_numpy(_corner_positions(n))

        def march(shells):
            return ps.march_columns(pcfg, ndhi, pos, psc, shells)
    else:
        wins = torch.from_numpy(np.stack(
            [_field(n, np.float32, seed=n + q) for q in range(3)]))

        def march(shells):
            return ps.march_windows(pcfg, wins, psc, shells)
    shells = c if max_shell is None else max_shell
    want = march(shells)

    update = ps._wavefront_plane_update
    seen = []

    def live_square_only(prev, ndhi_p, lcol, d, cfg, dr, n_):
        inside = (torch.arange(n_) - n_ // 2).abs() <= d - 1
        square = inside[:, None] & inside[None, :]
        seen.append(int((~square).sum()))
        return update(torch.where(square, prev, torch.zeros_like(prev)),
                      ndhi_p, lcol, d, cfg, dr, n_)

    monkeypatch.setattr(ps, "_wavefront_plane_update", live_square_only)
    got = march(shells)
    assert len(seen) == min(shells, c) and seen[-1] > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("use_lls", [False, True])
@pytest.mark.parametrize("capped", [False, True])
def test_consume_dead_pairs_contribute_nothing(monkeypatch, use_lls, capped):
    """The premise of K2's dead-pair skip: with the mixture results of
    every dead (cell, source) pair (beyond max_shell, or incoming column
    above max_coldensh) replaced by NaN, consume_rates_reference returns
    the same phih, losses and LLS losses bitwise; a zero-density cell stays
    NaN where its pair is live."""
    _dead_pairs_case(monkeypatch, use_lls, capped, isothermal=True)


@pytest.mark.parametrize("use_lls", [False, True])
@pytest.mark.parametrize("capped", [False, True])
def test_consume_dead_pairs_add_no_heat(monkeypatch, use_lls, capped):
    """The same premise for the heat build: dead pairs' NaN mixture
    results leave phiheat (and phih and the losses) bitwise unchanged,
    and phiheat stays finite at the zero-density cell."""
    got = _dead_pairs_case(monkeypatch, use_lls, capped, isothermal=False)
    assert bool(torch.isfinite(got[1]).all()) and float(got[1].max()) > 0


@pytest.mark.parametrize("isothermal", [True, False])
def test_consume_pairs_beyond_rmax_add_nothing(monkeypatch, isothermal):
    """The premise of K2's R_max test in its dead-pair skip (LLS type 3):
    with the mixture results of every pair beyond the barrier (and every
    other dead pair) replaced by NaN, consume_rates_reference returns the
    same phih, phiheat and losses bitwise; some pairs are dead by the
    barrier alone."""
    _dead_pairs_case(monkeypatch, True, False, isothermal, rmax=5.0)


def _dead_pairs_case(monkeypatch, use_lls, capped, isothermal, rmax=None):
    from c2ray_tpu_torch.ops.tables import build_rad_tables

    n, b = 16, 3
    c = n // 2
    max_shell = c // 2 if capped else c
    _, pcfg = _pair(n, "float32", use_lls=use_lls, source_batch=b,
                    isothermal=isothermal,
                    type_of_lls=1 if rmax is None else 3)
    tabs = build_rad_tables(pcfg, device="cpu")
    psc = ps.sweep_scalars(pcfg, 1e21, 1e16,
                           rmax if rmax is not None else 0.0)
    rng = np.random.default_rng(17)
    ndhi = _field(n, np.float32, seed=3)
    # columns climb past max_coldensh (2e19) along the fast axis
    cdo = np.cumsum(rng.uniform(1e17, 4e18, (b, n, n, n)), axis=3)
    pos_np = _corner_positions(n)[:b]
    # a zero-density cell two cells from source 0, its pair there live
    zero = np.array([1, 2, 1])
    ndhi[tuple(zero)] = 0.0
    cdo[(0, *((zero - pos_np[0] + c) % n))] = 1e17
    pos = torch.from_numpy(pos_np)
    nflux = torch.from_numpy((10.0 ** rng.uniform(6, 9, b))
                             .astype(np.float32))
    args = (pcfg, tabs, torch.from_numpy(cdo.astype(np.float32)),
            torch.from_numpy(ndhi), pos, nflux, psc, max_shell)
    want = pk.consume_rates_reference(*args)

    o = (torch.arange(n) - c).abs()
    cheb = torch.maximum(torch.maximum(o[:, None, None], o[None, :, None]),
                         o[None, None, :])
    of = o.to(torch.float32)
    dist2 = (of[:, None, None] ** 2 + of[None, :, None] ** 2
             + of[None, None, :] ** 2)
    dead_pairs, by_rmax = [], []

    def poison(fn):
        def wrapped(cfg, tables, coldensh_in, *rest):
            dead = (cheb > max_shell) | (coldensh_in > cfg.max_coldensh)
            if rmax is not None:
                beyond = dist2 > psc.rmax2_cells
                by_rmax.append(int((beyond & ~dead).sum()))
                dead = dead | beyond
            dead_pairs.append(int(dead.sum()))
            out = fn(cfg, tables, coldensh_in, *rest)
            nan = lambda x: torch.where(dead, float("nan"), x)  # noqa: E731
            if isinstance(out, tuple) and not hasattr(out, "_fields"):
                rates, lls_cell = out
                return type(rates)(*map(nan, rates)), nan(lls_cell)
            return type(out)(*map(nan, out))
        return wrapped

    monkeypatch.setattr(ps, "photoion_rates", poison(ps.photoion_rates))
    monkeypatch.setattr(ps, "photoion_rates_lls_fused",
                        poison(ps.photoion_rates_lls_fused))
    got = pk.consume_rates_reference(*args)
    assert len(dead_pairs) == b and 0 < min(dead_pairs)
    assert max(dead_pairs) < n ** 3
    if rmax is not None:
        assert min(by_rmax) > 0
    assert bool(torch.isnan(want[0]).any())
    assert (want[1] is None) == isothermal
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        assert torch.equal(torch.isnan(g), torch.isnan(w))
    return got


@pytest.mark.parametrize("dr", [1e21, 2.9e24 / 4])
def test_consume_stop_bound_is_conservative(dr):
    """K2 skips the geometry of a pair when cd - nd * fl(sqrt(3) * dr) >
    max_coldensh: the path is at most sqrt(3) cells and float32 rounding is
    monotonic, so such a pair always has cin > max_coldensh.  Checked in
    float32 at pairs around the threshold, for every cell offset of a
    16^3 cube."""
    n = 16
    _, pcfg = _pair(n, "float32")
    c = n // 2
    rng = np.random.default_rng(23)
    o = torch.arange(n) - c
    oi, oj, ok = o[:, None, None], o[None, :, None], o[None, None, :]
    cheb = torch.maximum(torch.maximum(oi.abs(), oj.abs()), ok.abs())
    dom = cheb.to(torch.float32)
    dist2 = (oi * oi + oj * oj + ok * ok).to(torch.float32)
    path = torch.sqrt((dist2 - dom * dom) / dom.clamp(min=1.0) ** 2 + 1.0)
    path = torch.where(cheb == 0, 0.5, path)
    dr32 = torch.tensor(dr, dtype=torch.float32)
    col_hi_per_nd = torch.tensor(np.float32(np.sqrt(3.0))) * dr32
    top = torch.tensor(pcfg.max_coldensh, dtype=torch.float32)
    for _ in range(20):
        nd = torch.from_numpy(rng.uniform(0.0, 2e-4, (n, n, n))
                              .astype(np.float32))
        colcell = nd * (path * dr32)
        col_hi = nd * col_hi_per_nd
        # columns within a few cells' worth of the threshold
        cd = top + torch.from_numpy(rng.uniform(-2.0, 3.0, (n, n, n))
                                    .astype(np.float32)) * col_hi
        cin = torch.clamp(cd - colcell, min=0.0)
        sure = cd - col_hi > top
        assert bool(sure.any()) and not bool(sure.all())
        assert bool((cin[sure] > top).all())
