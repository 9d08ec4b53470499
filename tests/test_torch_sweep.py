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

from c2ray_tpu_torch import constants as const
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


def _grow(lo, hi, k, c):
    """The plane interval [lo, hi] of shell d and what it reads through
    its corners back to shell d-k: one cell more toward the source a
    shell, until it holds both c-1 and c (csrc/march.cu's grow)."""
    if lo >= c:
        lo = max(lo - k, c - 1)
    if hi < c:
        hi = min(hi + k, c)
    return lo, hi


def _blocked_march(cfg, ndhi, pos, sc, max_shell, lls, shells, tile):
    """A plain model of K1's shell-blocked schedule (csrc/march.cu grid
    mode): groups of `shells` shells, the z faces' from their own offsets
    and a group ahead; per step the z faces, then the y faces, then the x
    faces, each face's live square in tiles `tile` wide; a tile marches
    its group in its own two buffers from shell d0-1 read over the tile and
    its one-sided halo (zero outside live(d0-1)), on a region that shrinks
    toward the tile a shell; wedge fixups read from an edge buffer of the
    higher faces' boundary rings, written by the tiles that own them.  The
    planes and the edge buffer start as NaN, and the output too where
    every cell is written, so a cell read before it is written shows."""
    n = ndhi.shape[0]
    c = n // 2
    nb = pos.shape[0]
    nshell = min(max_shell, c)
    dt = ndhi.dtype
    p = pos.to(torch.int64)
    nan = float("nan")
    planes = torch.full((2, nb, 6, n, n), nan, dtype=dt)
    out = torch.full((nb, n, n, n), 0.0 if nshell < c else nan, dtype=dt)
    edge = torch.full((nb, nshell + 1, 12, n), nan, dtype=dt)
    cdo0 = ndhi[p[:, 0], p[:, 1], p[:, 2]] * (0.5 * sc.dr)
    lls_on = cfg.use_lls and cfg.type_of_lls in (1, 2)
    transverse = {2: (0, 1), 1: (0, 2), 0: (1, 2)}

    def live(d):
        return c - d, min(c + d, n - 1)

    def clip(iv, d):
        lo, hi = live(d)
        return max(iv[0], lo), min(iv[1], hi)

    def plane(cube, f, d, ra, rb):
        ax, s = ps._FACES[f][:2]
        ta, tb = transverse[ax]
        idx = [None] * 3
        idx[ax] = ((p[:, ax] + s * d) % n)[:, None, None]
        idx[ta] = ((ra[None, :] + p[:, ta, None] - c) % n)[:, :, None]
        idx[tb] = ((rb[None, :] + p[:, tb, None] - c) % n)[:, None, :]
        return cube[tuple(idx)]

    def values(prev, o, f, d, ra, rb):
        # ops/sweep._wavefront_plane_update's arithmetic on the region
        df = torch.tensor(float(d), dtype=dt)
        inv_d = 1.0 / df
        ia, ib = ra - o[0], rb - o[1]
        am = torch.where(ra >= c, ra - 1, ra + 1) - o[0]
        bm = torch.where(rb >= c, rb - 1, rb + 1) - o[1]
        c4 = prev[:, ia][:, :, ib]
        c3 = prev[:, am][:, :, ib]
        c2 = prev[:, ia][:, :, bm]
        c1 = prev[:, am][:, :, bm]
        ta = (ra - c).to(dt)[:, None]
        tb = (rb - c).to(dt)[None, :]
        f_a = torch.clamp((df - torch.abs(ta)) * inv_d, 0.0, 1.0)
        f_b = torch.clamp((df - torch.abs(tb)) * inv_d, 0.0, 1.0)
        s1 = (1.0 - f_a) * (1.0 - f_b)
        s2 = f_a * (1.0 - f_b)
        s3 = (1.0 - f_a) * f_b
        s4 = f_a * f_b

        def wf(cd):
            return 1.0 / torch.clamp(cd * const.SIGMA_HI_AT_ION_FREQ,
                                     min=0.6)

        w1, w2, w3, w4 = s1 * wf(c1), s2 * wf(c2), s3 * wf(c3), s4 * wf(c4)
        cdensi = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) / (w1 + w2 + w3
                                                              + w4)
        if d == 1:
            a1 = (np.abs(ra.numpy() - c) == 1)[:, None]
            b1 = (np.abs(rb.numpy() - c) == 1)[None, :]
            diag = np.where(a1 & b1, ps.SQRT3,
                            np.where(a1 | b1, ps.SQRT2, 1.0))
            cdensi = cdensi * torch.as_tensor(diag, dtype=dt)
        path = torch.sqrt((ta * ta + tb * tb) * (inv_d * inv_d) + 1.0)
        cin = cdensi
        if lls_on:
            lcol = (plane(lls, f, d, ra, rb) if lls is not None
                    else sc.lls_coldens)
            cin = cin + lcol * path
        return cin + plane(ndhi, f, d, ra, rb) * (path * sc.dr)

    def march_group(f, g, d0, d1):
        # face f's group g, shells d0..d1: its tiles cover live(d1)
        ns = d1 - d0 + 1
        lo, hi = live(d1)
        tiles = [(t, min(t + tile - 1, hi)) for t in range(lo, hi + 1, tile)]
        for tile_a in tiles:
            for tile_b in tiles:
                box_a = _grow(*tile_a, ns, c)
                box_b = _grow(*tile_b, ns, c)
                o = (box_a[0], box_b[0])
                ra = torch.arange(box_a[0], box_a[1] + 1)
                rb = torch.arange(box_b[0], box_b[1] + 1)
                if d0 == 1:
                    buf = torch.zeros((nb, len(ra), len(rb)), dtype=dt)
                    if box_a[0] <= c <= box_a[1] and \
                            box_b[0] <= c <= box_b[1]:
                        buf[:, c - o[0], c - o[1]] = cdo0
                else:
                    la, lb = live(d0 - 1)
                    inside = (((ra >= la) & (ra <= lb))[:, None]
                              & ((rb >= la) & (rb <= lb))[None, :])
                    old = planes[(g + 1) % 2, :, f][:, ra][:, :, rb]
                    buf = torch.where(inside, old,
                                      torch.zeros((), dtype=dt))
                bufs = [buf, buf.clone()]
                for k in range(ns):
                    d = d0 + k
                    ga = clip(_grow(*tile_a, ns - 1 - k, c), d)
                    gb = clip(_grow(*tile_b, ns - 1 - k, c), d)
                    if ga[0] > ga[1] or gb[0] > gb[1]:
                        continue
                    qa = torch.arange(ga[0], ga[1] + 1)
                    qb = torch.arange(gb[0], gb[1] + 1)
                    v = values(bufs[k % 2], o, f, d, qa, qb)
                    hp = c + d < n
                    pp, m = (c + d) % n, c - d
                    # fixups: rows from y, then columns from z
                    if f >= 4:
                        sx = f - 4
                        for row, line in ((c + d, 8), (m, 10)):
                            if (row != c + d or hp) and \
                                    ga[0] <= row <= ga[1]:
                                v[:, row - ga[0]] = \
                                    edge[:, d, line + sx, gb[0]:gb[1] + 1]
                    if f >= 2:
                        s_ = f % 2
                        lines = (0, 4) if f < 4 else (2, 6)
                        for col, line in zip((c + d, m), lines):
                            if (col != c + d or hp) and \
                                    gb[0] <= col <= gb[1]:
                                v[:, :, col - gb[0]] = \
                                    edge[:, d, line + s_, ga[0]:ga[1] + 1]
                    cur = bufs[(k + 1) % 2]
                    cur[:, ga[0] - o[0]:ga[1] - o[0] + 1,
                        gb[0] - o[1]:gb[1] - o[1] + 1] = v
                    # the tile's own cells: rings, output
                    ta_, tb_ = clip(tile_a, d), clip(tile_b, d)
                    if ta_[0] > ta_[1] or tb_[0] > tb_[1]:
                        continue
                    sa = slice(ta_[0], ta_[1] + 1)
                    sb = slice(tb_[0], tb_[1] + 1)
                    vt = v[:, ta_[0] - ga[0]:ta_[1] - ga[0] + 1,
                           tb_[0] - gb[0]:tb_[1] - gb[0] + 1]
                    rings = []
                    if f < 2:
                        rings = [("col", pp, 4 * f), ("col", m, 4 * f + 1),
                                 ("row", pp, 4 * f + 2),
                                 ("row", m, 4 * f + 3)]
                    elif f < 4:
                        rings = [("row", pp, 8 + 2 * (f - 2)),
                                 ("row", m, 9 + 2 * (f - 2))]
                    for kind, at, line in rings:
                        if kind == "col" and tb_[0] <= at <= tb_[1]:
                            edge[:, d, line, sa] = vt[:, :, at - tb_[0]]
                        if kind == "row" and ta_[0] <= at <= ta_[1]:
                            edge[:, d, line, sb] = vt[:, at - ta_[0]]
                    orow = c + d if f % 2 == 0 else c - d
                    if orow < n:
                        ka = (torch.arange(ta_[0], ta_[1] + 1) - c).abs()
                        kb = (torch.arange(tb_[0], tb_[1] + 1) - c).abs()
                        own = (torch.ones_like(vt[0], dtype=torch.bool)
                               if f < 2 else (kb < d)[None, :].expand(
                                   len(ka), -1).clone())
                        if f >= 4:
                            own &= (ka < d)[:, None]
                        if f < 2:
                            view = out[:, sa, sb, orow]
                        elif f < 4:
                            view = out[:, sa, orow, sb]
                        else:
                            view = out[:, orow, sa, sb]
                        view[:] = torch.where(own, vt, view)
                    if d == 1 and f == 0 and ta_[0] <= c <= ta_[1] \
                            and tb_[0] <= c <= tb_[1]:
                        out[:, c, c, c] = cdo0
                # the tile's cells of shell d1 back to the planes
                ta_, tb_ = clip(tile_a, d1), clip(tile_b, d1)
                final = bufs[ns % 2]
                planes[g % 2, :, f, ta_[0]:ta_[1] + 1,
                       tb_[0]:tb_[1] + 1] = final[
                    :, ta_[0] - o[0]:ta_[1] - o[0] + 1,
                    tb_[0] - o[1]:tb_[1] - o[1] + 1]

    # the groups (csrc/march.cu's grid_offset, grid_z_group): the y and x
    # faces' group l holds shells l*S+1 .. l*S+S; a z face's groups start
    # at its offset, and z stage l marches the group that holds the last
    # shell of the y faces' group l; then y, then x
    offsets = [(c + 1) % shells, (shells - c % shells) % shells, 0, 0, 0, 0]

    def group(f, g):
        o = offsets[f]
        return max(1, g * shells - o + 1), min(g * shells - o + shells, nshell)

    last = [-1, -1]
    for l in range(-1, -(-nshell // shells)):
        for f in (0, 1):
            x = min((l + 1) * shells, nshell) - 1 + offsets[f]
            g = -1 if x < 0 else x // shells
            if g > last[f]:
                assert g == last[f] + 1
                march_group(f, g, *group(f, g))
                last[f] = g
        if l >= 0:
            for f in range(2, 6):
                march_group(f, l, *group(f, l))
    return out


_BLOCKED_CASES = [
    pytest.param(n, lls, s, t, ms, id=f"{n}-{lls}-S{s}-T{t}-{ms}")
    for n in (15, 16, 24) for lls in ("off", "scalar", "grid")
    for s, t, ms in ((1, 5, None), (3, 4, None), (8, 5, None))
] + [
    pytest.param(16, lls, s, 4, 5, id=f"16-{lls}-S{s}-T4-5")
    for lls in ("off", "grid") for s in (3, 8)
]


@pytest.mark.parametrize("n, lls, shells, tile, max_shell", _BLOCKED_CASES)
def test_march_blocked_schedule_is_bitwise(n, lls, shells, tile, max_shell):
    """K1's shell-blocked schedule (a plain model of csrc/march.cu's grid
    mode: shell groups, tiles with a one-sided halo, the classes z, y, x
    in turn, fixups from an edge buffer of the boundary rings) gives the
    plain march's cube bitwise, for sources at corners and wrapping
    edges, at odd and even n (the wrap at d = n/2), with a last partial
    group, a capped radius, and tiles that span the centre and not."""
    _, pcfg = _pair(n, "float32", use_lls=lls != "off",
                    type_of_lls=2 if lls == "grid" else 1)
    psc = ps.sweep_scalars(pcfg, 2.9e24 / (n / 16), 1e16)
    ndhi = torch.from_numpy(_field(n, np.float32, seed=n + 3))
    grid = (torch.from_numpy(_field(n, np.float32, seed=n + 4) * 1e20)
            if lls == "grid" else None)
    pos = torch.from_numpy(_corner_positions(n))
    shells_run = n // 2 if max_shell is None else max_shell
    want = ps.march_columns(pcfg, ndhi, pos, psc, shells_run, grid)
    got = _blocked_march(pcfg, ndhi, pos, psc, shells_run, grid, shells,
                         tile)
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


def _dead_pairs_case(monkeypatch, use_lls, capped, isothermal, rmax=None,
                     dtype="float32", rate_eval="auto"):
    """The dead-pair premise in `dtype` with `rate_eval`'s rates (the
    mixture, or the tables: "auto" in float64; tests/test_torch_f64_table
    runs those)."""
    from c2ray_tpu_torch.ops.tables import build_rad_tables

    n, b = 16, 3
    c = n // 2
    max_shell = c // 2 if capped else c
    _, pcfg = _pair(n, dtype, use_lls=use_lls, source_batch=b,
                    isothermal=isothermal, rate_eval=rate_eval,
                    type_of_lls=1 if rmax is None else 3)
    npt = pcfg.np_dtype
    tabs = build_rad_tables(pcfg, device="cpu")
    psc = ps.sweep_scalars(pcfg, 1e21, 1e16,
                           rmax if rmax is not None else 0.0)
    rng = np.random.default_rng(17)
    ndhi = _field(n, npt, seed=3)
    # columns climb past max_coldensh (2e19) along the fast axis
    cdo = np.cumsum(rng.uniform(1e17, 4e18, (b, n, n, n)), axis=3)
    pos_np = _corner_positions(n)[:b]
    # a zero-density cell two cells from source 0, its pair there live
    zero = np.array([1, 2, 1])
    ndhi[tuple(zero)] = 0.0
    cdo[(0, *((zero - pos_np[0] + c) % n))] = 1e17
    pos = torch.from_numpy(pos_np)
    nflux = torch.from_numpy((10.0 ** rng.uniform(6, 9, b)).astype(npt))
    args = (pcfg, tabs, torch.from_numpy(cdo.astype(npt)),
            torch.from_numpy(ndhi), pos, nflux, psc, max_shell)
    want = pk.consume_rates_reference(*args)

    o = (torch.arange(n) - c).abs()
    cheb = torch.maximum(torch.maximum(o[:, None, None], o[None, :, None]),
                         o[None, None, :])
    of = o.to(pcfg.torch_dtype)
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
    _stop_bound_case(dr, "float32")


def _stop_bound_case(dr, dtype):
    """The stop bound's premise in `dtype` (tests/test_torch_f64_table
    runs float64)."""
    n = 16
    _, pcfg = _pair(n, dtype)
    tdt, npt = pcfg.torch_dtype, pcfg.np_dtype
    c = n // 2
    rng = np.random.default_rng(23)
    o = torch.arange(n) - c
    oi, oj, ok = o[:, None, None], o[None, :, None], o[None, None, :]
    cheb = torch.maximum(torch.maximum(oi.abs(), oj.abs()), ok.abs())
    dom = cheb.to(tdt)
    dist2 = (oi * oi + oj * oj + ok * ok).to(tdt)
    path = torch.sqrt((dist2 - dom * dom) / dom.clamp(min=1.0) ** 2 + 1.0)
    path = torch.where(cheb == 0, 0.5, path)
    dr_t = torch.tensor(dr, dtype=tdt)
    col_hi_per_nd = torch.tensor(npt(np.sqrt(3.0))) * dr_t
    top = torch.tensor(pcfg.max_coldensh, dtype=tdt)
    for _ in range(20):
        nd = torch.from_numpy(rng.uniform(0.0, 2e-4, (n, n, n))
                              .astype(npt))
        colcell = nd * (path * dr_t)
        col_hi = nd * col_hi_per_nd
        # columns within a few cells' worth of the threshold
        cd = top + torch.from_numpy(rng.uniform(-2.0, 3.0, (n, n, n))
                                    .astype(npt)) * col_hi
        cin = torch.clamp(cd - colcell, min=0.0)
        sure = cd - col_hi > top
        assert bool(sure.any()) and not bool(sure.all())
        assert bool((cin[sure] > top).all())
