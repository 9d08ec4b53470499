"""The PyTorch port's windowed sweep against the JAX package's: the plain
versions of the window gather, scatter-add and fold (held against the
Pallas window kernels in interpret mode), the plain window march (held
against the Pallas march kernel in interpret mode), and the windowed and
radius-capped raytraces, on inputs made with numpy from a seed."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.ops import sweep as js
from c2ray_tpu.ops import window_pallas as wp
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables

from c2ray_tpu_torch.convert import config_from_dict, tables_from_numpy
from c2ray_tpu_torch.ops import sweep as ps
from c2ray_tpu_torch.ops import sweep_cuda as pk
from c2ray_tpu_torch.ops import window_cuda as pw

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


@pytest.mark.parametrize("n,r", [(24, 4), (32, 6), (30, 4), (20, 8)])
def test_window_gather_scatter_fold_match_pallas(n, r):
    """The cases of tests/test_consume.py::test_window_dma_kernels_
    interpret, with a repeated position and a pair of windows that
    overlap across the periodic boundary (corners at 0 and n-1), and the
    production ladder's first rung, r = 8 (p = 17)."""
    b = 7
    p = 2 * r + 1
    rng = np.random.default_rng(3)
    field = rng.normal(size=(n, n, n)).astype(np.float32)
    pos = rng.integers(0, n, (b, 3)).astype(np.int32)
    pos[1] = pos[0]                      # two windows at one position
    pos[2] = [0, 0, 0]                   # overlaps pos[3] across the wrap
    pos[3] = [n - 1, n - 2, n - 1]
    rates = rng.normal(size=(b, p, p, p)).astype(np.float32)

    fpad = np.pad(field, r, mode="wrap")
    want = wp.window_gather(wp.with_lane_margin(jnp.asarray(fpad), n, r),
                            jnp.asarray(pos), r, interpret=True)
    got = pw.window_gather(torch.from_numpy(fpad), torch.from_numpy(pos), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jacc = wp.window_scatter_add(
        jnp.zeros(wp.padded_acc_shape(n, r), jnp.float32),
        jnp.asarray(rates), jnp.asarray(pos), interpret=True)
    acc = torch.zeros(pw.padded_acc_shape(n, r), dtype=torch.float32)
    out = pw.window_scatter_add(acc, torch.from_numpy(rates),
                                torch.from_numpy(pos))
    assert out is acc                    # in place
    m = n + 2 * r
    # both add the windows in window order: bitwise equal
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc)[:m, :m, :m])
    np.testing.assert_array_equal(pw.fold_padded_acc(acc, n, r).numpy(),
                                  np.asarray(wp.fold_padded_acc(jacc, n, r)))


def _owner_rule_scatter(acc, rates, pos):
    """numpy emulation of K5 (csrc/window.cu scatter_slabs) on a copy of
    acc: per (window w, x-slab i) the list of windows whose box meets the
    slab, in index order; a block whose window has a lower-index twin at
    its corner writes nothing; a cell belongs to the lowest-index window
    covering it, which sums acc + rates[w] + the later covering windows'
    terms, in index order."""
    acc = acc.copy()
    m = acc.shape[0]
    b, p = rates.shape[:2]
    ok = ((pos >= 0) & (pos <= m - p)).all(axis=1)
    jj, kk = np.meshgrid(np.arange(p), np.arange(p), indexing="ij")
    idx = np.arange(b)
    for w in range(b):
        q0, q1, q2 = (int(c) for c in pos[w])
        listed = ok & (idx != w)
        if not ok[w] or (listed & (idx < w)
                         & (pos == pos[w]).all(axis=1)).any():
            continue
        for i in range(p):
            x = q0 + i
            near = np.nonzero(listed & (pos[:, 0] <= x) & (x < pos[:, 0] + p)
                              & (np.abs(pos[:, 1] - q1) < p)
                              & (np.abs(pos[:, 2] - q2) < p))[0]
            mine = np.ones((p, p), bool)
            cover = {}
            for v in near:
                y, z = jj + q1 - pos[v, 1], kk + q2 - pos[v, 2]
                cover[v] = (y, z, (y >= 0) & (y < p) & (z >= 0) & (z < p))
                if v < w:
                    mine &= ~cover[v][2]
            s = acc[x, q1:q1 + p, q2:q2 + p] + rates[w, i]
            for v in near[near > w]:
                y, z, c = cover[v]
                c = c & mine
                s[c] += rates[v, x - pos[v, 0], y[c], z[c]]
            acc[x, q1 + jj[mine], q2 + kk[mine]] = s[mine]
    return acc


def _owner_rule_case(case):
    rng = np.random.default_rng(17)
    if case == "random":                 # B = 64 at p = 9, random corners
        n, r, b = 16, 4, 64
        pos = rng.integers(0, n, (b, 3))
    elif case.startswith("padding"):     # 16 live windows, 240 at corner 0
        n, r, b = 12, 2, 256
        pos = np.zeros((b, 3), np.int64)
        pos[:16] = rng.integers(0, n, (16, 3))
    elif case == "touching":             # corners p-1 and p apart per axis
        n, r = 16, 2
        p = 2 * r + 1
        c, d = p - 1, p                  # touching, just apart
        pos = p + np.asarray([[0, 0, 0], [c, 0, 0], [d, 0, 0], [0, c, c],
                              [0, d, 0], [0, 0, d], [c, c, c], [-c, c, -c],
                              [-d, 0, 0]])
        b = len(pos)
    else:                                # all windows identical
        n, r, b = 12, 3, 40
        pos = np.tile([[4, 9, 2]], (b, 1))
    p = 2 * r + 1
    m = n + 2 * r
    rates = rng.normal(size=(b, p, p, p)).astype(np.float32)
    if case == "padding-zero":
        rates[16:] = 0.0
    acc = rng.normal(size=(m, m, m)).astype(np.float32)
    return acc, rates, pos.astype(np.int32)


@pytest.mark.parametrize("case", ["random", "padding-zero", "padding-rates",
                                  "touching", "identical"])
def test_scatter_owner_rule_is_window_order(case):
    """K5's premise: the owner rule (a cell summed by the lowest-index
    window covering it, in index order, with the kernel's lists and early
    exit) gives bitwise what window_scatter_add_reference gives, on an
    accumulator that starts nonzero, rates of both signs."""
    acc, rates, pos = _owner_rule_case(case)
    want = pw.window_scatter_add_reference(
        torch.from_numpy(acc.copy()), torch.from_numpy(rates),
        torch.from_numpy(pos)).numpy()
    got = _owner_rule_scatter(acc, rates, pos)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(want, acc)


@pytest.mark.parametrize("case", ["random", "padding-rates", "identical"])
@pytest.mark.parametrize("limit", [1, 5, 16, 255])
def test_scatter_in_chunks_is_one_call(case, limit):
    """window_scatter_add's split of a batch above the kernel's window
    limit, with the plain version standing in for the kernel: consecutive
    chunks in window order give bitwise one call's result, with one
    launch per chunk."""
    acc, rates, pos = _owner_rule_case(case)
    b = rates.shape[0]
    want = pw.window_scatter_add_reference(
        torch.from_numpy(acc.copy()), torch.from_numpy(rates),
        torch.from_numpy(pos)).numpy()
    calls = []

    def launch(acc_pad, r, q):
        calls.append(r.shape[0])
        assert r.is_contiguous() and q.is_contiguous()
        pw.window_scatter_add_reference(acc_pad, r, q)

    got = torch.from_numpy(acc.copy())
    launches = pw.scatter_in_chunks(got, torch.from_numpy(rates),
                                    torch.from_numpy(pos), limit, launch)
    assert launches == len(calls) == -(-b // limit)
    assert sum(calls) == b and max(calls) <= limit
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_windowed_prepass_is_the_wrap_pad():
    jcfg, pcfg = _pair(12, "float64")
    rng = np.random.default_rng(4)
    nd = rng.uniform(1e-4, 3e-4, (12,) * 3)
    x = rng.uniform(0.0, 1.0, (12,) * 3)
    for r in (1, 5):
        want, _ = js.windowed_prepass(jcfg, jnp.asarray(nd), jnp.asarray(x),
                                      None, r)
        got = ps.windowed_prepass(pcfg, torch.from_numpy(nd),
                                  torch.from_numpy(x), r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [9, 13, 17])
def test_window_march_matches_pallas(p):
    """The port's window march (plain, as the K3 wrapper takes it on the
    CPU) == the Pallas march kernel on source-centred cubes, B = 3."""
    from c2ray_tpu.ops.sweep_pallas import compute_columns_pallas

    r = p // 2
    jcfg, pcfg = _pair(p, "float32")
    jsc, psc = _scalars(jcfg, pcfg, 2.9e24, 5e16)
    rng = np.random.default_rng(p)
    wins = (rng.uniform(0.2, 1.0, (3, p, p, p)) * 2e-4).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = compute_columns_pallas(jcfg, jnp.asarray(wins), jsc, r)
    got = pk.compute_columns_windows(pcfg, torch.from_numpy(wins), psc, r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_batched_rate_pass_equals_per_window():
    """_rate_pass over a (B,p,p,p) batch with (B,1,1,1) fluxes == one call
    per window (the JAX windowed_batch vmaps it)."""
    p, r = 11, 5
    _, pcfg = _pair(p, "float64", rate_eval="expsum")
    _, ptabs = _tables(jax_config(mesh=p, dtype="float64",
                                  cosmological=False, rate_eval="expsum"))
    psc = ps.sweep_scalars(pcfg, 2.9e24 / 4, 1e17)
    rng = np.random.default_rng(8)
    wins = torch.from_numpy(rng.uniform(0.2, 1.0, (4, p, p, p)) * 2e-4)
    nf = torch.from_numpy(10.0 ** rng.uniform(-1, 1, 4))
    cdo = ps.march_windows(pcfg, wins, psc, r)
    got = ps._rate_pass(pcfg, ptabs, cdo, wins, nf[:, None, None, None],
                        psc, None, r)
    for i in range(4):
        one = ps._rate_pass(pcfg, ptabs, cdo[i], wins[i], nf[i], psc, None,
                            r)
        np.testing.assert_array_equal(got.phih[i].numpy(), one.phih.numpy())
        for name in ("photon_loss", "lls_loss"):
            np.testing.assert_allclose(getattr(got, name)[i].numpy(),
                                       getattr(one, name).numpy(),
                                       rtol=1e-13, atol=0)


POSITIONS = [[3, 11, 7], [0, 0, 15], [8, 8, 8], [15, 1, 0], [3, 11, 7],
             [5, 9, 2]]


def _raytrace_pair(shell_arg=None, **kw):
    n = 16
    jcfg, pcfg = _pair(n, "float64", rate_eval="expsum", source_batch=4, **kw)
    jtabs, ptabs = _tables(jcfg)
    # thin cells (~1e18 cm^-2 each), so photons reach the window faces
    jsc, psc = _scalars(jcfg, pcfg, 1e22, 1e17)
    rng = np.random.default_rng(11)
    ndens = rng.uniform(1e-4, 3e-4, (n,) * 3)
    xh = rng.uniform(0.0, 0.9, (n,) * 3)
    pos = np.asarray(POSITIONS, np.int32)
    nflux = 10.0 ** rng.uniform(-1, 1, len(pos))
    want = js.raytrace_all_sources(jcfg, jtabs, jnp.asarray(ndens),
                                   jnp.asarray(xh), jnp.asarray(pos),
                                   jnp.asarray(nflux), jsc,
                                   max_shell=shell_arg)
    got = ps.raytrace_all_sources(pcfg, ptabs, torch.from_numpy(ndens),
                                  torch.from_numpy(xh), torch.from_numpy(pos),
                                  torch.from_numpy(nflux), psc,
                                  max_shell=shell_arg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-12, atol=0)
    assert got[0].abs().sum() > 0
    # cancelling losses: a floor of 1e-12 of the total flux (see
    # tests/test_torch_sweep.py::test_raytrace_all_sources_f64)
    for i in (2, 3, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-12, atol=1e-12 * nflux.sum())
    if not pcfg.isothermal:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-12, atol=0)
        assert got[1].abs().sum() > 0
    return got


@pytest.mark.parametrize("r", [2, 3, 7])
def test_raytrace_windowed_matches_jax_f64(r):
    """raytrace_all_sources(max_shell=r) takes the windowed path (2r+1 <=
    N-1) in both packages; a repeated position and corner sources make
    windows overlap and wrap."""
    got = _raytrace_pair(shell_arg=r)
    assert float(got[4].abs().max()) > 0.0     # photons leave the window


def test_raytrace_windowed_heat_matches_jax_f64():
    """The non-isothermal windowed raytrace: the heating rates take a
    second scatter-add into their own padded accumulator, folded as the
    rates are; phiheat at rtol 1e-12."""
    got = _raytrace_pair(shell_arg=3, isothermal=False)
    assert got[1].shape == got[0].shape


@pytest.mark.parametrize("shell_arg,kw", [
    (None, dict(max_shell=3)),
    (None, dict(max_subbox=5)),
    (6, dict(window_sweep=False)),
])
def test_raytrace_capped_full_cube_matches_jax_f64(shell_arg, kw):
    """A radius cap from the config (or an explicit one with windows off)
    runs the full-cube sweep to d_sweep < N/2 shells, the cells beyond
    left at zero."""
    _raytrace_pair(shell_arg=shell_arg, **kw)
