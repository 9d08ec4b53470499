"""K2w, the rate deposition's window mode (csrc/consume.cu consume_windows,
ops/sweep_cuda.window_rates), on the CPU: the wrapper's plain route
against the batched _rate_pass it replaces in windowed_batch (bitwise),
the plain version against the JAX package's vmapped _rate_pass in every
branch (f64, rtol 1e-9), and the build and the C arguments the wrapper
takes for each option set.  The windows overlap each other and the
periodic boundary; one is a zero-flux padding window at corner 0, and one
cell has zero density.  The kernel itself runs only on the card
(chip_smoke.py phases 7, 13 and 19 hold it against the plain version)."""

import dataclasses
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.config import SEDConfig as JaxSED
from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.ops import sweep as js
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables

from c2ray_tpu_torch import _build
from c2ray_tpu_torch.convert import config_from_dict, tables_from_numpy
from c2ray_tpu_torch.ops import sweep as ps
from c2ray_tpu_torch.ops import sweep_cuda as pk
from c2ray_tpu_torch.ops import window_cuda as pw
from c2ray_tpu_torch.ops.tables import RadTables

torch.set_num_threads(2)

N = 12          # the grid the windows are cut from
B = 5
DR = 1e22       # cm: rays cross a window, so every branch is live
LCOL = 1e17     # the scalar LLS column (type 1)

# name: (config overrides, grid LLS, X-ray, R_max in cells)
CASES = {
    "lls-off": (dict(use_lls=False), False, False, 0.0),
    "scalar": (dict(type_of_lls=1), False, False, 0.0),
    "grid": (dict(type_of_lls=2), True, False, 0.0),
    "rmax": (dict(type_of_lls=3), False, False, 3.2),
    "heat": (dict(type_of_lls=1, isothermal=False), False, False, 0.0),
    "xray": (dict(type_of_lls=1, xray=True), False, True, 0.0),
    "grid-xray-heat": (dict(type_of_lls=2, xray=True, isothermal=False),
                       True, True, 0.0),
    "table": (dict(type_of_lls=1, rate_eval="table"), False, False, 0.0),
    "table-grid-xray-heat": (dict(type_of_lls=2, xray=True,
                                  isothermal=False, rate_eval="table"),
                             True, True, 0.0),
}


def _pair(p, dtype, xray=False, **kw):
    """The window's configuration (mesh p^3), JAX and port."""
    base = dict(mesh=p, dtype=dtype, cosmological=False, use_lls=True,
                type_of_lls=1, rate_eval="expsum")
    if xray:
        base["sed"] = JaxSED(use_xray_sed=True)
    base.update(kw)
    jcfg = jax_config(**base)
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


_TABLES = {}


def _tables(jcfg):
    key = (jcfg.dtype, jcfg.sed.use_xray_sed, jcfg.isothermal)
    if key not in _TABLES:
        jtabs = jax_tables(jcfg)
        _TABLES[key] = (jtabs, tables_from_numpy(
            {k: np.asarray(v) for k, v in jtabs._asdict().items()}, "cpu"))
    return _TABLES[key]


def _windows(case, r, dtype):
    """The case's window inputs: (pcfg, jcfg, tables, scalars, cdo, wins,
    lwins, nf, nfx), numpy-seeded, the columns the plain window march's.
    Corners: two overlapping across the periodic boundary, one at a wrap,
    one random, and the last a zero-flux padding window at corner 0 (on
    top of the first).  One cell has zero density."""
    kw, grid, xray, rmax = CASES[case]
    p = 2 * r + 1
    jcfg, pcfg = _pair(p, dtype, **kw)
    jtabs, ptabs = _tables(jcfg)
    rng = np.random.default_rng(17 + r)
    ndhi = rng.uniform(0.2, 1.0, (N,) * 3) * 2e-6
    ndhi[1, 0, N - 1] = 0.0
    lls = rng.uniform(0.0, 2e17, (N,) * 3) if grid else None
    pos = np.array([[0, 0, 0], [N - 1, N - 1, N - 2], [0, N - 1, N // 2],
                    [5, 2, 9], [0, 0, 0]], np.int32)
    nf = 10.0 ** rng.uniform(-1, 1, B)
    nf[-1] = 0.0
    nfx = 10.0 ** rng.uniform(-1, 1, B) if xray else None
    if xray:
        nfx[-1] = 0.0
        nf[2] = 0.0                       # a pure X-ray source
    to_t = lambda a: torch.as_tensor(np.asarray(a, dtype))   # noqa: E731
    tpos = torch.from_numpy(pos)
    wins = pw.window_gather_reference(ps.wrap_pad(to_t(ndhi), r), tpos, r)
    lwins = (pw.window_gather_reference(ps.wrap_pad(to_t(lls), r), tpos, r)
             if grid else None)
    jsc = js.SweepScalars(dr=jnp.asarray(DR, jcfg.jnp_dtype),
                          rate_scale=jnp.asarray(jcfg.sed.s_star / DR**3,
                                                 jcfg.jnp_dtype),
                          lls_coldens=jnp.asarray(LCOL, jcfg.jnp_dtype),
                          rmax2_cells=jnp.asarray(rmax * rmax,
                                                  jcfg.jnp_dtype))
    psc = ps.sweep_scalars(pcfg, DR, LCOL, rmax)
    cdo = ps.march_windows(pcfg, wins, psc, r, lwins)
    return SimpleNamespace(pcfg=pcfg, jcfg=jcfg, ptabs=ptabs, jtabs=jtabs,
                           psc=psc, jsc=jsc, cdo=cdo, wins=wins,
                           lwins=lwins, nf=to_t(nf),
                           nfx=to_t(nfx) if xray else None, r=r, pos=tpos)


def _assert_bits(got, want):
    """The same values, NaNs in the same places (and +0 / -0 alike)."""
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("case", ["scalar", "grid-xray-heat", "rmax",
                                  "table-grid-xray-heat"])
def test_plain_route_is_the_batched_rate_pass(case, r, dtype):
    """window_rates on CPU tensors == the batched _rate_pass that
    windowed_batch called before the kernel, bitwise: the rates, the
    heating rates, the per-window losses and their torch.sum."""
    w = _windows(case, r, dtype)
    got = pk.window_rates(w.pcfg, w.ptabs, w.cdo, w.wins, w.nf, w.psc, r,
                          lls_wins=w.lwins, nfx=w.nfx)
    want = ps._rate_pass(w.pcfg, w.ptabs, w.cdo, w.wins,
                         w.nf[:, None, None, None], w.psc, w.lwins, r,
                         nflux_xray=(w.nfx[:, None, None, None]
                                     if w.nfx is not None else None))
    _assert_bits(got.phih, want.phih)
    if w.pcfg.isothermal:
        assert got.phiheat is None
    else:
        _assert_bits(got.phiheat, want.phiheat)
    _assert_bits(got.loss, want.photon_loss)
    _assert_bits(got.lls_loss, want.lls_loss)
    _assert_bits(got.loss_sum, torch.sum(want.photon_loss))
    _assert_bits(got.lls_loss_sum, torch.sum(want.lls_loss))
    # the zero-flux padding window deposits nothing and loses nothing, but
    # keeps the plain version's 0/0 at the zero-density cell it covers
    pad = got.phih[-1]
    assert int(torch.isnan(pad).sum()) == 1
    assert float(torch.nan_to_num(pad, nan=0.0).abs().max()) == 0.0
    assert float(got.loss[-1]) == 0.0


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("heat", [False, True])
def test_windowed_batch_keeps_its_bits(r, heat):
    """windowed_batch on the CPU: the accumulators and the losses are
    those of gather, march, batched _rate_pass and scatter-add, the
    composition it made before the kernel, bitwise."""
    case = "grid-xray-heat" if heat else "xray"
    w = _windows(case, r, "float32")
    cfg = w.pcfg.replace(mesh=(N, N, N))
    rng = np.random.default_rng(5)
    ndhi = torch.from_numpy(rng.uniform(0.2, 1.0, (N,) * 3)
                            .astype(np.float32) * 2e-6)
    lls = (torch.from_numpy(rng.uniform(0.0, 2e17, (N,) * 3)
                            .astype(np.float32)) if heat else None)
    pad = ps.wrap_pad(ndhi, r)
    lpad = ps.wrap_pad(lls, r) if lls is not None else None
    shape = pw.padded_acc_shape(N, r)
    acc0 = torch.from_numpy(rng.uniform(0, 1e-12, shape).astype(np.float32))

    def run(fn):
        acc, hacc = acc0.clone(), acc0.clone() if heat else None
        out = fn(acc, hacc)
        return acc, hacc, out

    got = run(lambda acc, hacc: ps.windowed_batch(
        cfg, w.ptabs, pad, w.pos, w.nf, w.psc, r, acc, hacc, lls_pad=lpad,
        nfx=w.nfx))

    def before(acc, hacc):
        p = 2 * r + 1
        cfgw = cfg.replace(mesh=(p, p, p))
        wins = pw.window_gather(pad, w.pos, r)
        lwins = pw.window_gather(lpad, w.pos, r) if lpad is not None else None
        cdo = pk.compute_columns_windows(cfgw, wins, w.psc, r,
                                         lls_wins=lwins)
        res = ps._rate_pass(cfgw, w.ptabs, cdo, wins,
                            w.nf[:, None, None, None], w.psc, lwins, r,
                            nflux_xray=w.nfx[:, None, None, None])
        pw.window_scatter_add(acc, res.phih, w.pos)
        if heat:
            pw.window_scatter_add(hacc, res.phiheat, w.pos)
        return (torch.sum(res.photon_loss), torch.sum(res.lls_loss),
                res.photon_loss)

    want = run(before)
    _assert_bits(got[0], want[0])
    if heat:
        _assert_bits(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        _assert_bits(a, b)
    assert float(got[2][0]) > 0.0


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_vmapped_rate_pass(case, r):
    """window_rates' plain version == the JAX windowed_batch's
    jax.vmap(_rate_pass) on the same windows and columns, f64, every
    branch: LLS off, the scalar column, the grid LLS windows and the R_max
    barrier; heat; X-ray (a pure X-ray source among them); mixture and
    table rates: the rates, heating rates and per-window losses at rtol
    1e-9, the zero-density cell's non-finite values in the same
    places."""
    w = _windows(case, r, "float64")
    got = pk.window_rates(w.pcfg, w.ptabs, w.cdo, w.wins, w.nf, w.psc, r,
                          lls_wins=w.lwins, nfx=w.nfx)
    have_x = w.nfx is not None
    lw = (jnp.asarray(w.lwins.numpy()) if w.lwins is not None
          else jnp.zeros((B,)))

    def one(cdo, win, lwin, f, fx):
        return js._rate_pass(w.jcfg, w.jtabs, cdo, win, f, w.jsc,
                             lwin if w.lwins is not None else None, r,
                             nflux_xray=fx if have_x else None)

    fx = jnp.asarray(w.nfx.numpy()) if have_x else jnp.zeros((B,))
    want = jax.vmap(one)(jnp.asarray(w.cdo.numpy()),
                         jnp.asarray(w.wins.numpy()), lw,
                         jnp.asarray(w.nf.numpy()), fx)
    np.testing.assert_allclose(got.phih.numpy(), np.asarray(want.phih),
                               rtol=1e-9, atol=0)
    lit = got.phih.numpy()
    assert np.nanmax(np.where(np.isfinite(lit), lit, 0.0)) > 0.0
    if not w.pcfg.isothermal:
        np.testing.assert_allclose(got.phiheat.numpy(),
                                   np.asarray(want.phiheat), rtol=1e-9,
                                   atol=0)
        assert float(torch.nan_to_num(got.phiheat, posinf=0.0).max()) > 0
    np.testing.assert_allclose(got.loss.numpy(),
                               np.asarray(want.photon_loss), rtol=1e-9,
                               atol=0)
    np.testing.assert_allclose(got.lls_loss.numpy(),
                               np.asarray(want.lls_loss), rtol=1e-9, atol=0)
    assert float(got.loss.max()) > 0.0
    if w.pcfg.use_lls and w.pcfg.type_of_lls in (1, 2):
        assert float(got.lls_loss.max()) > 0.0
    np.testing.assert_allclose(float(got.loss_sum),
                               float(np.sum(np.asarray(want.photon_loss))),
                               rtol=1e-9)


def test_rmax_barrier_cuts_inside_the_window():
    """At R_max = 3.2 cells the barrier stops rays inside a window of r =
    3: fewer cells are lit than without it."""
    w = _windows("rmax", 3, "float64")
    cut = pk.window_rates(w.pcfg, w.ptabs, w.cdo, w.wins, w.nf, w.psc, 3)
    free = pk.window_rates(w.pcfg.replace(use_lls=False), w.ptabs, w.cdo,
                           w.wins, w.nf, w.psc, 3)
    assert 0 < int((cut.phih != 0).sum()) < int((free.phih != 0).sum())


# --- the wrapper's build and C arguments (no card: a stand-in entry) -------

def _c_params(symbol):
    """The parameter names of a C entry in csrc/consume.cu."""
    src = Path(_build.SRC_DIR, "consume.cu").read_text()
    m = re.search(r"int " + symbol + r"\(([^)]*)\)", src)
    return [a.split()[-1].lstrip("*") for a in m.group(1).split(",")]


def test_c_entries_match_their_ctypes_signatures():
    """The ctypes argument lists of K2's two C entries have one type per
    C parameter."""
    for name, sym in (("consume", "c2r_consume"),
                      ("window_rates", "c2r_consume_windows")):
        lib, symbol, argtypes = pk._SIGNATURES[name]
        assert lib == "consume" and symbol == sym
        assert len(argtypes) == len(_c_params(sym)), name


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_takes_the_build_for_its_options(monkeypatch, case, dtype):
    """On tensors off the CPU (meta tensors stand in for a card's) the
    wrapper launches the build build_for("window_rates", ...) names, with
    the LLS mode, heat and X-ray flags of the options, every argument its
    C entry has, one launch counted under the build's key, and never the
    plain version."""
    kw, grid, xray, rmax = CASES[case]
    p, r = 7, 3
    jcfg, pcfg = _pair(p, "float64" if dtype == torch.float64 else
                       "float32", **kw)
    _, ptabs = _tables(jcfg.replace(dtype="float64"))
    build = pk.build_for("window_rates", dtype, pcfg, grid, xray)
    names = _c_params("c2r_consume_windows")
    calls = []

    def fake_fn(*args):
        calls.append(dict(zip(names, args)))
        return 0

    def fake_entry(name, signatures=pk._SIGNATURES, defines=()):
        assert defines == build.defines
        fn = (lambda q: 3) if name.endswith("nblocks") else fake_fn
        return SimpleNamespace(), fn

    def plain(*a, **k):
        raise AssertionError("the plain version took a non-CPU tensor")

    monkeypatch.setattr(pk, "_entry", fake_entry)
    monkeypatch.setattr(pk, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(pk, "window_rates_reference", plain)
    monkeypatch.setattr(pk.torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    meta = dict(dtype=dtype, device="meta")
    tabs = RadTables(*[t.to(**meta) if t is not None else None
                       for t in ptabs])
    win = torch.empty((B, p, p, p), **meta)
    psc = ps.sweep_scalars(pcfg, DR, LCOL, rmax)
    before = pk.LAUNCHES[build.key]
    out = pk.window_rates(pcfg, tabs, win, win, torch.empty(B, **meta), psc,
                          r, lls_wins=win if grid else None,
                          nfx=torch.empty(B, **meta) if xray else None)
    assert pk.LAUNCHES[build.key] == before + 1
    (args,) = calls
    assert len(args) == len(names)
    lls_mode = 2 if grid else (1 if pcfg.use_lls and pcfg.type_of_lls in
                               (1, 2) else 0)
    assert (args["use_lls"], args["use_heat"], args["use_xray"]) == (
        lls_mode, int(not pcfg.isothermal), int(xray))
    assert (args["nwin"], args["p"], args["max_shell"]) == (B, p, r)
    assert args["rmax2"] == (psc.rmax2_cells if rmax else float("inf"))
    assert tuple(out.phih.shape) == (B, p, p, p)
    assert (out.phiheat is None) == pcfg.isothermal
    assert tuple(out.loss.shape) == (B,) and out.loss_sum.dim() == 0
    assert ("C2R_TABLE" in build.defines) == (pcfg.rate_eval == "table")
    assert ("C2R_F64" in build.defines) == (dtype == torch.float64)
    assert build.key.startswith("window_rates") and build.source == "consume"


def test_window_rates_keys_beside_consume():
    """Each of K2's builds has a window-mode key beside its grid-mode one,
    and both modes share one library per build."""
    grid_keys = [k for k in pk.LAUNCHES if k.startswith("consume")]
    assert len(grid_keys) == 48
    for k in grid_keys:
        assert "window_rates" + k[len("consume"):] in pk.LAUNCHES
    cfg = _pair(7, "float64", type_of_lls=3, isothermal=False)[1]
    a = pk.build_for("consume", torch.float64, cfg, xray=False)
    b = pk.build_for("window_rates", torch.float64, cfg, xray=False)
    assert (a.source, a.defines) == (b.source, b.defines)
    assert (a.key, b.key) == ("consume_f64_rmax_heat",
                              "window_rates_f64_rmax_heat")
