"""The fused window sweep (csrc/window_sweep.cu, ops/sweep_cuda.
window_sweep: the window march with the rate pass as its per-cell
epilogue) on the CPU: its plain route against the window march then the
batched _rate_pass on every windowed rung (bitwise), windowed_batch with
the new dispatch against the JAX package's windowed_batch (f64, rtol
1e-9) and against its own route through the march and K2w (bitwise),
a zero-flux padding window adding exactly zero, and the build, the C
arguments and the fit rule the wrapper takes.  The kernel itself runs only
on the card (chip_smoke.py phases 7, 13 and 19 hold it against the plain
version; 10, 16 and 17 require it on every batch that fits)."""

import dataclasses
import re
from pathlib import Path
from types import SimpleNamespace

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
DR = 1e22       # cm: rays cross a window, so every branch is live
LCOL = 1e17     # the scalar LLS column (type 1)

# phase 13's option sets: name -> (config overrides, grid LLS, X-ray,
# R_max in cells)
OPTIONS = {
    "off": (dict(use_lls=False), False, False, 0.0),
    "scalar": (dict(type_of_lls=1), False, False, 0.0),
    "grid": (dict(type_of_lls=2), True, False, 0.0),
    "rmax": (dict(type_of_lls=3), False, False, 3.2),
    "xray": (dict(type_of_lls=1, xray=True), False, True, 0.0),
    "heat": (dict(type_of_lls=1, isothermal=False), False, False, 0.0),
    "grid-xray-heat": (dict(type_of_lls=2, xray=True, isothermal=False),
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


def _inputs(option, r, dtype, rate_eval="expsum", seed=0):
    """A batch of three windows of half-width r cut from a numpy-seeded
    N^3 grid (so larger windows repeat it periodically): corners at 0 and
    at a wrap, and a zero-flux padding window at corner 0; a pure X-ray
    source where X-ray is on.  -> the inputs of both packages."""
    kw, grid, xray, rmax = OPTIONS[option]
    p = 2 * r + 1
    jcfg, pcfg = _pair(p, dtype, rate_eval=rate_eval, **kw)
    jtabs, ptabs = _tables(jcfg)
    rng = np.random.default_rng(seed + r)
    ndhi = rng.uniform(0.2, 1.0, (N,) * 3) * 2e-6
    lls = rng.uniform(0.0, 2e17, (N,) * 3) if grid else None
    pos = np.array([[0, 0, 0], [N - 1, 3, N - 2], [0, 0, 0]], np.int32)
    nf = 10.0 ** rng.uniform(-1, 1, 3)
    nf[-1] = 0.0
    nfx = 10.0 ** rng.uniform(-1, 1, 3) if xray else None
    if xray:
        nfx[-1] = 0.0
        nf[1] = 0.0                       # a pure X-ray source
    to_t = lambda a: torch.as_tensor(np.asarray(a, dtype))   # noqa: E731
    tpos = torch.from_numpy(pos)
    pad = ps.wrap_pad(to_t(ndhi), r)
    lpad = ps.wrap_pad(to_t(lls), r) if grid else None
    wins = pw.window_gather_reference(pad, tpos, r)
    lwins = pw.window_gather_reference(lpad, tpos, r) if grid else None
    return SimpleNamespace(
        pcfg=pcfg, jcfg=jcfg, ptabs=ptabs, jtabs=jtabs, r=r, pos=tpos,
        pad=pad, lpad=lpad, wins=wins, lwins=lwins, nf=to_t(nf),
        nfx=to_t(nfx) if xray else None, ndhi=ndhi, lls=lls,
        psc=ps.sweep_scalars(pcfg, DR, LCOL, rmax),
        jsc=js.SweepScalars(
            dr=jnp.asarray(DR, jcfg.jnp_dtype),
            rate_scale=jnp.asarray(jcfg.sed.s_star / DR**3, jcfg.jnp_dtype),
            lls_coldens=jnp.asarray(LCOL, jcfg.jnp_dtype),
            rmax2_cells=jnp.asarray(rmax * rmax, jcfg.jnp_dtype)))


def _assert_bits(got, want):
    """The same values, NaNs in the same places (and +0 / -0 alike)."""
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("rate_eval", ["expsum", "table"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("r", [8, 16, 32])
def test_plain_route_is_the_march_then_the_rate_pass(r, option, dtype,
                                                     rate_eval):
    """window_sweep on CPU tensors == the window march, then the batched
    _rate_pass (what windowed_batch ran before the fused kernel), bitwise,
    on every windowed rung of the production ladder: the rates, the
    heating rates, the per-window losses and their torch.sum; the
    zero-flux padding window deposits and loses exactly nothing."""
    w = _inputs(option, r, dtype, rate_eval)
    got = pk.window_sweep(w.pcfg, w.ptabs, w.wins, w.nf, w.psc, r,
                          lls_wins=w.lwins, nfx=w.nfx)
    cdo = ps.march_windows(w.pcfg, w.wins, w.psc, r, w.lwins)
    want = ps._rate_pass(w.pcfg, w.ptabs, cdo, w.wins,
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
    assert float(got.phih.max()) > 0.0
    # R_max (3.2 cells) stops every ray inside the window: no boundary loss
    assert (float(got.loss[0]) > 0.0) == (option != "rmax")
    assert float(got.phih[-1].abs().max()) == 0.0
    assert float(got.loss[-1]) == 0.0 and float(got.lls_loss[-1]) == 0.0


def _port_batch(w, heat_pad=True):
    """The port's windowed_batch on w's windows into padded accumulators
    (the rates' from numpy-seeded values, the heating rates' from zero)
    -> ((acc, heat acc, loss sum, LLS loss sum, per-window losses), the
    rates' starting values)."""
    n = N
    cfg = w.pcfg.replace(mesh=(n, n, n))
    shape = pw.padded_acc_shape(n, w.r)
    rng = np.random.default_rng(5)
    acc0 = rng.uniform(0.0, 1e-12, shape)
    acc = torch.as_tensor(acc0.copy(), dtype=w.wins.dtype)
    hacc = (torch.zeros(shape, dtype=w.wins.dtype)
            if not cfg.isothermal and heat_pad else None)
    out = ps.windowed_batch(cfg, w.ptabs, w.pad, w.pos, w.nf, w.psc, w.r,
                            acc, hacc, lls_pad=w.lpad, nfx=w.nfx)
    return (acc, hacc) + tuple(out), acc0


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("option", ["scalar", "rmax", "grid-xray-heat"])
def test_windowed_batch_matches_jax_windowed_batch(option, r):
    """windowed_batch (its plain route through window_sweep) against the
    JAX package's windowed_batch on its XLA path (padded accumulator) in
    float64: both accumulators, the two loss sums and the per-window
    losses at rtol 1e-9, as tests/test_torch_window_rates.py holds the
    rate pass."""
    w = _inputs(option, r, "float64")
    (acc, hacc, loss_sum, lls_sum, loss), acc0 = _port_batch(w)
    jcfg = w.jcfg.replace(mesh=(N, N, N))
    jpad = jnp.asarray(w.pad.numpy())
    jlpad = jnp.asarray(w.lpad.numpy()) if w.lpad is not None else None
    want = js.windowed_batch(
        jcfg, w.jtabs, jpad, jlpad, jnp.asarray(w.pos.numpy()),
        jnp.asarray(w.nf.numpy()),
        jnp.asarray(w.nfx.numpy()) if w.nfx is not None else None, w.jsc,
        r, jnp.asarray(acc0), jnp.zeros(acc0.shape), padded_acc=True)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want[0]), rtol=1e-9,
                               atol=0)
    if hacc is not None:
        np.testing.assert_allclose(hacc.numpy(), np.asarray(want[1]),
                                   rtol=1e-9, atol=0)
        assert float(hacc.max()) > 0.0
    np.testing.assert_allclose(float(loss_sum), float(want[2]), rtol=1e-9)
    np.testing.assert_allclose(float(lls_sum), float(want[3]), rtol=1e-9)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want[4]), rtol=1e-9,
                               atol=0)
    assert float((acc.numpy() - acc0).max()) > 0.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("option", ["scalar", "grid-xray-heat"])
def test_windowed_batch_routes_give_the_same_bits(monkeypatch, option,
                                                  dtype):
    """windowed_batch takes window_sweep where window_sweep_fits says so,
    else the window march and K2w one after the other: on the CPU both
    routes give the same accumulators and losses, bitwise, and each
    calls only its own kernels."""
    w = _inputs(option, 3, dtype)
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(pk, name, wrapped)

    for name in ("window_sweep", "compute_columns_windows", "window_rates"):
        spy(name, getattr(pk, name))
    fused, _ = _port_batch(w)
    assert calls == ["window_sweep"]
    calls.clear()
    monkeypatch.setattr(pk, "window_sweep_fits", lambda *a, **k: False)
    split, _ = _port_batch(w)
    assert calls == ["compute_columns_windows", "window_rates"]
    for a, b in zip(fused, split):
        if a is not None:
            _assert_bits(a, b)


@pytest.mark.parametrize("option", ["scalar", "grid-xray-heat"])
def test_zero_flux_window_adds_exactly_zero(option):
    """A zero-flux padding window (a partial batch's filler at corner 0)
    changes no bit of the accumulators, the loss sums or the other
    windows' losses."""
    w = _inputs(option, 3, "float32")
    with_pad, _ = _port_batch(w)
    w.pos, w.nf = w.pos[:-1], w.nf[:-1]
    if w.nfx is not None:
        w.nfx = w.nfx[:-1]
    without, _ = _port_batch(w)
    for a, b in zip(with_pad[:4], without[:4]):
        if a is not None:
            _assert_bits(a, b)
    _assert_bits(with_pad[4][:-1], without[4])
    assert float(with_pad[4][-1]) == 0.0


# --- the wrapper's build, C arguments and fit rule (no card: stand-ins) ----

def _c_params(symbol):
    """The parameter names of a C entry in csrc/window_sweep.cu."""
    src = Path(_build.SRC_DIR, "window_sweep.cu").read_text()
    m = re.search(r"int " + symbol + r"\(([^)]*)\)", src)
    return [a.split()[-1].lstrip("*") for a in m.group(1).split(",")]


def test_c_entries_match_their_ctypes_signatures():
    """The ctypes argument lists of the fused kernel's two C entries have
    one type per C parameter, and the library is one of the builds."""
    for name, sym in (("window_sweep", "c2r_window_sweep"),
                      ("window_sweep_fits", "c2r_window_sweep_fits")):
        lib, symbol, argtypes = pk._SIGNATURES[name]
        assert lib == "window_sweep" and symbol == sym
        assert len(argtypes) == len(_c_params(sym)), name
    assert "window_sweep" in _build.KERNELS


def _meta_case(monkeypatch, option, dtype, rate_eval, fits=1):
    """Stand-ins for the card: meta tensors, the C entries recorded."""
    kw, grid, xray, rmax = OPTIONS[option]
    p, r = 7, 3
    jcfg, pcfg = _pair(p, "float64" if dtype == torch.float64 else
                       "float32", rate_eval=rate_eval, **kw)
    _, ptabs = _tables(jcfg.replace(dtype="float64"))
    build = pk.build_for("window_sweep", dtype, pcfg, grid, xray)
    calls = []

    def fake_entry(name, signatures=pk._SIGNATURES, defines=()):
        assert defines == build.defines
        names = _c_params(pk._SIGNATURES[name][1])

        def fn(*args):
            calls.append((name, dict(zip(names, args))))
            return fits if name == "window_sweep_fits" else 0
        return SimpleNamespace(), fn

    def plain(*a, **k):
        raise AssertionError("the plain version took a non-CPU tensor")

    monkeypatch.setattr(pk, "_entry", fake_entry)
    monkeypatch.setattr(pk, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(pk, "window_sweep_reference", plain)
    monkeypatch.setattr(pk.torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    meta = dict(dtype=dtype, device="meta")
    tabs = RadTables(*[t.to(**meta) if t is not None else None
                       for t in ptabs])
    win = torch.empty((3, p, p, p), **meta)
    return SimpleNamespace(
        pcfg=pcfg, tabs=tabs, win=win, build=build, calls=calls, r=r, p=p,
        grid=grid, xray=xray, rmax=rmax, nf=torch.empty(3, **meta),
        nfx=torch.empty(3, **meta) if xray else None,
        psc=ps.sweep_scalars(pcfg, DR, LCOL, rmax))


@pytest.mark.parametrize("rate_eval", ["expsum", "table"])
@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_takes_the_build_for_its_options(monkeypatch, option, dtype,
                                                 rate_eval):
    """On tensors off the CPU (meta tensors stand in for a card's) the
    wrapper launches the build build_for("window_sweep", ...) names, with
    the LLS mode, heat and X-ray flags of the options, every argument its
    C entry has, the rate arguments K2w takes, one launch counted under
    the build's key, and never the plain version; the fit rule asks the
    same build with the staged terms."""
    m = _meta_case(monkeypatch, option, dtype, rate_eval)
    lwins = m.win if m.grid else None
    assert pk.window_sweep_fits(m.pcfg, m.tabs, m.win, lwins, m.nfx)
    (name, fit), = m.calls
    k, kx = pk._term_counts(m.pcfg, m.tabs, dtype, m.xray)
    assert name == "window_sweep_fits"
    assert (fit["p"], fit["K"], fit["Kx"]) == (m.p, k, kx)
    assert (fit["use_heat"], fit["use_xray"]) == (
        int(not m.pcfg.isothermal), int(m.xray))
    m.calls.clear()
    before = pk.LAUNCHES[m.build.key]
    out = pk.window_sweep(m.pcfg, m.tabs, m.win, m.nf, m.psc, m.r,
                          lls_wins=lwins, nfx=m.nfx)
    assert pk.LAUNCHES[m.build.key] == before + 1
    (name, args), = m.calls
    assert name == "window_sweep"
    lls_mode = 2 if m.grid else (1 if m.pcfg.use_lls and m.pcfg.type_of_lls
                                 in (1, 2) else 0)
    assert (args["use_lls"], args["use_heat"], args["use_xray"]) == (
        lls_mode, int(not m.pcfg.isothermal), int(m.xray))
    assert (args["nwin"], args["p"], args["max_shell"]) == (3, m.p, m.r)
    assert (args["K"], args["Kx"]) == (k, kx)
    assert args["rmax2"] == (m.psc.rmax2_cells if m.rmax else float("inf"))
    assert args["dr"] == m.psc.dr and args["lcol"] == m.psc.lls_coldens
    assert (args["lwins"] is not None) == m.grid
    assert (args["nfx"] is not None) == m.xray
    assert (args["phiheat"] is None) == m.pcfg.isothermal
    assert tuple(out.phih.shape) == (3, m.p, m.p, m.p)
    assert (out.phiheat is None) == m.pcfg.isothermal
    assert tuple(out.loss.shape) == (3,) and out.loss_sum.dim() == 0
    assert ("C2R_TABLE" in m.build.defines) == (rate_eval == "table")
    assert ("C2R_F64" in m.build.defines) == (dtype == torch.float64)
    assert m.build.key.startswith("window_sweep")
    assert m.build.source == "window_sweep"


def test_wrapper_raises_where_the_kernel_refuses(monkeypatch):
    """A launch the kernel refuses (its fit rule says no) raises; it never
    falls back to the plain version."""
    m = _meta_case(monkeypatch, "scalar", torch.float32, "expsum", fits=0)
    assert not pk.window_sweep_fits(m.pcfg, m.tabs, m.win)

    def refuse(name, signatures=pk._SIGNATURES, defines=()):
        lib = SimpleNamespace(c2r_error_string=lambda rc: b"invalid argument")
        return lib, lambda *a: 1
    monkeypatch.setattr(pk, "_entry", refuse)
    with pytest.raises(RuntimeError, match="window sweep"):
        pk.window_sweep(m.pcfg, m.tabs, m.win, m.nf, m.psc, m.r)


def test_capped_radius_zero_fills_the_outputs(monkeypatch):
    """With max_shell below p / 2 the kernel never writes the cells past
    it, so the wrapper hands it zero-filled outputs (as the plain version
    leaves them zero); at the full radius it allocates them empty."""
    made, inside = [], []
    for name in ("zeros", "empty"):
        real = getattr(torch, name)

        def make(*a, _name=name, _real=real, **k):
            if not inside:                # not torch's own calls within
                made.append(_name)
            inside.append(_name)
            try:
                return _real(*a, **k)
            finally:
                inside.pop()
        monkeypatch.setattr(pk.torch, name, make)
    m = _meta_case(monkeypatch, "heat", torch.float32, "expsum")
    for max_shell, want in ((m.r, "empty"), (m.r - 1, "zeros")):
        made.clear()
        pk.window_sweep(m.pcfg, m.tabs, m.win, m.nf, m.psc, max_shell)
        assert made[:2] == [want, want]           # phih, phiheat


def test_window_sweep_keys_beside_consume():
    """Each of K2's builds has a fused key beside its two modes', with the
    same defines, in a library of its own."""
    grid_keys = [k for k in pk.LAUNCHES if k.startswith("consume")]
    for k in grid_keys:
        assert "window_sweep" + k[len("consume"):] in pk.LAUNCHES
    cfg = _pair(7, "float64", type_of_lls=2)[1]
    a = pk.build_for("window_rates", torch.float64, cfg, grid_lls=True,
                     xray=False)
    b = pk.build_for("window_sweep", torch.float64, cfg, grid_lls=True,
                     xray=False)
    assert a.defines == b.defines and b.source == "window_sweep"
    assert (a.key, b.key) == ("window_rates_f64_lls", "window_sweep_f64_lls")
