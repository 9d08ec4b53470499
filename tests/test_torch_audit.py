"""The photon audit that the chemistry kernel takes in its output pass
(csrc/chemistry.cu, ops/chemistry_cuda.py) on the CPU: the solver tail's
packed vector keeps its bits on the plain route and takes the kernel's
sums where the chemistry returns them; the kernel's per-cell arithmetic
(audit_terms: isothermal scalar temperature, the heat build's temper_av,
scalar and per-cell clumping, compressed storage) summed in float64
against grid_counts (audit_reference) and against the JAX package's
grid_counts (f64, rtol 1e-9); the wrapper's audit arguments.  The kernel
itself runs only on the card (chip_smoke.py phase 20 (a) holds its sums
against grid_counts there)."""

import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.ops.photonstats import grid_counts as jax_grid_counts

from c2ray_tpu_torch import _build
from c2ray_tpu_torch import solver as psolver
from c2ray_tpu_torch.config import test_problem_config as port_config
from c2ray_tpu_torch.ops import chemistry as pc
from c2ray_tpu_torch.ops import chemistry_cuda as cc
from c2ray_tpu_torch.ops.photonstats import grid_counts
from c2ray_tpu_torch.ops.tables import build_rad_tables
from c2ray_tpu_torch.ops.thermal import setup_cool
from c2ray_tpu_torch.state import compress_xh

torch.set_num_threads(2)

N = 6

# name: (isothermal, clumping grid, compressed storage)
CASES = {
    "iso": (True, False, False),
    "iso-clump-grid": (True, True, False),
    "heat": (False, False, False),
    "heat-clump-grid": (False, True, False),
    "iso-compressed": (True, False, True),
    "heat-clump-grid-compressed": (False, True, True),
}


def _state(case, dtype, seed=2):
    """A state at the end of a chemistry pass, numpy-seeded: densities,
    the iterate and the average (deep neutral tails beside ionized cells),
    the average temperature and the clumping."""
    iso, grid, comp = CASES[case]
    rng = np.random.default_rng(seed)
    sh = (N,) * 3
    nd = rng.uniform(1e-4, 1e-3, sh)
    x1 = np.where(rng.uniform(size=sh) > 0.5, 1.0 - 10 ** rng.uniform(
        -7, -1, sh), 10 ** rng.uniform(-5, -0.4, sh))
    xa = np.clip(x1 * rng.uniform(0.9, 1.0, sh), 0.0, 1.0)
    ta = 10 ** rng.uniform(3.5, 4.6, sh)
    clump = rng.uniform(1.0, 5.0, sh) if grid else 2.5
    t = lambda a: torch.as_tensor(a, dtype=dtype)          # noqa: E731
    xs = [t(x1), t(xa)]
    if comp:
        xs = [compress_xh(x) for x in xs]
    cfg = port_config(mesh=N, dtype="float64" if dtype == torch.float64
                      else "float32", isothermal=iso,
                      compressed_xfrac=comp, cosmological=False)
    return SimpleNamespace(cfg=cfg, nd=t(nd), xi=xs[0], xa=xs[1],
                           ta=None if iso else t(ta),
                           clump=t(clump) if grid else clump, np=dict(
                               nd=nd, x1=x1, xa=xa, ta=ta, clump=clump))


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_terms_sum_to_grid_counts(case, dtype, rtol):
    """The kernel's per-cell audit terms (audit_terms: its scalars and its
    order of operations), summed in float64 as the kernel sums them, ==
    the solver tail's two grid_counts calls (audit_reference) at rtol
    1e-12 in float64 and 1e-5 in float32: only the order of the sum
    differs.  Each sum is positive."""
    s = _state(case, dtype)
    terms = cc.audit_terms(s.cfg, s.nd, s.xi, s.xa, s.ta, s.clump)
    assert terms.shape == (4, N, N, N) and terms.dtype == dtype
    got = terms.to(torch.float64).sum(dim=(1, 2, 3))
    want = cc.audit_reference(s.cfg, s.nd, s.xi, s.xa, s.ta, s.clump)
    assert want.dtype == dtype and want.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want.to(torch.float64).numpy(),
                               rtol=rtol, atol=0)
    assert bool((got > 0).all())


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_terms_match_jax_grid_counts(case):
    """The kernel's terms summed in float64 == the JAX package's
    grid_counts on the same state (iterate for h0, h1; average for the
    rates), f64, rtol 1e-9."""
    s = _state(case, torch.float64)
    iso, grid, comp = CASES[case]
    jcfg = jax_config(mesh=N, dtype="float64", isothermal=iso,
                      compressed_xfrac=comp, cosmological=False)
    got = cc.audit_terms(s.cfg, s.nd, s.xi, s.xa, s.ta,
                         s.clump).sum(dim=(1, 2, 3)).numpy()
    j = lambda a: jnp.asarray(a.numpy())                   # noqa: E731
    jclump = jnp.asarray(s.np["clump"]) if grid else s.np["clump"]
    jt = j(s.ta) if s.ta is not None else None
    ca = jax_grid_counts(jcfg, j(s.nd), j(s.xi), jt, jclump, compressed=comp)
    cr = jax_grid_counts(jcfg, j(s.nd), j(s.xa), jt, jclump, compressed=comp)
    want = np.array([float(ca.h0), float(ca.h1), float(cr.rec_rate),
                     float(cr.coll_rate)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


def test_audit_scalars_are_grid_counts_python_floats():
    """The isothermal audit's scalars are grid_counts' own Python floats:
    its recombination rate of a scalar clumping (0.0 for a clumping
    tensor, whose product the kernel takes per cell) and acol's T and
    -TEMPH0 / T."""
    cfg = port_config(mesh=N, dtype="float64")
    from c2ray_tpu_torch import constants as const
    t = cfg.initial_temperature
    assert cc.audit_scalars(cfg, 2.5) == (
        2.5 * const.BH00 * (t / 1e4) ** const.ALBPOW,
        (t / 1e4) ** const.ALBPOW, t, -const.TEMPH0 / t)
    assert cc.audit_scalars(cfg, torch.ones(()))[0] == 0.0


def _tail_inputs(case):
    s = _state(case, torch.float64, seed=4)
    cfg = s.cfg
    cool = None if cfg.isothermal else setup_cool(cfg, device="cpu")
    solver = psolver.Evolve3D(cfg, build_rad_tables(cfg, device="cpu"),
                              device="cpu", cool=cool)
    rng = np.random.default_rng(9)
    phih = torch.from_numpy(10 ** rng.uniform(-16, -12, (N,) * 3))
    phiheat = None if cfg.isothermal else phih * 1e-12
    tc = None if cfg.isothermal else s.ta * 0.9
    args = (3e13, s.nd, s.xi, s.xi, s.xa, phih, s.clump,
            torch.tensor(0.25, dtype=torch.float64),
            torch.tensor(0.0625, dtype=torch.float64),
            torch.tensor([0.125, 0.125], dtype=torch.float64), True)
    kw = dict(phiheat=phiheat, t_cur=tc, t_av=s.ta)
    return s, solver, args, kw


@pytest.mark.parametrize("case", ["iso", "heat-clump-grid",
                                  "heat-clump-grid-compressed"])
def test_tail_keeps_its_bits_on_the_plain_route(case):
    """_tail on the CPU (the plain chemistry, no audit in its result): the
    packed vector is [conv_flag, sum xh1, losses, the two grid_counts
    calls' h0, h1, rec_rate, coll_rate, per-source losses], bit for bit
    what it was before the kernel took the audit."""
    s, solver, args, kw = _tail_inputs(case)
    cfg = s.cfg
    out = solver._tail(*args, **kw)
    chem = pc.global_chemistry_reference(
        cfg, args[0], s.nd, s.xi, s.xi, s.xa, args[5], kw["phiheat"],
        kw["t_cur"], kw["t_av"], s.clump, solver.cool)
    assert chem.audit is None
    comp = cfg.compressed_xfrac
    ca = grid_counts(cfg, s.nd, chem.xh1_intermed, chem.temper_av, s.clump,
                     compressed=comp)
    cr = grid_counts(cfg, s.nd, chem.xh1_av, chem.temper_av, s.clump,
                     compressed=comp)
    x1 = solver._dense_x1(chem.xh1_intermed)
    want = torch.cat([torch.stack([
        chem.conv_flag.to(torch.float64), torch.sum(x1), args[7], args[8],
        ca.h0, ca.h1, cr.rec_rate, cr.coll_rate]), args[9]])
    np.testing.assert_array_equal(out[4].numpy(), want.numpy())
    assert torch.equal(out[0], chem.xh1_intermed)


def test_tail_takes_the_kernels_audit(monkeypatch):
    """Where the chemistry returns an audit (the kernel's), _tail packs
    those four sums and calls grid_counts for none of them."""
    s, solver, args, kw = _tail_inputs("heat-clump-grid")
    audit = torch.tensor([1.5, 2.5, 3.5, 4.5], dtype=torch.float64)

    def chem(*a, **k):
        res = pc.global_chemistry_reference(*a, **k)
        return res._replace(audit=audit)

    def no_counts(*a, **k):
        raise AssertionError("grid_counts called beside the kernel's audit")

    solver._chem = chem
    monkeypatch.setattr(psolver, "grid_counts", no_counts)
    packed = solver._tail(*args, **kw)[4]
    np.testing.assert_array_equal(packed[4:8].numpy(), audit.numpy())
    assert packed.shape == (8 + 2,)


def _c_params(symbol):
    src = Path(_build.SRC_DIR, "chemistry.cu").read_text()
    m = re.search(r"int " + symbol + r"\(([^)]*)\)", src)
    return [a.split()[-1].lstrip("*") for a in m.group(1).split(",")]


@pytest.mark.parametrize("case", list(CASES))
def test_wrapper_passes_the_audit(monkeypatch, case):
    """On tensors off the CPU (meta tensors stand in for a card's) the
    wrapper gives the C entry every argument it has, the audit's output
    and scratch (4 sums; 4 doubles per block), its four scalars last in
    the scalar vector, the clumping grid where there is one, and returns
    the audit; audit=False passes none."""
    s = _state(case, torch.float32)
    cfg = s.cfg
    meta = lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t  # noqa
    names = _c_params("c2r_chemistry")
    assert len(names) == len(cc._SIGNATURES["chemistry"][2])
    calls = []

    def fake_fn(*args):
        calls.append(dict(zip(names, args)))
        return 0

    def fake_entry(name, signatures=None, defines=()):
        fn = (lambda q: 7) if name == "chemistry_blocks" else fake_fn
        return SimpleNamespace(), fn

    monkeypatch.setattr(cc, "_entry", fake_entry)
    monkeypatch.setattr(cc, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(cc.torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    cool = None
    if not cfg.isothermal:
        cool = setup_cool(cfg, device="cpu")
        cool = cool._replace(cie_cool=cool.cie_cool.to("meta"))
    heat = dict(phiheat=meta(s.nd), temper_current=meta(s.ta),
                temper_av=meta(s.ta)) if not cfg.isothermal else {}
    res = cc._chemistry(cfg, 3e13, meta(s.nd), meta(s.xi), meta(s.xi),
                        meta(s.xa), meta(s.nd), heat.get("phiheat"),
                        heat.get("temper_current"), heat.get("temper_av"),
                        meta(s.clump), cool, 0.0, 0.0, 100)
    args = calls[-1]
    assert len(args) == len(names)
    assert tuple(res.audit.shape) == (4,)
    scalars = list(args["s"])
    assert len(scalars) == cc._NUM_SCALARS
    assert scalars[-4:] == pytest.approx(list(cc.audit_scalars(
        cfg, s.clump)), rel=0, abs=0)
    assert (args["clump_stride"] == 1) == isinstance(s.clump, torch.Tensor)
    assert args["compressed"] == int(cfg.compressed_xfrac)
    cc._chemistry(cfg, 3e13, meta(s.nd), meta(s.xi), meta(s.xi), meta(s.xa),
                  meta(s.nd), heat.get("phiheat"),
                  heat.get("temper_current"), heat.get("temper_av"),
                  meta(s.clump), cool, 0.0, 0.0, 100, audit=False)
    assert calls[-1]["audit"] is None and calls[-1]["apartial"] is None
