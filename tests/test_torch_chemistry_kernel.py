"""The chemistry kernel (csrc/chemistry.cu) on the CPU: its control flow,
one cell at a time with its own passes and thermal substeps, written here
in Python over the port's own ops and held bitwise against
global_chemistry's masked grid loop (the plain version) at 4^3, with both
caps forced; the wrapper's refusals; its builds.  The kernel itself runs
only on the card (chip_smoke.py phase 20 holds it bitwise against the
plain version there)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from c2ray_tpu_torch import _build
from c2ray_tpu_torch.config import RunConfig
from c2ray_tpu_torch.ops import chemistry as pc
from c2ray_tpu_torch.ops import chemistry_cuda as cc
from c2ray_tpu_torch.ops.doric import doric, electrondens, \
    recombination_rates
from c2ray_tpu_torch.ops.thermal import (_make_substep, pressr2temper,
                                         setup_cool, temper2pressr)
from c2ray_tpu_torch import constants as const
from c2ray_tpu_torch.state import compress_xh, xh0_of, xh1_of

torch.set_num_threads(2)

N = 4
DT = 3.0e13
# one cell's values in every lane of a vector this long: the CPU's
# vectorized ops then round each lane as in the 4^3 grid pass (whose 64
# cells are whole vectors too), not as its scalar tail loop would
LANES = N ** 3


def _inputs(seed, dtype, compressed):
    rng = np.random.default_rng(seed)
    sh = (N,) * 3
    nd = rng.uniform(1e-4, 1e-3, sh)
    x0 = 10 ** rng.uniform(-4, -0.01, sh)
    xi = np.clip(x0 + rng.uniform(0, 0.3, sh), 0, 1)
    xa = np.clip(x0 + rng.uniform(0, 0.2, sh), 0, 1)
    ph = 10 ** rng.uniform(-16, -11, sh) * (rng.uniform(size=sh) > 0.1)
    tc = 10 ** rng.uniform(2, 4.5, sh)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    xs = [t(x0), t(xi), t(xa)]
    if compressed:
        xs = [compress_xh(x) for x in xs]
    return dict(nd=t(nd), x0=xs[0], xi=xs[1], xa=xs[2], ph=t(ph),
                phh=t(ph * 1e-16 * nd), tc=t(tc),
                ta=t(tc * rng.uniform(0.9, 1.5, sh)),
                clump=t(rng.uniform(1, 5, sh)),
                loss=t(10 ** rng.uniform(-16, -13, sh)))


def _cell_thermal(cfg, cool, dt, t0, nd, x1_end, x1_av, h1_old, heat, coeff,
                  max_sub):
    """ops/thermal.thermal for one cell, its substeps in a Python loop."""
    e0 = temper2pressr(t0, nd, electrondens(nd, h1_old)) / const.GAMMA1
    ne_av = electrondens(nd, x1_av)
    step = _make_substep(cfg, cool, dt, nd, ne_av, coeff * e0, heat)
    active0 = t0 > cfg.minitemp
    zero = torch.zeros_like(t0)
    state = (e0, t0, zero, zero, active0)
    k = 0
    while bool(state[-1][0]) and k < max_sub:
        state = step(state)
        k += 1
    avg = torch.where(dt > 0.0, state[2] / dt, t0)
    final = pressr2temper(state[0] * const.GAMMA1, nd,
                          electrondens(nd, x1_end))
    return (torch.where(active0, final, t0), torch.where(active0, avg, t0))


def _kernel_model(cfg, inp, cool, clump, loss, max_sub):
    """The kernel's control flow: each cell restarts doric from its
    step-initial state every pass, integrates its own temperature in the
    heat build, stops after the pass in which it converged or at the cap,
    then counts its ion_cond; n_iterations is the most passes of a cell.
    -> (xh1_intermed, xh1_av, T_int, T_av, conv_flag, n_iterations)"""
    heat = not cfg.isothermal
    comp = cfg.compressed_xfrac
    eps, mfc = cfg.epsilon, cfg.minimum_fractional_change
    dtype = inp["nd"].dtype
    dt = torch.full((), DT, dtype=dtype)
    out = {k: torch.empty(LANES, dtype=dtype) for k in
           ("x1", "xa", "ti", "ta")}
    conv_flag = n_iter = 0
    if not heat:
        rates = recombination_rates(
            torch.full((), cfg.initial_temperature, dtype=dtype), clump)
    for i in range(LANES):
        def lane(a):
            if not isinstance(a, torch.Tensor) or a.numel() == 1:
                return a
            return a.reshape(-1)[i].expand(LANES).contiguous()

        c = {k: lane(v) for k, v in inp.items()}
        cl = lane(clump)
        if comp:
            h1_old = torch.clamp(xh1_of(c["x0"]), min=eps)
            h0_old = torch.clamp(xh0_of(c["x0"]), min=eps)
            hav1 = torch.clamp(xh1_of(c["xa"]), min=eps)
            hav0 = torch.clamp(xh0_of(c["xa"]), min=eps)
            h1 = torch.clamp(xh1_of(c["xi"]), min=eps)
            h0 = torch.clamp(xh0_of(c["xi"]), min=eps)
        else:
            h1_old = torch.clamp(c["x0"], min=eps)
            h0_old = None
            hav1 = torch.clamp(c["xa"], min=eps)
            h1 = torch.clamp(c["xi"], min=eps)
        hav0_start = hav0 if comp else None
        r = None if heat else tuple(lane(x) for x in rates)
        t_int, t_av = c["tc"], c["ta"]
        ph = c["ph"] + lane(loss)
        passes = 0
        for nit in range(1, cfg.max_chemistry_iterations + 1):
            passes = nit
            prev = hav0 if comp else torch.clamp(1.0 - hav1, min=eps)
            res = doric(cfg, dt, t_av, electrondens(c["nd"], hav1), h1_old,
                        ph, cl, rates=r, xh0_old=h0_old)
            if heat:
                t_int, t_av = _cell_thermal(
                    cfg, cool, dt, c["tc"], c["nd"], res.xh1, res.xh1_av,
                    h1_old, c["phh"], 1e-17, max_sub)
            conv = ((torch.abs((res.xh0_av - prev) / res.xh0_av) < mfc)
                    | (res.xh0_av < cfg.minimum_fraction_of_atoms))
            h1, hav1 = res.xh1, res.xh1_av
            if comp:
                h0, hav0 = res.xh0, res.xh0_av
            if bool(conv[0]):
                break
        n_iter = max(n_iter, passes)
        if comp:
            old0, end0 = hav0_start, hav0
        else:
            old0 = 1.0 - torch.clamp(c["xa"], min=eps)
            end0 = torch.clamp(1.0 - hav1, min=eps)
        ion = ((torch.abs(end0 - old0) > mfc)
               & (torch.abs((end0 - old0) / end0) > mfc)
               & (end0 > cfg.minimum_fraction_of_atoms))
        if heat:
            ion = ion | ((torch.abs((c["ta"] - t_av) / t_av) > 1.0e-1)
                         & (torch.abs(c["ta"] - t_av) > 100.0))
        conv_flag += int(ion[0])
        out["x1"][i] = (compress_xh(h1, h0) if comp else h1)[0]
        out["xa"][i] = (compress_xh(hav1, hav0) if comp else hav1)[0]
        out["ti"][i] = t_int[0]
        out["ta"][i] = t_av[0]
    shape = inp["nd"].shape
    return ([out[k].reshape(shape) for k in ("x1", "xa", "ti", "ta")],
            conv_flag, n_iter)


CASES = {
    "iso": dict(),
    "iso-caps-grids": dict(max_chemistry_iterations=2, grids=True),
    "compressed": dict(compressed_xfrac=True),
    "heat": dict(isothermal=False),
    "heat-caps": dict(isothermal=False, max_chemistry_iterations=3,
                      max_sub=4),
    "heat-compressed-grids": dict(isothermal=False, compressed_xfrac=True,
                                  grids=True),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_control_flow_matches_grid_loop(case, dtype):
    """The per-cell loops give global_chemistry's masked-loop result bit
    for bit: both outputs, both temperatures, conv_flag and n_iterations,
    with the pass cap and the substep cap hit where forced.  The grid
    pass runs its thermal loop dense (thermal_compact off): compaction
    moves a cell into the CPU's scalar tail loop, whose rounding differs
    from its vector lanes (the card has no such split)."""
    opts = dict(CASES[case])
    grids = opts.pop("grids", False)
    max_sub = opts.pop("max_sub", 10000)
    cfg = RunConfig(mesh=(N,) * 3, dtype=str(dtype).split(".")[1],
                    thermal_compact=False, **opts)
    inp = _inputs(3, dtype, cfg.compressed_xfrac)
    cool = None if cfg.isothermal else setup_cool(cfg, device="cpu")
    clump = inp["clump"] if grids else 1.7
    loss = inp["loss"] if grids else 0.0
    kw = {}
    if not cfg.isothermal:
        kw = dict(phiheat=inp["phh"], temper_current=inp["tc"],
                  temper_av=inp["ta"], cool=cool, cosmo_cool_coeff=1e-17)
    want = pc.global_chemistry(cfg, DT, inp["nd"], inp["x0"], inp["xi"],
                               inp["xa"], inp["ph"], clumping=clump,
                               photon_loss_rate=loss, max_subcycles=max_sub,
                               **kw)
    got, conv_flag, n_iter = _kernel_model(cfg, inp, cool, clump, loss,
                                           max_sub)
    assert torch.equal(got[0], want.xh1_intermed)
    assert torch.equal(got[1], want.xh1_av)
    if not cfg.isothermal:
        assert torch.equal(got[2], want.temper_intermed)
        assert torch.equal(got[3], want.temper_av)
    assert conv_flag == int(want.conv_flag)
    assert n_iter == int(want.n_iterations)
    if "caps" in case:
        assert n_iter == cfg.max_chemistry_iterations
    assert want.counters is None


def test_wrapper_refuses_non_cpu_tensors_without_cuda(monkeypatch):
    """A tensor off the CPU goes to the kernel's wrapper, never to the
    plain loop, and the wrapper raises on what is not a CUDA tensor."""
    cfg = RunConfig(mesh=(N,) * 3, dtype="float64")
    inp = _inputs(3, torch.float64, False)

    def plain(*a, **k):
        raise AssertionError("the plain loop took a non-CPU tensor")

    monkeypatch.setattr(pc, "global_chemistry_reference", plain)
    meta = {k: v.to("meta") for k, v in inp.items()}
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        pc.global_chemistry(cfg, DT, meta["nd"], meta["x0"], meta["xi"],
                            meta["xa"], meta["ph"])
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        cc.global_chemistry_cuda(cfg, DT, inp["nd"], inp["x0"], inp["xi"],
                                 inp["xa"], inp["ph"])
    # dt and cosmo_cool_coeff: Python numbers, or one float64 each on the
    # kernel's device
    with pytest.raises(ValueError, match="must hold one float64"):
        cc.global_chemistry_cuda(cfg, torch.tensor(DT), inp["nd"],
                                 inp["x0"], inp["xi"], inp["xa"], inp["ph"])
    with pytest.raises(ValueError, match="must hold one float64"):
        cc.global_chemistry_cuda(cfg, DT, inp["nd"], inp["x0"], inp["xi"],
                                 inp["xa"], inp["ph"],
                                 cosmo_cool_coeff=torch.zeros(
                                     2, dtype=torch.float64))


def test_build_keys():
    """float32 and float64 builds of one source, each with its isothermal
    and heat LAUNCHES key; both libraries are in the build list."""
    keys = {(d, h): cc.build_for(d, h) for d in (torch.float32,
                                                  torch.float64)
            for h in (False, True)}
    assert {k: b.key for k, b in keys.items()} == {
        (torch.float32, False): "chemistry",
        (torch.float32, True): "chemistry_heat",
        (torch.float64, False): "chemistry_f64",
        (torch.float64, True): "chemistry_f64_heat"}
    assert {b.source for b in keys.values()} == {"chemistry"}
    assert keys[(torch.float32, True)].defines == ()
    assert keys[(torch.float64, False)].defines == ("C2R_F64",)
    assert set(cc.LAUNCHES) == {b.key for b in keys.values()}
    assert _build.library_path("chemistry") != _build.library_path(
        "chemistry", ("C2R_F64",))
    assert {"chemistry", "loop_graph"} <= set(_build.KERNELS)
    with pytest.raises(ValueError):
        cc.build_for(torch.float16, False)


def test_scalar_order_matches_the_kernel():
    """The wrapper's scalar vector has as many entries as the C entry's
    Scalar enum, and the counters as its Counter enum."""
    src = Path(_build.SRC_DIR, "chemistry.cu").read_text()
    enum = re.search(r"enum Scalar \{([^}]*)\}", src).group(1)
    names = [s.strip() for s in enum.split(",") if s.strip()]
    assert names[-1] == "kNumScalars"
    assert len(names) - 1 == cc._NUM_SCALARS
    counters = [s.strip() for s in re.search(
        r"enum Counter \{([^}]*)\}", src).group(1).split(",") if s.strip()]
    assert counters[-1] == "kNumCounters"
    assert len(counters) - 1 == len(cc.COUNTERS)
