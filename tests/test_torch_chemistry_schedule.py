"""The chemistry kernel's schedule (csrc/chemistry.cu) on the CPU.

(a) A model of the persistent kernel's schedule, written here in Python
over the port's own ops: a grid of at most `resident` blocks, no more
than take a cell a thread, whose thread t of T takes cells t, t + T, ...
and runs each to its end; its counts summed and maxed per thread, then
over the block and over the blocks.  The model is held bitwise against
global_chemistry_reference (the masked grid loop), every cell taken
exactly once, and its five counters against a counting copy of that
grid loop.  The kernel itself runs only on the card (chip_smoke.py phase
20 holds it bitwise against the plain version there); here its source is
held to the rule that keeps it bitwise under --fmad=true.

(b) The cold-IGM state (every cell at 100 K, a few cells near a source
heated over many substeps) through the port's plain global_chemistry and
the JAX package's at float64, and the spread of its substeps.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.ops import chemistry as jc
from c2ray_tpu.ops.thermal import setup_cool as jax_setup_cool

from c2ray_tpu_torch import _build
from c2ray_tpu_torch import constants as const
from c2ray_tpu_torch.config import RunConfig
from c2ray_tpu_torch.convert import config_from_dict, cooling_from_numpy
from c2ray_tpu_torch.ops import chemistry as pc
from c2ray_tpu_torch.ops.chemistry_cuda import COUNTERS
from c2ray_tpu_torch.ops.doric import doric, electrondens, \
    recombination_rates
from c2ray_tpu_torch.ops.thermal import (_make_substep, pressr2temper,
                                         setup_cool, temper2pressr)
from c2ray_tpu_torch.state import compress_xh, xh0_of, xh1_of

torch.set_num_threads(2)

DT = 3.0e13
COEFF = 1e-17
# (5, 8, 8): 320 cells; every round of the model's grids is a multiple of
# 32 cells, whole CPU vectors (the grid loop's lanes round as a round's)
SHAPE = (5, 8, 8)


def _inputs(seed, dtype, compressed):
    rng = np.random.default_rng(seed)
    nd = rng.uniform(1e-4, 1e-3, SHAPE)
    x0 = 10 ** rng.uniform(-4, -0.01, SHAPE)
    xi = np.clip(x0 + rng.uniform(0, 0.3, SHAPE), 0, 1)
    xa = np.clip(x0 + rng.uniform(0, 0.2, SHAPE), 0, 1)
    ph = 10 ** rng.uniform(-16, -11, SHAPE) * (rng.uniform(size=SHAPE) > 0.1)
    tc = 10 ** rng.uniform(2, 4.5, SHAPE)
    t = lambda a: torch.as_tensor(a, dtype=dtype)            # noqa: E731
    xs = [t(x0), t(xi), t(xa)]
    if compressed:
        xs = [compress_xh(x) for x in xs]
    return dict(nd=t(nd), x0=xs[0], xi=xs[1], xa=xs[2], ph=t(ph),
                phh=t(ph * 1e-16 * nd), tc=t(tc),
                ta=t(tc * rng.uniform(0.9, 1.5, SHAPE)),
                clump=t(rng.uniform(1, 5, SHAPE)),
                loss=t(10 ** rng.uniform(-16, -13, SHAPE)))


def _decode(cfg, x):
    """A stored fraction -> (clamped x1, clamped x0 or None)."""
    eps = cfg.epsilon
    if cfg.compressed_xfrac:
        return (torch.clamp(xh1_of(x), min=eps),
                torch.clamp(xh0_of(x), min=eps))
    return torch.clamp(x, min=eps), None


def _schedule_model(args, kw, max_sub, resident, threads):
    """The kernel's schedule over the grid's cells (args and kw are
    global_chemistry_reference's): min(resident, ceil(n / threads))
    blocks of `threads` (the kernel's 256, fewer here so that 320 cells
    take several rounds); thread t of the T in the grid takes cells t, t +
    T, ... and runs each to its end, so a round of T consecutive cells
    runs as the masked loop over them (the cells are independent).  Each
    thread's passes and substeps are summed and maxed over its cells,
    then over the block's threads and over the blocks, as the kernel's
    reduce and its last block do; conv_flag, a sum of integers, by round.
    -> ([xh1_intermed, xh1_av, temper_intermed, temper_av], {counter:
    value}, times each cell was taken)"""
    cfg, dt, nd = args[:3]
    n = nd.numel()
    blocks = min(resident, -(-n // threads))
    total = blocks * threads
    cell_grids = [a.reshape(-1) for a in args[2:]]
    is_grid = lambda v: isinstance(v, torch.Tensor) and v.numel() == n  # noqa
    kw_flat = {k: (v.reshape(-1) if is_grid(v) else v) for k, v in kw.items()}
    outs = [torch.full((n,), float("nan"), dtype=nd.dtype) for _ in range(4)]
    taken = torch.zeros(n, dtype=torch.int64)
    per_thread = {c: torch.zeros(total, dtype=torch.int64)
                  for c in ("max_passes", "passes", "substeps",
                            "max_substeps")}
    ion = 0
    for start in range(0, n, total):
        idx = torch.arange(start, min(start + total, n))
        thread = idx - start
        taken.index_add_(0, idx, torch.ones_like(idx))
        cargs = (cfg, dt, *(a[idx] for a in cell_grids))
        ckw = {k: (v[idx] if is_grid(v) else v) for k, v in kw_flat.items()}
        res = pc.global_chemistry_reference(*cargs, **ckw)
        for out, r in zip(outs, res[:4]):
            if r is not None:
                out[idx] = r
        ion += int(res.conv_flag)
        _, _, passes, subs, most = _counted_grid_loop(cfg, cargs, ckw,
                                                      max_sub)
        per_thread["passes"][thread] += passes
        per_thread["substeps"][thread] += subs
        for c, v in (("max_passes", passes), ("max_substeps", most)):
            per_thread[c][thread] = torch.maximum(per_thread[c][thread], v)
    counters = {"conv_flag": ion}
    for c, v in per_thread.items():
        by_block = v.view(blocks, threads)
        if c.startswith("max"):
            counters[c] = int(by_block.amax(1).max())
        else:
            counters[c] = int(by_block.sum(1).sum())
    shape = nd.shape
    return [o.reshape(shape) for o in outs], counters, taken


def _counted_grid_loop(cfg, args, kw, max_sub):
    """global_chemistry_reference's masked grid loop, written out with
    each cell's passes and per-pass substeps counted -> (xh1_intermed,
    temper_av, per-cell passes, per-cell substeps, per-cell most substeps
    in a pass)"""
    dt_f, nd, x0, _, xa, ph = args[1:]
    heat = not cfg.isothermal
    comp = cfg.compressed_xfrac
    eps, mfc = cfg.epsilon, cfg.minimum_fractional_change
    dt = torch.full((), dt_f, dtype=nd.dtype)
    clump = kw.get("clumping", 1.0)
    h1_old, h0_old = _decode(cfg, x0)
    h_av1, h_av0 = _decode(cfg, xa)
    h1 = torch.clamp(xh1_of(args[4]) if comp else args[4], min=eps)
    t_av = kw["temper_av"] if heat else None
    rates = (None if heat else recombination_rates(
        torch.full((), cfg.initial_temperature, dtype=nd.dtype), clump))
    ph_total = ph + kw.get("photon_loss_rate", 0.0)
    active = torch.ones(nd.shape, dtype=torch.bool)
    cell_passes = torch.zeros(nd.shape, dtype=torch.int64)
    cell_subs = torch.zeros(nd.shape, dtype=torch.int64)
    cell_max = torch.zeros(nd.shape, dtype=torch.int64)
    for _ in range(cfg.max_chemistry_iterations):
        if not bool(active.any()):
            break
        cell_passes += active.to(torch.int64)
        prev = h_av0 if comp else torch.clamp(1.0 - h_av1, min=eps)
        res = doric(cfg, dt, t_av, electrondens(nd, h_av1), h1_old, ph_total,
                    clump, rates=rates, xh0_old=h0_old)
        if heat:
            t0 = kw["temper_current"]
            e0 = temper2pressr(t0, nd, electrondens(nd, h1_old)) \
                / const.GAMMA1
            substep = _make_substep(cfg, kw["cool"], dt, nd,
                                    electrondens(nd, res.xh1_av),
                                    kw["cosmo_cool_coeff"] * e0,
                                    kw["phiheat"])
            zero = torch.zeros_like(t0)
            state = (e0, t0, zero, zero, t0 > cfg.minitemp)
            count = torch.zeros(nd.shape, dtype=torch.int64)
            for _ in range(max_sub):
                if not bool(state[-1].any()):
                    break
                count += state[-1].to(torch.int64)
                state = substep(state)
            cell_subs += torch.where(active, count, 0)
            cell_max = torch.where(active, torch.maximum(cell_max, count),
                                   cell_max)
            avg_t = torch.where(dt > 0.0, state[2] / dt, t0)
            avg_t = torch.where(t0 > cfg.minitemp, avg_t, t0)
            t_av = torch.where(active, avg_t, t_av)
        conv = ((torch.abs((res.xh0_av - prev) / res.xh0_av) < mfc)
                | (res.xh0_av < cfg.minimum_fraction_of_atoms))
        h1 = torch.where(active, res.xh1, h1)
        h_av1 = torch.where(active, res.xh1_av, h_av1)
        if comp:
            h_av0 = torch.where(active, res.xh0_av, h_av0)
        active = active & ~conv
    return h1, t_av, cell_passes, cell_subs, cell_max


def _case_cfg(dtype, heat, comp, caps):
    return RunConfig(mesh=SHAPE, dtype=str(dtype).split(".")[1],
                     isothermal=not heat, compressed_xfrac=comp,
                     thermal_compact=False,
                     max_chemistry_iterations=2 if caps else 400)


CASES = [(d, h, c, caps) for d in (torch.float64, torch.float32)
         for h in (False, True) for c in (False, True)
         for caps in (False, True)]


def _case(dtype, heat, comp, caps, seed=11):
    cfg = _case_cfg(dtype, heat, comp, caps)
    inp = _inputs(seed, dtype, comp)
    max_sub = 3 if caps else 10000
    kw = dict(clumping=inp["clump"] if comp else 1.7,
              photon_loss_rate=inp["loss"] if comp else 0.0,
              max_subcycles=max_sub)
    if heat:
        kw.update(phiheat=inp["phh"], temper_current=inp["tc"],
                  temper_av=inp["ta"], cool=setup_cool(cfg, device="cpu"),
                  cosmo_cool_coeff=COEFF)
    args = (cfg, DT, inp["nd"], inp["x0"], inp["xi"], inp["xa"], inp["ph"])
    return args, kw, max_sub


def _exact_counters(args, kw, max_sub, want):
    """The five counters of the masked grid loop, counted cell by cell."""
    _, _, cell_passes, cell_subs, cell_max = _counted_grid_loop(
        args[0], args, kw, max_sub)
    return dict(conv_flag=int(want.conv_flag),
                max_passes=int(want.n_iterations),
                passes=int(cell_passes.sum()), substeps=int(cell_subs.sum()),
                max_substeps=int(cell_max.max()))


@pytest.mark.parametrize(
    "dtype,heat,comp,caps", CASES,
    ids=[f"{str(d)[-7:]}-{'heat' if h else 'iso'}"
         f"{'-compressed' if c else ''}{'-caps' if caps else ''}"
         for d, h, c, caps in CASES])
def test_schedule_matches_grid_loop(dtype, heat, comp, caps):
    """The persistent schedule (three blocks of 64: two rounds, the second
    ragged) gives the masked grid loop's outputs bit for bit, takes every
    cell once, and its counters are the grid loop's exact counts; the pass
    cap (2) and the substep cap (3) bind where set.  Clumping and
    loss-rate grids in the compressed cases."""
    args, kw, max_sub = _case(dtype, heat, comp, caps)
    cfg = args[0]
    want = pc.global_chemistry_reference(*args, **kw)
    got, counters, taken = _schedule_model(args, kw, max_sub, resident=3,
                                           threads=64)
    assert torch.equal(taken, torch.ones_like(taken))
    assert torch.equal(got[0], want.xh1_intermed)
    assert torch.equal(got[1], want.xh1_av)
    if heat:
        assert torch.equal(got[2], want.temper_intermed)
        assert torch.equal(got[3], want.temper_av)
    h1, t_av, _, _, _ = _counted_grid_loop(cfg, args, kw, max_sub)
    if not comp:
        assert torch.equal(h1, want.xh1_intermed)
    if heat:
        assert torch.equal(t_av, want.temper_av)
    assert counters == _exact_counters(args, kw, max_sub, want)
    assert set(counters) == set(COUNTERS)
    if caps:
        assert counters["max_passes"] == cfg.max_chemistry_iterations
        if heat:
            assert counters["max_substeps"] == max_sub


@pytest.mark.parametrize("resident,threads", [(1, 32), (4, 32), (8, 64)],
                         ids=["one-block", "ragged-round", "grid-capped"])
def test_schedule_grids_take_every_cell_once(resident, threads):
    """The schedule's other grids (one block of 32: ten rounds; four
    blocks of 32: rounds of 128 with a last of 64; eight resident blocks
    of 64 cut to the five that take a cell a thread: one round) give the
    same bits and counts."""
    args, kw, max_sub = _case(torch.float32, True, False, False, seed=12)
    want = pc.global_chemistry_reference(*args, **kw)
    got, counters, taken = _schedule_model(args, kw, max_sub, resident,
                                           threads)
    assert torch.equal(taken, torch.ones_like(taken))
    for g, w in zip(got, want[:4]):
        assert torch.equal(g, w)
    assert counters == _exact_counters(args, kw, max_sub, want)


# the integers the source multiplies: indices, strides, counts, literals
INT_OPERANDS = {"i", "a", "c", "q", "lane", "per", "blocks", "nblocks",
                "sms", "per_sm", "blockIdx.x", "gridDim.x", "kThreads",
                "kChunks", "kNumCounters", "kNumAudit", "p.loss_stride",
                "p.brech_stride", "p.clump_stride"}
C_TYPES = {"real", "double", "float", "int", "char", "void", "long",
           "unsigned", "bool", "Chem"}


def _int_operand(text, backward):
    """Whether the operand beside a `*` is an integer: a name of
    INT_OPERANDS, a literal, or a bracket of only them.  text: the code
    before the `*` (backward) or after it."""
    text = text.rstrip() if backward else text.lstrip()
    if text[-1:] == ")" if backward else text[:1] == "(":
        depth, order = 0, range(len(text) - 1, -1, -1) if backward else \
            range(len(text))
        for k in order:
            depth += (text[k] == "(") - (text[k] == ")")
            if depth == 0:
                inner = text[k + 1:-1] if backward else text[1:k]
                return all(t in INT_OPERANDS or t.isdigit()
                           for t in re.findall(r"[\w.]+", inner))
        return False
    m = (re.search(r"[\w.]+$", text) if backward
         else re.match(r"[\w.]+", text))
    return m is not None and (m.group(0) in INT_OPERANDS
                              or m.group(0).isdigit())


def _bare_products(code):
    """The binary `*` of C++ code (comments and strings removed) whose
    operands are not both INT_OPERANDS or integer literals: pointer
    declarators (after a type), dereferences (after an operator, an
    opening bracket or a cast) and integer products pass."""
    bad = []
    for m in re.finditer(r"\*", code):
        before, after = code[:m.start()], code[m.end():]
        prev = re.search(r"(\w+|\S)\s*$", before).group(1)
        if prev in C_TYPES or prev in set("(=,?:![{;") or prev == "return":
            continue
        if re.search(r"\((real|double|float)\)\s*$", before):
            continue
        if not (_int_operand(before, True)
                and _int_operand(after, False)):
            line = code.count("\n", 0, m.start()) + 1
            bad.append(f"line {line}: {code[m.start() - 30:m.end() + 20]!r}")
    return bad


def _strip(src):
    code = re.sub(r"//[^\n]*", lambda m: " " * len(m.group(0)), src)
    code = re.sub(r"/\*.*?\*/",
                  lambda m: re.sub(r"[^\n]", " ", m.group(0)), code,
                  flags=re.S)
    return re.sub(r'"(?:\\.|[^"\\])*"', '""', code)


def test_fmad_sources_multiply_only_through_r_mul():
    """A source built with --fmad=true (_build.FMAD_KERNELS: the chemistry
    kernel, so that the libdevice routines compile as in PyTorch's
    elementwise kernels) stays bitwise to its plain version only while
    every product of its own floating-point values is r_mul (real.cuh:
    __fmul_rn / __dmul_rn, never fused with an add into an FMA): any
    other `*` in its code is a pointer's, a dereference or a product of
    the integers INT_OPERANDS names.  The rule's own check finds a bare
    product."""
    assert "chemistry" in _build.FMAD_KERNELS
    assert "--fmad=true" in _build._flags("chemistry")
    assert "--fmad=false" in _build._flags("consume")
    real = (_build.SRC_DIR / "real.cuh").read_text()
    assert "return __fmul_rn(a, b);" in real
    assert "return __dmul_rn(a, b);" in real
    for name in _build.FMAD_KERNELS:
        code = _strip((_build.SRC_DIR / f"{name}.cu").read_text())
        assert "r_mul(" in code
        assert _bare_products(code) == [], name
    planted = "const real e = r_mul(a, b) + c * d;  // i * kThreads"
    assert len(_bare_products(_strip(planted))) == 1


# --- (b) the cold IGM -------------------------------------------------------

N = 16


def _cold_state():
    """16^3 float64 at 100 K: a source's lit sphere (radius ~3.5 cells)
    with photoionization and heating falling off with distance and a
    sharp optical-depth front, dark gas outside it."""
    rng = np.random.default_rng(21)
    shape = (N,) * 3
    c = np.indices(shape) - (N // 2)
    r = np.sqrt((c ** 2).sum(0)) + 0.5
    tau = np.maximum(0.0, r - 3.0) * 5.0
    ndens = rng.uniform(1e-4, 3e-4, shape)
    xh_old = np.where(r < 3.5, rng.uniform(0.5, 0.99, shape),
                      rng.uniform(1e-4, 3e-4, shape))
    xh_int = np.clip(xh_old + rng.uniform(0, 0.05, shape), 1e-6, 1 - 1e-9)
    xh_av = np.clip(0.5 * (xh_old + xh_int), 1e-6, 1 - 1e-9)
    phih = 1e-12 / r ** 2 * np.exp(-tau)
    heat = phih * ndens * (1.0 - xh_av) * 3e-12
    temp = np.full(shape, 100.0)
    return ndens, xh_old, xh_int, xh_av, phih, heat, temp


def test_cold_igm_matches_jax_and_spreads_substeps():
    """The port's plain global_chemistry against JAX's on the cold state
    at float64 (rtol 1e-9, the repo's float64 gate: XLA's exp and log
    differ from libm by an ulp), conv_flag and the iteration count exact;
    and the state spreads the thermal substeps: the most substeps of a
    cell in one pass are at least 10x the mean per cell and pass."""
    jcfg = jax_config(mesh=N, dtype="float64", cosmological=False,
                      isothermal=False)
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    jcool = jax_setup_cool(jcfg)
    pcool = cooling_from_numpy({"cie_cool": np.asarray(jcool.cie_cool),
                                "mintemp": jcool.mintemp,
                                "dtemp": jcool.dtemp}, "cpu")
    ndens, xh_old, xh_int, xh_av, phih, heat, temp = _cold_state()
    arrays = (ndens, xh_old, xh_int, xh_av, phih, heat, temp, temp)
    want = jc.global_chemistry(jcfg, DT, *(jnp.asarray(a) for a in arrays),
                               cool=jcool, cosmo_cool_coeff=COEFF)
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    got = pc.global_chemistry(pcfg, DT, *t, cool=pcool,
                              cosmo_cool_coeff=COEFF)
    for name in ("xh1_intermed", "xh1_av", "temper_intermed", "temper_av"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-9, atol=0, err_msg=name)
    assert int(got.conv_flag) == int(want.conv_flag)
    assert int(got.n_iterations) == int(want.n_iterations)
    kw = dict(phiheat=t[5], temper_current=t[6], temper_av=t[7], cool=pcool,
              cosmo_cool_coeff=COEFF)
    _, t_av, passes, subs, most = _counted_grid_loop(
        pcfg.replace(thermal_compact=False), (pcfg, DT, *t[:5]), kw, 10000)
    assert torch.equal(t_av, got.temper_av)
    mean = int(subs.sum()) / int(passes.sum())
    assert int(most.max()) >= 10 * mean
    assert float(got.temper_av.max()) > 10 * 100.0      # the lit cells heat
