"""The PyTorch port's chemistry and photon audit against the JAX
package's (doric, global_chemistry with its exact conv_flag, grid_counts),
float64, on inputs made with numpy from a seed."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.ops import chemistry as jc
from c2ray_tpu.ops import doric as jd
from c2ray_tpu.ops import photonstats as jp

from c2ray_tpu_torch.convert import config_from_dict
from c2ray_tpu_torch.ops import chemistry as pc
from c2ray_tpu_torch.ops import doric as pd
from c2ray_tpu_torch.ops import photonstats as pp

torch.set_num_threads(2)

N = 12
DT = 3.0e13


def _pair(**kw):
    jcfg = jax_config(mesh=N, dtype="float64", cosmological=False, **kw)
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def _inputs(seed):
    """A mixed grid: neutral, ionized and front cells, with rates spanning
    no ionization to strong flux."""
    rng = np.random.default_rng(seed)
    shape = (N,) * 3
    ndens = rng.uniform(1e-4, 3e-4, shape)
    xh_old = np.where(rng.uniform(size=shape) < 0.5,
                      rng.uniform(1e-5, 1e-3, shape),
                      rng.uniform(0.9, 1.0 - 1e-9, shape))
    xh_int = np.clip(xh_old + rng.uniform(-0.1, 0.1, shape), 1e-6, 1 - 1e-9)
    xh_av = np.clip(0.5 * (xh_old + xh_int), 1e-6, 1 - 1e-9)
    phih = np.where(rng.uniform(size=shape) < 0.3, 0.0,
                    10.0 ** rng.uniform(-17, -11, shape))
    return ndens, xh_old, xh_int, xh_av, phih


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_doric():
    jcfg, pcfg = _pair()
    ndens, xh_old, _, xh_av, phih = _inputs(1)
    temp = np.full_like(ndens, 1e4)
    temp[0] = 3e3
    de = ndens * (xh_av + 7.1e-7)
    want = jd.doric(jcfg, DT, jnp.asarray(temp), jnp.asarray(de),
                    jnp.asarray(xh_old), jnp.asarray(phih), 1.7)
    got = pd.doric(pcfg, torch.tensor(DT, dtype=torch.float64), _t(temp),
                   _t(de), _t(xh_old), _t(phih), 1.7)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=0)
    np.testing.assert_allclose(
        pd.electrondens(_t(ndens), _t(xh_av)).numpy(),
        np.asarray(jd.electrondens(jnp.asarray(ndens), jnp.asarray(xh_av))),
        rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed,max_iter", [(2, 400), (3, 400), (4, 3)])
def test_global_chemistry(seed, max_iter):
    """Iterates, conv_flag and the inner iteration count match, including
    a run that stops at a small iteration cap."""
    jcfg, pcfg = _pair(max_chemistry_iterations=max_iter)
    ndens, xh_old, xh_int, xh_av, phih = _inputs(seed)
    want = jc.global_chemistry(jcfg, DT, jnp.asarray(ndens),
                               jnp.asarray(xh_old), jnp.asarray(xh_int),
                               jnp.asarray(xh_av), jnp.asarray(phih),
                               clumping=1.3)
    got = pc.global_chemistry(pcfg, DT, _t(ndens), _t(xh_old), _t(xh_int),
                              _t(xh_av), _t(phih), clumping=1.3)
    # XLA's float64 exp differs from torch's (libm's) by one ulp on ~15% of
    # arguments; the fixed-point iteration carries that to a few ulp in
    # the odd cell (1.2e-12 measured), so the iterates hold to 4e-12
    np.testing.assert_allclose(got.xh1_intermed.numpy(),
                               np.asarray(want.xh1_intermed), rtol=4e-12,
                               atol=0)
    np.testing.assert_allclose(got.xh1_av.numpy(), np.asarray(want.xh1_av),
                               rtol=4e-12, atol=0)
    assert int(got.conv_flag) == int(want.conv_flag)
    assert int(got.n_iterations) == int(want.n_iterations)
    assert 0 < int(got.conv_flag) < N ** 3


@pytest.mark.parametrize("check_every", [1, 2, 7])
def test_chemistry_sync_cadence_is_exact(check_every, monkeypatch):
    """Testing active.any() less often changes nothing in the outputs."""
    _, pcfg = _pair()
    args = [_t(a) for a in _inputs(5)]
    ref = pc.global_chemistry(pcfg, DT, *args[:4], args[4])
    monkeypatch.setattr(pc, "_SYNC_EVERY", check_every)
    got = pc.global_chemistry(pcfg, DT, *args[:4], args[4])
    assert torch.equal(got.xh1_intermed, ref.xh1_intermed)
    assert torch.equal(got.xh1_av, ref.xh1_av)
    assert int(got.conv_flag) == int(ref.conv_flag)
    assert int(got.n_iterations) == int(ref.n_iterations)


def _thermal_inputs(seed):
    """Temperatures (the step-initial current one and an average iterate
    from a previous convergence iteration) and a heating grid: none,
    weak and strong."""
    rng = np.random.default_rng(seed)
    shape = (N,) * 3
    t_cur = rng.uniform(80.0, 2e4, shape)
    t_av = t_cur * rng.uniform(0.5, 1.5, shape)
    heat = np.where(rng.uniform(size=shape) < 0.4, 0.0,
                    10.0 ** rng.uniform(-29, -23, shape))
    return t_cur, t_av, heat


@pytest.mark.parametrize("seed,max_iter", [(6, 400), (7, 5)])
def test_global_chemistry_non_isothermal(seed, max_iter):
    """The heat branch: thermal from the step-initial temperature in
    every iteration, per-cell recombination rates and the temperature
    term of conv_flag.  xh1 and both temperatures at rtol 1e-10,
    conv_flag and the iteration count exact, against JAX at f64."""
    from c2ray_tpu.ops.thermal import setup_cool
    from c2ray_tpu_torch.convert import cooling_from_numpy

    jcfg, pcfg = _pair(isothermal=False, max_chemistry_iterations=max_iter)
    jcool = setup_cool(jcfg)
    pcool = cooling_from_numpy({"cie_cool": np.asarray(jcool.cie_cool),
                                "mintemp": jcool.mintemp,
                                "dtemp": jcool.dtemp}, "cpu")
    ndens, xh_old, xh_int, xh_av, phih = _inputs(seed)
    t_cur, t_av, heat = _thermal_inputs(seed)
    want = jc.global_chemistry(
        jcfg, DT, *(jnp.asarray(a) for a in (ndens, xh_old, xh_int, xh_av,
                                              phih, heat, t_cur, t_av)),
        clumping=1.3, cool=jcool, cosmo_cool_coeff=1e-18)
    got = pc.global_chemistry(
        pcfg, DT, *(_t(a) for a in (ndens, xh_old, xh_int, xh_av, phih, heat,
                                     t_cur, t_av)),
        clumping=1.3, cool=pcool, cosmo_cool_coeff=1e-18)
    for name in ("xh1_intermed", "xh1_av", "temper_intermed", "temper_av"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-10, atol=0, err_msg=name)
    assert int(got.conv_flag) == int(want.conv_flag)
    assert int(got.n_iterations) == int(want.n_iterations)
    assert 0 < int(got.conv_flag) < N ** 3
    with pytest.raises(ValueError):
        pc.global_chemistry(pcfg, DT, *(_t(a) for a in (
            ndens, xh_old, xh_int, xh_av, phih, heat, t_cur, t_av)))


@pytest.mark.parametrize("with_temp", [False, True])
def test_grid_counts(with_temp):
    jcfg, pcfg = _pair()
    ndens, xh_old, _, _, _ = _inputs(7)
    temp = np.random.default_rng(8).uniform(5e3, 3e4, ndens.shape)
    want = jp.grid_counts(jcfg, jnp.asarray(ndens), jnp.asarray(xh_old),
                          jnp.asarray(temp) if with_temp else None, 1.3)
    got = pp.grid_counts(pcfg, _t(ndens), _t(xh_old),
                         _t(temp) if with_temp else None, 1.3)
    for w, g in zip(want, got):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-12, atol=0)


def test_photon_statistics_report():
    jcfg, pcfg = _pair()
    js, ps = jp.PhotonStatistics(jcfg), pp.PhotonStatistics(pcfg)
    ndens, xh_old, xh_int, xh_av, _ = _inputs(9)
    vol = 3.3e66
    for st, mod, arr in ((js, jp, jnp.asarray), (ps, pp, _t)):
        cfg = st.cfg
        st.state_before(mod.grid_counts(cfg, arr(ndens), arr(xh_old)), vol)
        st.calculate(mod.grid_counts(cfg, arr(ndens), arr(xh_int)),
                     mod.grid_counts(cfg, arr(ndens), arr(xh_av)), vol, DT)
    want = js.report(DT, 0.3, 0.01, 2.5)
    got = ps.report(DT, 0.3, 0.01, 2.5)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
