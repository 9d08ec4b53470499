"""The PyTorch port's thermal evolution and LLS setup against the JAX
package's: the cooling table and its interpolation, the temperature and
pressure conversions, the subcycled thermal integration (dense and with
straggler compaction) and set_lls, on inputs made with numpy from a
seed."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.models import lls as jl
from c2ray_tpu.ops import thermal as jt

from c2ray_tpu_torch.convert import config_from_dict, cooling_from_numpy
from c2ray_tpu_torch.models import lls as pl
from c2ray_tpu_torch.ops import thermal as pt

torch.set_num_threads(2)

N = 16
DT = 3e13


def _pair(**kw):
    base = dict(mesh=N, dtype="float64", isothermal=False)
    base.update(kw)
    jcfg = jax_config(**base)
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def _cools(jcfg):
    jcool = jt.setup_cool(jcfg)
    pcool = cooling_from_numpy({"cie_cool": np.asarray(jcool.cie_cool),
                                "mintemp": jcool.mintemp,
                                "dtemp": jcool.dtemp}, "cpu")
    return jcool, pcool


def _t(a):
    return torch.from_numpy(np.array(a))


def _grid(seed):
    """Temperatures from below minitemp to hot, densities, fractions and
    heating rates from none to strong (strong-heated cells subcycle for
    hundreds of substeps: the stragglers)."""
    rng = np.random.default_rng(seed)
    shape = (N,) * 3
    t0 = rng.uniform(50.0, 3e4, shape)
    t0.flat[:5] = [0.5, 1.0, 2.0, 1e5, 3e6]
    nd = rng.uniform(1e-5, 1e-3, shape)
    x1e, x1a, x1o = (rng.uniform(0.0, 1.0, shape) for _ in range(3))
    heat = 10.0 ** rng.uniform(-30, -22, shape)
    heat.flat[5:200] = 0.0
    return t0, nd, x1e, x1a, x1o, heat


def test_cooling_table_matches_jax():
    """analytic_cie_curve and setup_cool, directly and through
    cooling_from_numpy: the same numbers."""
    jcfg, pcfg = _pair()
    logt = np.linspace(0.5, 9.5, 97)
    np.testing.assert_array_equal(pt.analytic_cie_curve(logt),
                                  jt.analytic_cie_curve(logt))
    jcool, pcool = _cools(jcfg)
    own = pt.setup_cool(pcfg, device="cpu")
    for cool in (pcool, own):
        np.testing.assert_array_equal(cool.cie_cool.numpy(),
                                      np.asarray(jcool.cie_cool))
        assert cool.mintemp == jcool.mintemp and cool.dtemp == jcool.dtemp
    assert own.cie_cool.dtype == torch.float64


def test_setup_cool_reads_a_table_file(tmp_path):
    jcfg, pcfg = _pair()
    logt = np.linspace(1.0, 9.0, pt.TEMPPOINTS)
    path = tmp_path / "corocool.tab"
    np.savetxt(path, np.stack([logt, np.log10(pt.analytic_cie_curve(logt))
                               * 1.01], axis=1))
    want = jt.setup_cool(jcfg, table_file=str(path))
    got = pt.setup_cool(pcfg, table_file=str(path), device="cpu")
    np.testing.assert_array_equal(got.cie_cool.numpy(),
                                  np.asarray(want.cie_cool))
    assert (got.mintemp, got.dtemp) == (want.mintemp, want.dtemp)


def test_coolin_and_conversions_match_jax():
    """coolin over the table's range and beyond it (clamped ends),
    temper2pressr and pressr2temper; rtol 1e-12 (the log differs from
    XLA's by an ulp at most)."""
    jcfg, _ = _pair()
    jcool, pcool = _cools(jcfg)
    rng = np.random.default_rng(1)
    temp = 10.0 ** rng.uniform(0.0, 10.0, 4000)
    nd = rng.uniform(1e-5, 1e-2, 4000)
    ne = nd * rng.uniform(0.0, 1.2, 4000)
    np.testing.assert_allclose(
        pt.coolin(pcool, _t(nd), _t(ne), _t(temp)).numpy(),
        np.asarray(jt.coolin(jcool, jnp.asarray(nd), jnp.asarray(ne),
                             jnp.asarray(temp))), rtol=1e-12, atol=0)
    p = jt.temper2pressr(jnp.asarray(temp), jnp.asarray(nd),
                         jnp.asarray(ne))
    np.testing.assert_allclose(
        pt.temper2pressr(_t(temp), _t(nd), _t(ne)).numpy(), np.asarray(p),
        rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        pt.pressr2temper(_t(np.asarray(p)), _t(nd), _t(ne)).numpy(),
        np.asarray(jt.pressr2temper(p, jnp.asarray(nd), jnp.asarray(ne))),
        rtol=1e-12, atol=0)


def test_thermal_matches_jax_f64():
    """thermal at 16^3 f64 with straggler cells (hundreds of substeps),
    cells at and below minitemp and an adiabatic term: both temperatures
    at rtol 1e-10, and the cells at or below minitemp untouched."""
    jcfg, pcfg = _pair()
    jcool, pcool = _cools(jcfg)
    t0, nd, x1e, x1a, x1o, heat = _grid(0)
    want = jt.thermal(jcfg, jcool, DT, jnp.asarray(t0), None,
                      jnp.asarray(nd), jnp.asarray(x1e), jnp.asarray(x1a),
                      jnp.asarray(x1o), jnp.asarray(heat),
                      cosmo_cool_coeff=1e-18)
    before = dict(pt.TRIPS)
    got = pt.thermal(pcfg, pcool, DT, _t(t0), None, _t(nd), _t(x1e),
                     _t(x1a), _t(x1o), _t(heat), cosmo_cool_coeff=1e-18)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=0)
    cold = t0 <= pcfg.minitemp
    assert cold.sum() == 2
    for g in got:
        np.testing.assert_array_equal(g.numpy()[cold], t0[cold])
    # the stragglers finished in the compacted pass
    assert pt.TRIPS["compact"] > before["compact"]


@pytest.mark.parametrize("sync_every", [1, 3])
def test_thermal_compaction_and_sync_cadence_bitwise(sync_every,
                                                     monkeypatch):
    """thermal_compact on and off, and the compacted loop's test of the
    running cells after every substep or every third against the default
    cadence: torch.equal on both temperatures (the same substep closure,
    the same per-cell sequences; the cap of max_subcycles stays exact)."""
    jcfg, pcfg = _pair()
    _, pcool = _cools(jcfg)
    args = [_t(a) for a in _grid(2)]
    t0, nd, x1e, x1a, x1o, heat = args

    def run(cfg, **kw):
        return pt.thermal(cfg, pcool, DT, t0, None, nd, x1e, x1a, x1o, heat,
                          cosmo_cool_coeff=1e-18, **kw)

    ref = run(pcfg.replace(thermal_compact=False))
    compact = run(pcfg)
    capped = run(pcfg.replace(thermal_compact=False), max_subcycles=37)
    monkeypatch.setattr(pt, "_SYNC_EVERY", sync_every)
    for got, want in ((run(pcfg), ref), (compact, ref),
                      (run(pcfg.replace(thermal_compact=False)), ref),
                      (run(pcfg, max_subcycles=37), capped)):
        assert torch.equal(got.final_temperature, want.final_temperature)
        assert torch.equal(got.average_temperature, want.average_temperature)
    assert not torch.equal(capped.final_temperature, ref.final_temperature)


@pytest.mark.parametrize("zred", [6.0, 9.0, 15.0, 30.0])
@pytest.mark.parametrize("lls_type,model", [(1, 1), (1, 3), (1, 5), (3, 5),
                                            (None, 5)])
def test_set_lls_matches_jax(zred, lls_type, model):
    """set_lls for LLS off and types 1 and 3 at several redshifts,
    mean-free-path models 1, 3 and 5: the same fields."""
    kw = (dict(use_lls=False) if lls_type is None
          else dict(use_lls=True, type_of_lls=lls_type))
    jcfg, pcfg = _pair(lls_model=model, **kw)
    dr = pcfg.dr_comoving / (1.0 + zred)
    want = jl.set_lls(jcfg, zred, dr)
    got = pl.set_lls(pcfg, zred, dr)
    for name in ("coldensh_lls", "mfp_pmpc", "r_max_cells"):
        assert getattr(got, name) == getattr(want, name), name
    assert pl.mfp_models(0.7) == {k: tuple(v) for k, v in
                                  jl.mfp_models(0.7).items()}
