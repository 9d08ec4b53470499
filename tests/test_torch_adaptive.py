"""The PyTorch port's adaptive many-source sweep against the JAX
package's: the radius ladder, the initial radii and the promotion rule,
and Evolve3D.evolve3d end to end on a problem whose sources climb the
ladder within the first timestep (inputs made with numpy from a seed)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.config import test_problem_config as jax_config
from c2ray_tpu.ops.tables import build_rad_tables as jax_tables
from c2ray_tpu.solver import Evolve3D as JaxEvolve3D
from c2ray_tpu.state import initial_state as jax_initial_state

import c2ray_tpu_torch as port
from c2ray_tpu_torch.convert import config_from_dict, tables_from_numpy

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _tables(dtype, rate_eval):
    """The tables do not depend on the mesh: one build per dtype."""
    jtabs = jax_tables(jax_config(mesh=8, dtype=dtype, rate_eval=rate_eval))
    ptabs = tables_from_numpy({k: np.asarray(v) for k, v in
                               jtabs._asdict().items()}, "cpu")
    return jtabs, ptabs


def _solvers(**kw):
    jcfg = jax_config(**kw)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    jtabs, ptabs = _tables(jcfg.dtype, jcfg.rate_eval)
    return (JaxEvolve3D(jcfg, jtabs), port.Evolve3D(cfg, ptabs, device="cpu"))


@pytest.mark.parametrize("mesh,min_shell,source_batch", [
    (32, 8, 1), (64, 8, 256), (100, 2, 16), (256, 8, 256), (512, 5, 64)])
def test_ladder_and_chunk_sizes_match_jax(mesh, min_shell, source_batch):
    jsolver, psolver = _solvers(mesh=mesh, adaptive_min_shell=min_shell,
                                source_batch=source_batch, dtype="float32")
    ladder = jsolver._radius_ladder()
    assert psolver._radius_ladder() == ladder
    for r in ladder:
        assert psolver._window_chunk_size(r) == jsolver._window_chunk_size(r)
    assert psolver._full_chunk_size() == jsolver._full_chunk_size()


@pytest.mark.parametrize("num_src,seed", [(1, 0), (40, 3), (10000, 0)])
def test_initial_radii_and_promotion_match_jax(num_src, seed):
    jsolver, psolver = _solvers(mesh=256, dtype="float32")
    rng = np.random.default_rng(seed)
    nflux = 10.0 ** rng.uniform(4, 9, num_src)
    for nd_mean, dr, dt in ((1.98e-4, 7.25e23, 3e13), (2e-4, 3e22, 3e13),
                            (1e-5, 1e22, 3e15)):
        want = jsolver._initial_radii(nflux, nd_mean, dr, dt)
        got = psolver._initial_radii(nflux, nd_mean, dr, dt)
        np.testing.assert_array_equal(got, want)
        losses = nflux * rng.uniform(0.0, 0.03, num_src)
        np.testing.assert_array_equal(psolver._promote(losses, nflux, got),
                                      jsolver._promote(losses, nflux, want))


# --- Evolve3D adaptive, the port against JAX, 32^3 x 40 sources ---------

N, S = 32, 40
DR, DT = 3e22, 3e13


@functools.lru_cache(maxsize=None)
def _adaptive_runs(steps=2):
    kw = dict(mesh=N, dtype="float64", use_lls=False, cosmological=False,
              rate_eval="expsum", source_batch=8)
    jsolver, psolver = _solvers(**kw)
    rng = np.random.default_rng(3)
    srcpos = rng.integers(0, N, (S, 3)).astype(np.int32)
    nflux = 10.0 ** rng.uniform(4, 7, S)
    nflux[:3] = [3e8, 1e8, 3e7]
    ndens = np.full((N,) * 3, 1.98e-4)

    jrungs = []
    promote = jsolver._promote

    def record(per_src, nf, assign):
        jrungs[-1].append(np.bincount(assign, minlength=2).tolist())
        return promote(per_src, nf, assign)

    jsolver._promote = record
    jstate = jax_initial_state(jsolver.cfg)
    pstate = port.initial_state(psolver.cfg, device="cpu")
    out = []
    for _ in range(steps):
        jrungs.append([])
        jstate, ji = jsolver.evolve3d(jstate, jnp.asarray(ndens), DR, srcpos,
                                      nflux, DT)
        pstate, pi = psolver.evolve3d(pstate, torch.from_numpy(ndens), DR,
                                      srcpos, nflux, DT)
        out.append((ji, np.asarray(jstate.xh1), jrungs[-1], pi,
                    pstate.xh1.numpy()))
    return out


def test_adaptive_evolve3d_matches_jax_f64():
    runs = _adaptive_runs()
    first_rungs = runs[0][2]
    # the problem climbs the ladder: some sources start windowed and are
    # promoted to the full-cube rung within the first step
    assert first_rungs[0][0] > 0 and first_rungs[-1][1] > first_rungs[0][1]
    for ji, jx, jrungs, pi, px in runs:
        assert pi.niter == ji.niter
        assert pi.converged == ji.converged
        assert pi.rungs == jrungs
        assert pi.mean_xh1 == pytest.approx(ji.mean_xh1, rel=1e-9)
        np.testing.assert_allclose(px, jx, rtol=1e-9, atol=0)
        np.testing.assert_allclose(pi.per_source_loss, ji.per_source_loss,
                                   rtol=1e-9, atol=1e-12 * 3e8)
        np.testing.assert_allclose(pi.phih.numpy(), np.asarray(ji.phih),
                                   rtol=1e-9, atol=0)


def test_adaptive_rejects_positions_outside_the_grid():
    _, psolver = _solvers(mesh=16, dtype="float64", cosmological=False,
                          use_lls=False, adaptive_sweep=True)
    state = port.initial_state(psolver.cfg, device="cpu")
    nd = torch.full((16,) * 3, 1.98e-4, dtype=torch.float64)
    with pytest.raises(ValueError):
        psolver.evolve3d(state, nd, DR, np.array([[16, 0, 0]]),
                         np.array([1.0]), DT)
