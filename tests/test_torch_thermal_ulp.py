"""How far the cooling-rate interpolation (ops/thermal.coolin) moves when
log(T) moves by one ulp, at the inputs of
tests/test_torch_thermal.py::test_coolin_and_conversions_match_jax.

That test holds the port's coolin to the JAX package's at rtol 1e-12.
Where the analytic cooling table rises steeply between two nodes, a
last-place difference between two libraries' float64 log moves the
interpolated rate by more than that, so the parity test passes only while
torch's and XLA's log agree to the last bit on its inputs (they do on the
CPU paths this repository's tests run on: see ROADMAP.md, Queue 3)."""

import numpy as np
import pytest
import torch

from c2ray_tpu_torch import config as pconfig
from c2ray_tpu_torch.ops import thermal as pt

torch.set_num_threads(2)


def _inputs():
    """test_coolin_and_conversions_match_jax's temperatures and densities
    (the same seed and draws)."""
    rng = np.random.default_rng(1)
    temp = 10.0 ** rng.uniform(0.0, 10.0, 4000)
    nd = rng.uniform(1e-5, 1e-2, 4000)
    ne = nd * rng.uniform(0.0, 1.2, 4000)
    return [torch.from_numpy(np.array(a)) for a in (temp, nd, ne)]


@pytest.mark.parametrize("direction", [1.0, -1.0])
def test_one_ulp_of_log_moves_coolin_past_the_parity_rtol(monkeypatch,
                                                          direction):
    """coolin with its log(T) one ulp up (or down): the largest relative
    change exceeds the parity test's rtol 1e-12 and stays below 1e-11; it
    is at a temperature where the table rises more than three decades
    between the two nodes it interpolates."""
    cfg = pconfig.test_problem_config(mesh=16, dtype="float64",
                                      isothermal=False)
    cool = pt.setup_cool(cfg, device="cpu")
    temp, nd, ne = _inputs()
    base = pt.coolin(cool, nd, ne, temp)
    log = torch.log

    def log_next(x):
        y = log(x)
        return torch.nextafter(y, torch.full_like(y, direction * np.inf))

    monkeypatch.setattr(pt.torch, "log", log_next)
    moved = pt.coolin(cool, nd, ne, temp)
    monkeypatch.setattr(pt.torch, "log", log)
    rel = ((moved - base).abs() / base.abs()).numpy()
    worst = int(np.argmax(rel))
    assert 1e-12 < rel[worst] < 1e-11
    tpos = (np.log10(float(temp[worst])) - cool.mintemp) / cool.dtemp + 1.0
    i = int(np.floor(tpos))
    table = cool.cie_cool.numpy()
    assert table[i] / table[i - 1] > 1e3
