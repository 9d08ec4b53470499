"""Carry the reference's inputs across: configuration, rate tables and
the cooling table.

The system has no learned weights; what both packages must share is the
run configuration and the tables.  The tests build both from these
so the JAX package and the port see identical inputs.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import CosmologyParams, RunConfig, SEDConfig
from .ops.tables import RadTables
from .ops.thermal import CoolingTable


def config_from_dict(d: Mapping) -> RunConfig:
    """The port's RunConfig from dataclasses.asdict() of a JAX RunConfig,
    nested SED and cosmology included."""
    d = dict(d)
    d["sed"] = SEDConfig(**d["sed"])
    d["cosmo"] = CosmologyParams(**d["cosmo"])
    d["mesh"] = tuple(int(m) for m in d["mesh"])
    for key in ("phot_per_atom", "zeta"):
        d[key] = tuple(d[key])
    return RunConfig(**d)


def tables_from_numpy(arrays: Mapping[str, np.ndarray], device,
                      dtype=None) -> RadTables:
    """The port's RadTables from the JAX RadTables fields as numpy
    arrays (missing fields stay None); dtype None keeps each array's."""
    fields = {}
    for name in RadTables._fields:
        a = arrays.get(name)
        if a is None:
            continue
        t = torch.from_numpy(np.array(a, copy=True, order="C"))
        fields[name] = t.to(device=torch.device(device), dtype=dtype)
    return RadTables(**fields)


def cooling_from_numpy(arrays: Mapping, device, dtype=None) -> CoolingTable:
    """The port's CoolingTable from the JAX CoolingTable's fields
    (cie_cool as a numpy array, mintemp and dtemp); dtype None keeps the
    array's."""
    cie = torch.from_numpy(np.array(arrays["cie_cool"], copy=True,
                                    order="C"))
    return CoolingTable(cie.to(device=torch.device(device), dtype=dtype),
                        float(arrays["mintemp"]), float(arrays["dtemp"]))
