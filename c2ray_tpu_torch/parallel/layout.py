"""The parallel layouts the driver runs, selected at run time (the
reference's link-time parallel modes, makefile_core:40-104): the port of
c2ray_tpu/parallel/layout.py over torch.distributed.

  none  one process, one device.
  src   the sources dealt over the ranks, the grid whole on every rank,
        the rate grids summed (source_shard.py): the reference's MPI
        layout.
  dom   an (n_src, n_dom) rank grid: the march whole on every rank, the
        rate pass and the chemistry on the rank's x-slab, the state whole
        (domain.py domain_sharded_raytracer, sharded_chemistry).
  halo  every O(N^3) field, state and material included, an (m, n, n)
        x-slab of its rank, the march with a ring exchange per shell
        (ops/sweep_sharded.py): the layout for meshes beyond one card.

LayoutRuntime builds the rank grid and the injections Evolve3D takes
(raytracer, chemistry, windowed, rate_sharding), reads slabs (each rank
reads only its own rows, make_sharded) and gathers grids for the writers
(z_chunks, line, plane: collectives every rank joins; rank 0 writes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from . import multihost as mh


@dataclass
class ParallelLayout:
    """Run-time layout selection (CLI: --layout, --src-devices,
    --dom-devices)."""

    kind: str = "none"          # none | src | dom | halo
    n_src: int = 0              # ranks on the source axis (0: auto)
    n_dom: int = 0              # ranks on the domain axis (0: auto)


class SlabSharding:
    """The rate grids of the dom and halo layouts are x-slabs: rows
    (x0, m) of the grid on this rank.  state=True (halo): the state and
    the material are slabs too, so a sum over the grid is a sum over the
    dom ring (grid_sum).  Evolve3D's rate_sharding."""

    def __init__(self, grid, rows, state: bool):
        self.grid = grid
        self.rows = rows
        self.state = state

    def grid_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the whole grid of per-slab sums t."""
        return self.grid.sum(t, "dom") if self.state else t


class LayoutRuntime:
    """Rank grid, injections and slab I/O of one layout."""

    def __init__(self, cfg, layout: ParallelLayout, device):
        self.cfg = cfg
        self.kind = layout.kind
        self.device = torch.device(device)
        self.grid = None
        self.raytracer = None
        self.chemistry = None
        self.windowed = None
        self.rate_sharding: Optional[SlabSharding] = None
        self.rows = None
        world = mh.process_count()
        n = cfg.mesh[0]
        if self.kind == "none":
            if world > 1:
                raise ValueError(f"{world} ranks and no parallel layout: "
                                 "pass --layout src|dom|halo")
            return
        from .domain import slab_rows_of
        if self.kind == "src":
            from .source_shard import (WindowedShardedSweeper,
                                       sharded_raytracer)
            n_src = layout.n_src or world
            self.grid = mh.RankGrid(n_src, 1, self.device)
            self.raytracer = sharded_raytracer(self.grid)
            self.windowed = WindowedShardedSweeper(self.grid)
            return
        if self.kind not in ("dom", "halo"):
            raise ValueError(f"unknown parallel layout {self.kind!r}")
        from .domain import (WindowedHaloSweeper, domain_sharded_raytracer,
                             halo_sharded_raytracer, sharded_chemistry)
        from .source_shard import WindowedShardedSweeper
        n_src = layout.n_src or 1
        n_dom = layout.n_dom or world // n_src
        if n % n_dom:
            raise ValueError(f"mesh {n} not divisible by {n_dom} domain "
                             "devices")
        self.grid = mh.RankGrid(n_src, n_dom, self.device)
        self.rows = slab_rows_of(self.grid, n)
        halo = self.kind == "halo"
        self.raytracer = (halo_sharded_raytracer(self.grid) if halo
                          else domain_sharded_raytracer(self.grid))
        self.chemistry = sharded_chemistry(self.grid, gather=not halo)
        self.rate_sharding = SlabSharding(self.grid, self.rows, state=halo)
        # the dom layout deals its windowed buckets over every rank, as the
        # JAX package does (windows never touch its slab structure)
        self.windowed = (WindowedHaloSweeper(self.grid) if halo
                         else WindowedShardedSweeper(self.grid,
                                                     rows=self.rows))
        # every clumping and LLS model runs under every layout: types 3
        # and 4 evaluate on the slab, type-5 clumping and type-2 LLS cubes
        # are read by slab like the density (driver.py)

    # ------------------------------------------------------------------
    @property
    def sharded_grid(self) -> bool:
        """True when the state and the material are slabs (halo)."""
        return self.kind == "halo"

    def describe(self) -> str:
        if self.grid is None:
            return "layout none, 1 process"
        g = self.grid
        return (f"layout {self.kind}, {g.n_src} x {g.n_dom} ranks "
                f"(rank {g.rank}), backend {g.backend}, device "
                f"{self.device}" + (", staged through the host"
                                    if g.staged else ""))

    def _is_slab(self, x) -> bool:
        n = self.cfg.mesh[0]
        return (self.rows is not None and isinstance(x, torch.Tensor)
                and x.dim() >= 1 and x.shape[0] == self.rows[1]
                and self.rows[1] != n)

    def shard_grid(self, x):
        """A whole (n, n, n) grid as this layout keeps it: the rank's rows
        under halo, as it is otherwise."""
        if x is None or not self.sharded_grid or self._is_slab(x):
            return x
        x0, m = self.rows
        return x[x0:x0 + m]

    def shard_state(self, state):
        return type(state)(*[self.shard_grid(f) for f in state])

    def make_sharded(self, slab_fn: Callable[[int, int], np.ndarray],
                     dtype=None) -> torch.Tensor:
        """A grid built from row reads: slab_fn(row0, nrows) returns the
        C-order (nrows, n, n) rows [row0, row0+nrows).  Under halo each
        rank reads only its own rows; otherwise the whole grid."""
        n = self.cfg.mesh[0]
        dtype = dtype or self.cfg.np_dtype
        x0, m = self.rows if self.sharded_grid else (0, n)
        return torch.as_tensor(np.asarray(slab_fn(x0, m), dtype),
                               device=self.device)

    # ------------------------------------------------------------------
    def whole(self, x):
        """x with its slab axis 0 gathered over the dom ring (a collective
        under dom and halo); as it is when it is not a slab.  For lines
        and planes: cubes go through z_chunks."""
        if not self._is_slab(x):
            return x
        return self.grid.gather(x.contiguous(), "dom")

    def row(self, x, i: int):
        """Row i of grid axis 0 of x on every rank (a collective for a
        slab: the owner's row, summed with the others' zeros)."""
        if not self._is_slab(x):
            return x[i]
        x0, m = self.rows
        r = x[i - x0] if x0 <= i < x0 + m else torch.zeros_like(x[0])
        return self.grid.sum(r, "dom")

    def point_view(self, x):
        """x as models.sources reads cells from it: x itself, or for a
        slab a SlabView."""
        return SlabView(self, x) if self._is_slab(x) else x

    def local_cfg(self):
        """cfg with the mesh of the grids this rank holds (the slab's under
        halo), to build constant fields at that shape."""
        if not self.sharded_grid:
            return self.cfg
        n = self.cfg.mesh[0]
        return self.cfg.replace(mesh=(self.rows[1], n, n))

    def grid_mean(self, x) -> float:
        """The mean of a grid this layout holds, over the whole grid, with
        the same bits under every layout: the x rows' sums (in the grid's
        dtype; gathered in row order from the slabs), added in float64 on
        the host in row order."""
        rows = self.whole(torch.sum(x, dim=(1, 2)))
        total = 0.0
        for v in rows.cpu().tolist():
            total += v
        return total / self.cfg.n_cells

    def z_chunks(self, arr, k_chunk: int = 32) -> Iterator[np.ndarray]:
        """Host (n, n, kc) z-blocks of a grid in ascending z: the form the
        cube writers stream.  A slab's blocks are gathered over the dom
        ring, so every rank must drain the iterator; one block is on the
        host at a time."""
        n3 = arr.shape[2]
        for k0 in range(0, n3, k_chunk):
            yield to_host(self.whole(arr[:, :, k0:k0 + k_chunk]))


class SlabView:
    """A slab read as the whole grid at given cells: cells(pos0) -> the
    values at the (S, 3) global cells on every rank (a collective: the
    owners' values, summed with the others' zeros)."""

    def __init__(self, layout: LayoutRuntime, x: torch.Tensor):
        self.layout, self.x = layout, x

    def cells(self, pos0: np.ndarray) -> np.ndarray:
        x0, m = self.layout.rows
        pos0 = np.asarray(pos0, np.int64)
        own = (pos0[:, 0] >= x0) & (pos0[:, 0] < x0 + m)
        vals = torch.zeros(len(pos0), dtype=self.x.dtype,
                           device=self.x.device)
        if own.any():
            p = torch.as_tensor(pos0[own], device=self.x.device)
            vals[torch.as_tensor(np.nonzero(own)[0], device=self.x.device)] \
                = self.x[p[:, 0] - x0, p[:, 1], p[:, 2]]
        return to_host(self.layout.grid.sum(vals, "dom"))


def to_host(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def replicate_to_host(x, layout: Optional[LayoutRuntime] = None):
    """x on the host, gathered over the dom ring first when it is a slab
    of `layout` (a collective: every rank calls it on the same array)."""
    return to_host(layout.whole(x) if layout is not None else x)


def z_chunks(arr, k_chunk: int = 32,
             layout: Optional[LayoutRuntime] = None) -> Iterator[np.ndarray]:
    """Host (N1, N2, kc) z-blocks of a grid, in ascending z: the form
    write_sm3d_stream takes, one block on the host at a time; a slab of
    `layout` is gathered block by block (LayoutRuntime.z_chunks)."""
    if layout is not None:
        yield from layout.z_chunks(arr, k_chunk)
        return
    n3 = arr.shape[2]
    for k0 in range(0, n3, k_chunk):
        yield to_host(arr[:, :, k0:k0 + k_chunk])
