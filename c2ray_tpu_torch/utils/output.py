"""Output streams and photon-count files (PyTorch port of
c2ray_tpu/utils/output.py; output.F90): the five togglable streams
(default mask 0,1,1,0,0, output.F90:47) and the PhotonCounts.out /
PhotonCounts2.out conservation audit.  The writers take torch tensors on
any device (or numpy arrays) and write the same bytes as the JAX twin's
for the same values: cubes stream to the file in z-blocks of 32 planes,
and the audit sums in float64 over the same blocks.

Under a parallel layout (parallel/layout.py) every rank calls every
writer: a grid held as slabs is gathered block by block (collectives),
and only the I/O rank (io_enabled) opens and writes files, as the
reference writes on rank 0 only (output.F90:179).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import RunConfig
from ..models.nbody import fortran_f6_3
from ..ops.photonstats import PhotonStatistics
from ..parallel.layout import to_host, z_chunks
from .io_fortran import write_sm3d_stream, write_unformatted_records


@dataclass
class OutputWriter:
    """Per-run output manager (module output_module equivalent)."""

    cfg: RunConfig
    results_dir: str = "./results/"
    streams: tuple = (0, 1, 1, 0, 0)      # output.F90:47
    # a parallel.layout.LayoutRuntime whose slabs the writers gather, and
    # False on every rank but the I/O rank (no files opened or written)
    layout: Optional[object] = None
    io_enabled: bool = True
    _pc1: Optional[object] = None
    _pc2: Optional[object] = None

    def setup(self) -> None:
        """setup_output (output.F90:61-120): open the photon-count files
        and write their headers."""
        if not self.io_enabled:
            return
        os.makedirs(self.results_dir, exist_ok=True)
        self._pc1 = open(os.path.join(self.results_dir, "PhotonCounts.out"),
                         "a")
        self._pc1.write(
            " Columns: redshift, total number of photons used on the grid, "
            "total number of photons produced on the grid, photon "
            "conservation number, fraction new ionization, fraction "
            "recombinations, fraction LLS losses, fraction photon losses, "
            "fraction collisional ionization, grand total photon "
            "conservation number\n")
        self._pc2 = open(os.path.join(self.results_dir, "PhotonCounts2.out"),
                         "a")
        self._pc2.write(
            " Columns: redshift, total number of ions, grand total ionizing "
            "photons, mean ionization fraction (by volume and mass)\n")

    def close_down(self) -> None:
        """output.F90:126-139."""
        for f in (self._pc1, self._pc2):
            if f is not None:
                f.close()
        self._pc1 = self._pc2 = None

    # ------------------------------------------------------------------
    def _path(self, base: str, zred: float, ext: str) -> str:
        return os.path.join(self.results_dir,
                            f"{base}{fortran_f6_3(zred)}{ext}")

    def write_stream1(self, zred, x_coords, x1_line, t_line, nd_line):
        """Axis profile through the first source (output.F90:229-280),
        from the 1-D lines through the source's row."""
        x1_line, nd_line = self._host(x1_line), self._host(nd_line)
        t_line = self._host(t_line) if t_line is not None else None
        if not self.io_enabled:
            return
        with open(self._path("Ifront1_", zred, ".dat"), "w") as f:
            for i in range(self.cfg.mesh[0]):
                x1 = float(x1_line[i])
                t = float(t_line[i]) if t_line is not None else \
                    self.cfg.initial_temperature
                f.write(f"{x_coords[i]:10.3e} {1.0 - x1:10.3e} {x1:10.3e} "
                        f"{t:10.3e} {float(nd_line[i]):10.3e}\n")

    def _host(self, x) -> np.ndarray:
        """A line or plane on the host, gathered first when it is a slab
        of the layout (a collective)."""
        return to_host(self.layout.whole(x) if self.layout is not None
                       else x)

    def _write_cube(self, path, arr, dtype):
        chunks = z_chunks(arr, layout=self.layout)
        if self.io_enabled:
            write_sm3d_stream(path, tuple(self.cfg.mesh), dtype, chunks)
        else:
            for _ in chunks:        # join the gathers; rank 0 writes
                pass

    def write_stream2(self, zred, xh1, temper=None):
        """Full ionization cube, dp (+ temperature cube, sp)
        (output.F90:285-337)."""
        self._write_cube(self._path("xfrac3D_", zred, ".bin"), xh1,
                         np.float64)
        if temper is not None and not self.cfg.isothermal:
            self._write_cube(self._path("Temper3D_", zred, ".bin"), temper,
                             np.float32)

    def write_stream3(self, zred, phih, phiheat=None):
        """Ionization (+ heating) rate cubes, sp (output.F90:342-390)."""
        self._write_cube(self._path("IonRates3D_", zred, ".bin"), phih,
                         np.float32)
        if phiheat is not None and not self.cfg.isothermal:
            self._write_cube(self._path("HeatRates3D_", zred, ".bin"),
                             phiheat, np.float32)

    def _midplane_cuts(self, arr):
        n1, n2, n3 = self.cfg.mesh
        yz = (self.layout.row(arr, n1 // 2 - 1) if self.layout is not None
              else arr[n1 // 2 - 1, :, :])
        return [("xy", np.asarray(self._host(arr[:, :, n3 // 2 - 1]),
                                  np.float32)),
                ("xz", np.asarray(self._host(arr[:, n2 // 2 - 1, :]),
                                  np.float32)),
                ("yz", np.asarray(to_host(yz), np.float32))]

    def _write_cuts(self, base, zred, arr):
        cuts = self._midplane_cuts(arr)
        if not self.io_enabled:
            return
        for name, plane in cuts:
            hdr = np.asarray(plane.shape, np.int32).tobytes()
            write_unformatted_records(self._path(f"{base}{name}_", zred,
                                                 ".bin"),
                                      [hdr, plane.tobytes(order="F")])

    def write_stream4(self, zred, xh1):
        """Midplane ionization slices (output.F90:395-454)."""
        self._write_cuts("Ifront2_", zred, xh1)

    def write_stream5(self, zred, ndens):
        """Midplane density slices (output.F90:459-501)."""
        self._write_cuts("ndens_", zred, ndens)

    # ------------------------------------------------------------------
    def write_photonstatistics(self, zred: float, time: float, dt: float,
                               stats: PhotonStatistics,
                               photon_loss: float, lls_loss: float,
                               total_flux_s_star: float,
                               ndens, xh1, vol: float) -> int:
        """PhotonCounts / PhotonCounts2 rows and the conservation-violation
        flag (write_photonstatistics, output.F90:506-606): 1 when photons
        went missing beyond 15% not explained by the grid loss
        (:588-598)."""
        cfg = self.cfg
        s_star = cfg.sed.s_star
        n_cells = cfg.n_cells
        total_photon_loss = photon_loss * s_star * dt  # already a grid total
        total_lls_loss = lls_loss * s_star * dt
        totalsrc = total_flux_s_star * s_star * dt
        # the .out file uses the no-LLS variant (output.F90:546-547)
        photcons = ((stats.total_ion - stats.totcollisions) / totalsrc
                    if totalsrc > 0 else 1.0)
        ti = stats.total_ion if stats.total_ion != 0.0 else 1.0
        gr = (stats.grtotal_ion / stats.grtotal_src
              if stats.grtotal_src > 0 else 0.0)
        if self._pc1 is not None and time > 0.0:
            self._pc1.write(
                f"{zred:6.3f}" + "".join(
                    f"{v:10.3E}" for v in (
                        stats.total_ion, totalsrc, photcons,
                        stats.dh0 / ti, stats.totrec / ti,
                        total_lls_loss / totalsrc if totalsrc else 0.0,
                        total_photon_loss / totalsrc if totalsrc else 0.0,
                        stats.totcollisions / ti, gr)) + "\n")
            self._pc1.flush()

        # float64 partial sums per z-block (a whole-cube float32 sum
        # drifts at ~1e9 cells), in the JAX twin's blocks and order
        ndx = sx = snd = 0.0
        for nd_b, x_b in zip(z_chunks(ndens, layout=self.layout),
                             z_chunks(xh1, layout=self.layout)):
            nd64 = np.asarray(nd_b, np.float64)
            x64 = np.asarray(x_b, np.float64)
            ndx += float((nd64 * x64).sum())
            sx += float(x64.sum())
            snd += float(nd64.sum())
        totions = ndx * vol
        volfrac = sx / n_cells
        massfrac = ndx / snd
        if self._pc2 is not None:
            self._pc2.write(f"{zred:6.3f}" + "".join(
                f"{v:10.3E}" for v in (totions, stats.grtotal_src,
                                       volfrac, massfrac)) + "\n")
            self._pc2.flush()

        flag = 0
        if time > 0.0 and abs(1.0 - photcons) > 0.15:
            if (1.0 - photcons) > 0.15 and \
                    (total_photon_loss / totalsrc if totalsrc else 0.0) \
                    < (1.0 - photcons):
                flag = 1
        return flag
