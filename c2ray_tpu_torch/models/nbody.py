"""N-body problem adapters (a numpy copy of c2ray_tpu/models/nbody.py).

Runtime equivalents of the reference's compile-time-selected nbody
modules (nbody_test.F90, nbody_cubep3m.F90, nbody_LG.F90,
nbody_pmfast.F90, nbody_gadget.F90): redshift lists, box/N-body sizes,
mass units, density/source/clumping/LLS file naming and formats.  The
JAX twin's per-slab readers serve only its multi-device layouts and are
not copied.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .. import constants as const
from ..config import RunConfig
from ..utils.io_fortran import read_stream_cube, read_stream_cube_slab
from .sources import read_source_file


def fortran_f6_3(z: float) -> str:
    """Fortran '(f6.3)' + adjustl formatting used in all file names."""
    return f"{z:6.3f}".strip()


def read_density_cube_numpy(path: str, mesh, header: bool,
                            conv: float) -> np.ndarray:
    """The plain version of read_density's native read (numpy): the
    float32 cube times conv in float64, 0.1 * conv where that is <= 0,
    stored float32."""
    raw = read_stream_cube(path, mesh, np.float32, header=header)
    nd = raw.astype(np.float64) * conv
    nd[nd <= 0.0] = 0.1 * conv
    return nd.astype(np.float32)


@dataclass
class NbodyAdapter:
    """Base adapter: geometry + units + file naming.

    boxsize in Mpc/h comoving; n_box = N-body fine-mesh cells per side.
    M_grid = mean mass per N-body cell (nbody_cubep3m.F90:122-124).
    """

    cfg: RunConfig
    nbody_type: str = "test"
    boxsize: float = 100.0
    n_box: int = -1
    id_str: str = "test"
    dir_dens: str = ""
    dir_src: str = "./"
    dir_clump: str = "../"
    dir_lls: str = ""
    density_unit: str = "none"
    density_header: bool = True
    zred_array: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @property
    def num_zred(self) -> int:
        return len(self.zred_array)

    @property
    def m_box(self) -> float:
        c = self.cfg.cosmo
        return c.rho_crit_0 * c.omega0 * (self.boxsize * const.MPC / c.h) ** 3

    @property
    def m_grid(self) -> float:
        if self.n_box <= 0:
            return 0.0
        return self.m_box / float(self.n_box) ** 3

    # ------------------------------------------------------------------
    def density_filename(self, redshift: float, nz: int) -> str:
        """construct_densfilename (density_module.F90:151-199)."""
        zs = fortran_f6_3(redshift)
        if self.nbody_type == "cubep3m":
            return os.path.join(self.dir_dens, f"{zs}n_all.dat")
        if self.nbody_type == "pmfast":
            return os.path.join(self.dir_dens, f"{zs}rho_{self.id_str}.dat")
        if self.nbody_type == "LG":
            ns = f"{nz + 1:03d}"
            if self.id_str != "dmdens_cic":
                return os.path.join(self.dir_dens, f"{ns}rho_{self.id_str}.dat")
            return os.path.join(self.dir_dens, f"{ns}{self.id_str}.dat")
        if self.nbody_type == "gadget":
            return os.path.join(self.dir_dens, f"{zs}rho_gadget.dat")
        raise ValueError(f"no density files for nbody type {self.nbody_type}")

    def source_filename(self, redshift: float, nz: int,
                        suffix: str = "_sources.dat") -> str:
        """construct_sourcefilename (sourceprops.F90:213-255).

        The reference's select-case covers cubep3m/LG/test only and
        leaves pmfast/gadget UNDEFINED (a latent bug there); here they
        get the redshift-stamped cubep3m convention so the adapters are
        actually usable - falling through to test_sources.dat would
        silently read the wrong catalog every slice.
        """
        if self.nbody_type in ("cubep3m", "pmfast", "gadget"):
            return os.path.join(
                self.dir_src, f"{fortran_f6_3(redshift)}-{self.id_str}{suffix}")
        if self.nbody_type == "LG":
            return os.path.join(self.dir_src,
                                f"{nz + 1:03d}-{self.id_str}{suffix}")
        return os.path.join(self.dir_src, "test_sources.dat")

    # ------------------------------------------------------------------
    def density_conversion(self, redshift: float) -> float:
        """Unit conversion to comoving cm^-3, including the (1+z)^3 factor
        for cosmological runs (scale_density, density_module.F90:247-286)."""
        cfg = self.cfg
        c = cfg.cosmo
        mesh3 = float(np.prod(cfg.mesh))
        grid = (c.rho_crit_0 * c.omega_b / (const.MU * const.M_P)
                * mesh3 / float(self.n_box) ** 3) if self.n_box > 0 else 1.0
        conv = {
            "grid": grid,
            "particle": 8.0 * grid,
            "M0Mpc3": (const.M_SOLAR / const.MPC**3 * c.h**2 * c.omega_b
                       / c.omega0 / (const.MU * const.M_P)),
            "mass_density": 1.0 / (const.MU * const.M_P),
            "none": 1.0,
        }[self.density_unit]
        if cfg.cosmological:
            conv *= (1.0 + redshift) ** 3
        return conv

    def read_density(self, redshift: float, nz: int) -> np.ndarray:
        """Read + unit-scale a density slice to *proper* cm^-3 at its
        redshift (set_density path, density_module.F90:82-125).
        Empty cells are floored at 0.1 particles (:281).  Through the
        native reader (c2ray_tpu_torch.native, as the JAX twin's): the
        product taken in float64 and stored float32."""
        from .. import native

        path = self.density_filename(redshift, nz)
        conv = self.density_conversion(redshift)
        nd = native.read_cube_f32(path, self.cfg.mesh,
                                  header=self.density_header, conv=conv,
                                  floor_val=0.1 * conv)
        return nd.astype(self.cfg.np_dtype)

    def read_density_slab(self, redshift: float, nz: int, row0: int,
                          nrows: int) -> np.ndarray:
        """read_density's grid-axis-0 rows [row0, row0+nrows) only, by a
        seek into the cube: the halo layout's per-rank read (the JAX
        read_density_slab), with the same arithmetic."""
        path = self.density_filename(redshift, nz)
        conv = self.density_conversion(redshift)
        raw = read_stream_cube_slab(path, self.cfg.mesh, np.float32, row0,
                                    nrows, header=self.density_header)
        nd = raw.astype(np.float64) * conv
        nd[nd <= 0.0] = 0.1 * conv
        return nd.astype(np.float32).astype(self.cfg.np_dtype)

    def read_sources(self, redshift: float, nz: int) -> np.ndarray:
        return read_source_file(self.source_filename(redshift, nz))

    # ------------------------------------------------------------------
    def clumping_filename(self, redshift: float) -> str:
        """Bianco et al. 2020 sub-grid clumping cube name
        (read_clumping_file, clumping_module.F90:455-458)."""
        return os.path.join(self.dir_clump,
                            f"{fortran_f6_3(redshift)}_scat.dat")

    def read_clumping_grid(self, redshift: float) -> np.ndarray:
        """Precomputed per-cell clumping grid (type_of_clumping=5;
        clumping_module.F90:442-487: stream access, int32 mesh header,
        f32 data)."""
        return read_stream_cube(self.clumping_filename(redshift),
                                self.cfg.mesh, np.float32,
                                header=True).astype(self.cfg.np_dtype)

    def read_clumping_grid_slab(self, redshift: float, row0: int,
                                nrows: int) -> np.ndarray:
        """read_clumping_grid's rows [row0, row0+nrows) (halo layout)."""
        return read_stream_cube_slab(
            self.clumping_filename(redshift), self.cfg.mesh, np.float32,
            row0, nrows, header=True).astype(self.cfg.np_dtype)

    def lls_filename(self, redshift: float) -> str:
        """LLS.F90:239-242."""
        return os.path.join(
            self.dir_lls,
            f"{fortran_f6_3(redshift)}cross_section_normalized.bin")

    def read_lls_grid(self, redshift: float) -> np.ndarray:
        """Normalized LLS cross-section cube (type_of_lls=2;
        read_LLS_grid, LLS.F90:214-316: stream access, int32 mesh
        header, f32 data).  The conversion to per-cell column densities
        happens in models.lls.set_lls."""
        return read_stream_cube(self.lls_filename(redshift),
                                self.cfg.mesh, np.float32,
                                header=True).astype(np.float64)

    def read_lls_grid_slab(self, redshift: float, row0: int,
                           nrows: int) -> np.ndarray:
        """read_lls_grid's rows [row0, row0+nrows) (halo layout)."""
        return read_stream_cube_slab(self.lls_filename(redshift),
                                     self.cfg.mesh, np.float32, row0,
                                     nrows, header=True).astype(np.float64)


def test_adapter(cfg: RunConfig, num_zred: int = 15,
                 zred_start: float = 9.0,
                 slice_time: float = 1e7 * const.YEAR,
                 source_dir: str = "./") -> NbodyAdapter:
    """The self-contained test problem (nbody_test.F90): 100/h Mpc box,
    `num_zred` slices starting at z=9 spaced `slice_time` apart
    (nbody_test.F90:212-251)."""
    c = cfg.cosmo
    t0 = 2.0 * (1.0 + zred_start) ** (-1.5) / (3.0 * c.H0 * np.sqrt(c.omega0))
    nz = np.arange(num_zred)
    zreds = -1.0 + (1.0 + zred_start) * (t0 / (t0 + nz * slice_time)) ** (2.0 / 3.0)
    return NbodyAdapter(cfg=cfg, nbody_type="test", boxsize=cfg.boxsize_mpc_h,
                        id_str="test", dir_src=source_dir, zred_array=zreds)


def cubep3m_adapter(cfg: RunConfig, boxsize: float, n_box: int,
                    redshift_file: str, id_str: str = "coarsest",
                    dir_dens: str = "", dir_src: str = "",
                    density_unit: str = "grid") -> NbodyAdapter:
    """CubeP3M simulation adapter (nbody_cubep3m.F90): redshift list from
    file (first line count, one z per line, :226-261)."""
    with open(redshift_file) as f:
        n = int(f.readline().split()[0])
        zreds = np.array([float(f.readline().split()[0]) for _ in range(n)])
    return NbodyAdapter(cfg=cfg, nbody_type="cubep3m", boxsize=boxsize,
                        n_box=n_box, id_str=id_str, dir_dens=dir_dens,
                        dir_src=dir_src, density_unit=density_unit,
                        zred_array=zreds)


def lg_adapter(cfg: RunConfig, boxsize: float, n_box: int,
               redshift_file: str, id_str: str = "dmdens_cic",
               dir_dens: str = "", dir_src: str = "",
               density_unit: str = "M0Mpc3") -> NbodyAdapter:
    """Local Group (CLUES) simulation adapter (nbody_LG.F90): snapshot
    counters in file names, M_sun/Mpc^3 density units (nbody_LG.F90:91).
    The redshift file carries (snapshot, z) pairs (nbody_LG.F90:219-221)."""
    with open(redshift_file) as f:
        n = int(f.readline().split()[0])
        zreds = np.array([float(f.readline().split()[1]) for _ in range(n)])
    return NbodyAdapter(cfg=cfg, nbody_type="LG", boxsize=boxsize,
                        n_box=n_box, id_str=id_str, dir_dens=dir_dens,
                        dir_src=dir_src, density_unit=density_unit,
                        zred_array=zreds)


def pmfast_adapter(cfg: RunConfig, boxsize: float, n_box: int,
                   redshift_file: str, id_str: str = "coarse",
                   dir_dens: str = "", dir_src: str = "",
                   density_unit: str = "grid") -> NbodyAdapter:
    """PMFAST simulation adapter (nbody_pmfast.F90).  Density cubes are
    headerless (densityheader=.false., nbody_pmfast.F90:94)."""
    with open(redshift_file) as f:
        n = int(f.readline().split()[0])
        zreds = np.array([float(f.readline().split()[0]) for _ in range(n)])
    return NbodyAdapter(cfg=cfg, nbody_type="pmfast", boxsize=boxsize,
                        n_box=n_box, id_str=id_str, dir_dens=dir_dens,
                        dir_src=dir_src, density_unit=density_unit,
                        density_header=False, zred_array=zreds)


def gadget_adapter(cfg: RunConfig, boxsize: float,
                   redshift_file: str = "", dir_dens: str = "",
                   dir_src: str = "",
                   density_unit: str = "mass_density",
                   zred_array=None) -> NbodyAdapter:
    """GADGET simulation adapter (nbody_gadget.F90).

    The reference's input protocol gives ONE initial redshift
    (nbody_gadget.F90:204-227); pass it as zred_array=[z, ...].  A
    redshift file (count + one z per line) is also accepted for
    multi-snapshot runs.
    """
    if zred_array is None:
        with open(redshift_file) as f:
            n = int(f.readline().split()[0])
            zred_array = [float(f.readline().split()[0]) for _ in range(n)]
    zreds = np.asarray(zred_array, np.float64)
    return NbodyAdapter(cfg=cfg, nbody_type="gadget", boxsize=boxsize,
                        id_str="gadget", dir_dens=dir_dens, dir_src=dir_src,
                        density_unit=density_unit, zred_array=zreds)
