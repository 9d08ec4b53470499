"""Command-line run: python -m c2ray_tpu_torch [input_file] [options].

The JAX package's command line (python -m c2ray_tpu), flag for flag,
with --device (default cuda; there is no fallback to the CPU, so a run
without a card needs --device cpu).  The run configuration comes from an
input file given as the first argument, or from stdin
(C2Ray.F90:115-127).

The parallel layouts (--layout src|dom|halo, --shard-sources,
--src-devices, --dom-devices; parallel/layout.py) run one process per
rank, each started with the same command line and the C2RAY_*
environment (parallel/multihost.py):

    C2RAY_COORDINATOR=localhost:29500 C2RAY_NUM_PROCESSES=2 \
    C2RAY_PROCESS_ID=0 python -m c2ray_tpu_torch in.txt --layout halo &
    ... C2RAY_PROCESS_ID=1 ...

Rank r runs on cuda:{r % cards} (or --device cpu), over nccl when every
rank has a card of its own, else over gloo (C2RAY_BACKEND overrides).
"""

from __future__ import annotations

import argparse
import sys


def build_driver(argv=None):
    """Parse a command line and set its run up.  -> (C2RayDriver, the
    --max-slices count); main runs it."""
    ap = argparse.ArgumentParser(
        prog="c2ray_tpu_torch",
        description="C2-Ray reionization radiative transfer, PyTorch and "
                    "CUDA on one device")
    ap.add_argument("input_file", nargs="?", default=None,
                    help="run-parameter file in the reference's ordered "
                         "input protocol (see inputs/input_example_test)")
    ap.add_argument("--nbody", default="test",
                    choices=["test", "cubep3m", "LG", "pmfast", "gadget"])
    ap.add_argument("--mesh", type=int, default=64)
    ap.add_argument("--boxsize", type=float, default=100.0,
                    help="comoving box size in Mpc/h")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--isothermal", action="store_true", default=True)
    ap.add_argument("--non-isothermal", dest="isothermal",
                    action="store_false")
    ap.add_argument("--source-dir", default="./")
    ap.add_argument("--results-dir", default="./results/")
    ap.add_argument("--n-box", type=int, default=-1)
    ap.add_argument("--dens-dir", default="")
    ap.add_argument("--id-str", default="coarsest")
    ap.add_argument("--max-slices", type=int, default=None)
    ap.add_argument("--redshift-file", default=None,
                    help="override the input file's redshift list "
                         "(required for multi-snapshot gadget runs)")
    ap.add_argument("--shard-sources", action="store_true",
                    help="shard sources over all ranks (equivalent to "
                         "--layout src)")
    # runtime parallel layout (the reference's link-time parallel modes,
    # makefile_core:40-104, chosen at run time)
    ap.add_argument("--layout", default="none",
                    choices=["none", "src", "dom", "halo"],
                    help="parallel layout: src = source sharding "
                         "(replicated grid + summed rates, the reference's "
                         "MPI layout), dom = slab-sharded rate physics, "
                         "halo = fully domain-decomposed grid (meshes "
                         "beyond one card's memory)")
    ap.add_argument("--src-devices", type=int, default=0,
                    help="ranks on the source axis (0 = auto)")
    ap.add_argument("--dom-devices", type=int, default=0,
                    help="ranks on the domain axis (0 = auto)")
    # physics model selection (the reference's compile-time knobs in
    # c2ray_parameters.f90:69-99, all runtime here)
    ap.add_argument("--type-of-clumping", type=int, default=1,
                    choices=[1, 2, 3, 4, 5],
                    help="sub-grid clumping model (clumping_module.F90)")
    ap.add_argument("--clumping-factor", type=float, default=1.0,
                    help="constant clumping factor (type 1)")
    ap.add_argument("--clump-dir", default="../",
                    help="directory with paramsGCM/DCM/SCM_<res>Mpc.dat "
                         "(types 2-4) or <z>_scat.dat cubes (type 5)")
    ap.add_argument("--type-of-lls", type=int, default=0,
                    choices=[0, 1, 2, 3],
                    help="LLS mechanism; 0 disables LLS (LLS.F90:101-146)")
    ap.add_argument("--lls-model", type=int, default=5,
                    help="mean-free-path model index for type-1 LLS")
    ap.add_argument("--lls-dir", default="",
                    help="directory with <z>cross_section_normalized.bin "
                         "cubes (type-2 LLS)")
    ap.add_argument("--cosmology", default="WMAP3+",
                    choices=["WMAP3+", "WMAP1", "WMAP3", "WMAP5", "EoRKP"],
                    help="cosmological parameter set (cosmoparms*.f90)")
    ap.add_argument("--compressed-xfrac", action="store_true",
                    help="signed min-fraction ionization storage (the "
                         "reference's compressed/ variant)")
    ap.add_argument("--rate-eval", default="auto",
                    choices=["auto", "table", "expsum"],
                    help="photoionization-rate evaluation path (table "
                         "rates run on the CPU only)")
    ap.add_argument("--sweep-backend", default="facemajor",
                    choices=["facemajor", "grid", "pallas"],
                    help="the JAX package's march backend; the port has one "
                         "march and records the choice only")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cuda, or cpu for the "
                         "plain PyTorch versions of the kernels); under a "
                         "layout rank r takes cuda:{r %% cards}")
    args = ap.parse_args(argv)

    from .config import COSMOLOGY_SETS, test_problem_config
    from .driver import (C2RayDriver, DriverConfig, read_input_file,
                         read_input_stdin)
    from .models.nbody import (cubep3m_adapter, gadget_adapter, lg_adapter,
                               pmfast_adapter, test_adapter)
    from .parallel import multihost
    from .parallel.layout import ParallelLayout

    # the rank's device: cuda (cuda:{rank % cards} under a layout, raising
    # without a card) unless --device names another; then the process
    # group, a no-op without the C2RAY_* environment (mpi.F90:83-178)
    device = multihost.rank_device(args.device)
    multihost.init_distributed(device=device)
    cfg = test_problem_config(mesh=args.mesh, boxsize_mpc_h=args.boxsize,
                              dtype=args.dtype, isothermal=args.isothermal,
                              type_of_clumping=args.type_of_clumping,
                              clumping_factor=args.clumping_factor,
                              use_lls=args.type_of_lls > 0,
                              type_of_lls=max(args.type_of_lls, 1),
                              lls_model=args.lls_model,
                              cosmo=COSMOLOGY_SETS[args.cosmology],
                              compressed_xfrac=args.compressed_xfrac,
                              rate_eval=args.rate_eval,
                              sweep_backend=args.sweep_backend)

    if args.input_file:
        dc = read_input_file(args.input_file, args.nbody)
    elif not sys.stdin.isatty():
        # no input file: the ordered answers from stdin, the reference's
        # interactive protocol (C2Ray.F90:115-127)
        dc = read_input_stdin(args.nbody)
    else:
        dc = DriverConfig()
    dc.results_dir = args.results_dir
    if args.redshift_file:
        dc.redshift_file = args.redshift_file

    if args.nbody == "test":
        adapter = test_adapter(cfg, source_dir=args.source_dir)
    elif args.nbody == "cubep3m":
        adapter = cubep3m_adapter(cfg, args.boxsize, args.n_box,
                                  dc.redshift_file, id_str=args.id_str,
                                  dir_dens=args.dens_dir,
                                  dir_src=args.source_dir)
    elif args.nbody == "LG":
        adapter = lg_adapter(cfg, args.boxsize, args.n_box,
                             dc.redshift_file,
                             dir_dens=args.dens_dir,
                             dir_src=args.source_dir)
    elif args.nbody == "pmfast":
        adapter = pmfast_adapter(cfg, args.boxsize, args.n_box,
                                 dc.redshift_file,
                                 dir_dens=args.dens_dir,
                                 dir_src=args.source_dir)
    else:
        zr = ([dc.zred_initial] if dc.zred_initial >= 0
              and not dc.redshift_file else None)
        adapter = gadget_adapter(cfg, args.boxsize, dc.redshift_file,
                                 dir_dens=args.dens_dir,
                                 dir_src=args.source_dir, zred_array=zr)

    adapter.dir_clump = args.clump_dir
    adapter.dir_lls = args.lls_dir

    kind = ("src" if (args.shard_sources and args.layout == "none")
            else args.layout)
    layout = ParallelLayout(kind=kind, n_src=args.src_devices,
                            n_dom=args.dom_devices)
    return (C2RayDriver(cfg, adapter=adapter, driver_cfg=dc, device=device,
                        layout=layout),
            args.max_slices)


def main(argv=None):
    driver, max_slices = build_driver(argv)
    driver.run(max_slices=max_slices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
