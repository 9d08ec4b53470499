"""c2ray_tpu_torch: the PyTorch and CUDA port of c2ray_tpu, for one
NVIDIA H100.

The JAX package c2ray_tpu stays the reference; this package imports none
of it.  Its entry points run on CUDA unless the caller passes
device="cpu", where the hand-written CUDA kernels (ops/sweep_cuda.py,
ops/window_cuda.py, csrc/) give way to their plain PyTorch versions.

The command-line run, python -m c2ray_tpu_torch (driver.C2RayDriver),
takes the JAX package's flags and input protocol: the N-body adapters
(models/nbody.py), the source models with suppression and banked photons
(models/sources.py), the clumping models 1-5 (models/clumping.py, types 3
and 4 evaluated on the device), the output streams and PhotonCounts
files (utils/output.py), and slice, mid-slice and iteration-dump
restarts (utils/checkpoint.py).  Underneath it, Evolve3D.evolve3d runs
isothermal or non-isothermal (photo-heating and the subcycled thermal
integration; pass cool=ops.thermal.setup_cool(cfg)), with full-radius
sweeps or the adaptive windowed many-source sweep; LLS off or of type 1
(a column per cell), 2 (a column cube) or 3 (the R_max barrier), which
set_lls and set_lls_device set up per redshift; X-ray sources
(evolve3d's nflux_xray); compressed ionization-fraction storage
(compress_xh, xh1_of, xh0_of) and add_photon_losses.  The parallel
layouts (parallel/: --layout src|dom|halo, one process per rank over
torch.distributed) inject their sweeps and chemistry into Evolve3D.
Every kernel has float32 and float64 builds, and the rate deposition
mixture and table-rate builds, so float64 and rate_eval "table" run on
the card too.  tools.py holds the post-processing tools and native/ the
C++ reader of density cubes and source catalogs.
"""

from .config import (CosmologyParams, RunConfig, SEDConfig,
                     test_problem_config)
from .state import (GridState, MaterialState, compress_xh, initial_state,
                    mean_baryon_density, proper_fields, uniform_material,
                    xh0_of, xh1_of)
from .models.lls import LLSState, set_lls, set_lls_device
from .solver import Evolve3D, EvolveInfo
from .driver import (C2RayDriver, DriverConfig, parse_input_answers,
                     read_input_file, read_input_stdin)

__version__ = "0.1.0"
