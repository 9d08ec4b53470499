"""c2ray_tpu_torch: the PyTorch and CUDA port of c2ray_tpu, for one
NVIDIA H100.

The JAX package c2ray_tpu stays the reference; this package imports none
of it.  Its entry points run on CUDA unless the caller passes
device="cpu", where the hand-written CUDA kernels (ops/sweep_cuda.py,
ops/window_cuda.py, csrc/) give way to their plain PyTorch versions.  It
runs Evolve3D.evolve3d on one device, isothermal or non-isothermal
(photo-heating and the subcycled thermal integration; pass
cool=ops.thermal.setup_cool(cfg)), with full-radius sweeps or the
adaptive windowed many-source sweep; LLS off or of type 1 (a column per
cell), 2 (a column cube) or 3 (the R_max barrier), which set_lls and
set_lls_device set up per redshift; and X-ray sources (evolve3d's
nflux_xray).  Compressed storage, the clumping models, the command-line
run and its I/O, and the multi-device layouts are not ported yet
(ROADMAP.md).
"""

from .config import (CosmologyParams, RunConfig, SEDConfig,
                     test_problem_config)
from .state import (GridState, MaterialState, initial_state,
                    mean_baryon_density, proper_fields, uniform_material)
from .models.lls import LLSState, set_lls, set_lls_device
from .solver import Evolve3D, EvolveInfo

__version__ = "0.1.0"
