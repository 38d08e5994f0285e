"""neutral_tpu_torch — the PyTorch and CUDA port of `neutral_tpu`.

Monte Carlo neutral-particle transport for one NVIDIA H100: the same
decks, RNG streams and physics as the JAX package, with its Pallas kernels
rewritten as hand-written CUDA kernels: the fused event sweep
(csrc/sweep.cu), the free-flight pieces (csrc/flight.cu) and the segment
deposit (csrc/raster.cu), and each census started by one more
(csrc/begin.cu, JAX's jitted begin_timestep).  The package imports torch
and never JAX or `neutral_tpu`.
"""

__version__ = "0.1.0"

from . import constants  # noqa: F401
from .config import SimConfig, SourceBox, ProblemRegion, load_config  # noqa: F401
from .mesh import Mesh2D, build_mesh  # noqa: F401
from .xs import CrossSection  # noqa: F401
from .particles import (ParticleState, inject_particles,  # noqa: F401
                        state_from_numpy, state_to_numpy)
from .transport import Geometry, begin_timestep, run_timestep  # noqa: F401
from .sweep_kernel import sweep_chunk_plain  # noqa: F401
from .flight import flight_chunk_plain  # noqa: F401
from .census import flight_chunk_kernel, sweep_chunk_kernel  # noqa: F401
from .driver import Simulation  # noqa: F401
