"""The source-injection kernel (csrc/inject.cu).

Counterpart of `neutral_tpu/particles.py::inject_particles`, a `jax.jit`
function that XLA fuses into one program.  Its plain PyTorch version,
`particles.inject_particles`, runs as a chain of eager operations (each
threefry draw on int64 words several hundred launches);
`inject_particles_kernel` computes the same state in one launch of the
hand-written CUDA kernel, bit for bit: every lane's 14 fields, its
position and cell from the draw at counter 0, its angle from the draw at
counter 1, in the global or the cell-local frame, on a uniform mesh or
any other, for the pids 0..n-1 or for a vector of pids (a decomposition's
shard: the pids born in its block or its range).

The kernel has float32 and float64 instantiations under both draw
schemes.  `inject_particles_kernel` launches the kernel or raises: on a
mesh that does not lie on a CUDA device and on any working type or scheme
the kernel does not implement.  It never runs the plain version.
Every shard (census.new_shard: `Simulation`'s one, and each of a
decomposition's) chooses between the two by engine: the kernel engine
takes the kernel, the plain engine `particles.inject_particles`.
`inject_particles_kernel.launches` counts kernel launches and
`inject_particles_kernel.cards` the launches by card; callers may reset
both.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from . import build
from .mesh import Mesh2D
from .particles import STATE_FIELDS, ParticleState

THREADS = 256              # threads per block (csrc/inject.cu kThreads)
SCHEMES = ("threefry", "pcg64si")   # nt::RngScheme's order
# Each field's type, beside the working type's floats.
INT_FIELDS = {"cellx": torch.int32, "celly": torch.int32,
              "dead": torch.bool, "pid": torch.int64,
              "counter": torch.int64}


def _inject_fields(real) -> list:
    """`InjectParamsT<Real>`'s fields in csrc/inject.cu, its constants of
    the ctypes type `real`."""
    return (
        [(f, ctypes.c_void_p) for f in (*STATE_FIELDS, "edgex", "edgey",
                                        "pid_in")]
        + [("n", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in (
            "blocks", "nx", "ny", "uniform", "local", "rng")]
        + [(f, real) for f in (
            "x0", "y0", "width", "height", "inv_x", "inv_y", "dx", "dy",
            "two_pi", "energy0", "dt")])


class _InjectParams(ctypes.Structure):
    """Mirror of `InjectParams` (float32) in csrc/inject.cu."""
    _fields_ = _inject_fields(ctypes.c_float)


class _InjectParams64(ctypes.Structure):
    """Mirror of `InjectParams64` (float64) in csrc/inject.cu."""
    _fields_ = _inject_fields(ctypes.c_double)


# The parameter layout and entry-point suffix of each working type.
_LAYOUTS = {torch.float32: (_InjectParams, ""),
            torch.float64: (_InjectParams64, "_f64")}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = build.load()
    lib.nt_inject_threads.argtypes = []
    lib.nt_inject_threads.restype = ctypes.c_int
    for cls, sfx in _LAYOUTS.values():
        size = getattr(lib, f"nt_inject_params_size{sfx}")
        size.argtypes, size.restype = [], ctypes.c_int
        launch = getattr(lib, f"nt_inject_launch{sfx}")
        launch.argtypes = [ctypes.POINTER(cls), ctypes.c_void_p]
        launch.restype = ctypes.c_int
        if size() != ctypes.sizeof(cls):
            raise RuntimeError(f"csrc/inject.cu InjectParams{sfx} does not "
                               f"match inject_kernel.{cls.__name__}")
    if lib.nt_inject_threads() != THREADS:
        raise RuntimeError("csrc/inject.cu kThreads does not match "
                           "inject_kernel.THREADS")
    return lib


def check_inject_inputs(mesh: Mesh2D, device, dtype: torch.dtype,
                        rng_scheme: str) -> torch.device:
    """The card of the injection, the mesh's; raise ValueError unless the
    kernel implements it: a float32 or float64 working type, threefry or
    pcg64si draws, the mesh's edges on one CUDA device (the one asked
    for), contiguous, one more than its cells, in the working type."""
    if dtype not in _LAYOUTS:
        raise ValueError(f"inject kernel: no {dtype} instantiation "
                         "(float32 and float64 only)")
    if rng_scheme not in SCHEMES:
        raise ValueError(f"inject kernel: unknown rng scheme {rng_scheme!r}")
    dev = mesh.edgex.device
    asked = torch.device(device) if device is not None else dev
    if asked.type != "cuda" or dev.type != "cuda":
        raise ValueError(f"inject kernel needs CUDA: device {asked}, mesh "
                         f"edges on {dev}")
    if asked.index not in (None, dev.index) or mesh.edgey.device != dev:
        raise ValueError(f"inject kernel: mesh edges on {dev} and "
                         f"{mesh.edgey.device}, injection asked on {asked}")
    for e, cells in ((mesh.edgex, mesh.nx), (mesh.edgey, mesh.ny)):
        if (e.dtype != dtype or tuple(e.shape) != (cells + 1,)
                or not e.is_contiguous()):
            raise ValueError(f"inject kernel: mesh edges must be "
                             f"({cells + 1},) contiguous {dtype}, got "
                             f"{tuple(e.shape)} {e.dtype}")
    return dev


def inject_particles_kernel(mesh: Mesh2D, *, nparticles: int,
                            source_x0: float, source_y0: float,
                            source_width: float, source_height: float,
                            initial_energy: float, dt: float,
                            dtype: torch.dtype = torch.float32,
                            rng_scheme: str = "threefry",
                            local_coords: tuple[float, float] | None = None,
                            device=None, pid: torch.Tensor | None = None
                            ) -> ParticleState:
    """particles.inject_particles in one launch of the CUDA kernel, on the
    mesh's card and its current stream (no wait): the same arguments, the
    same 14 fields, each a fresh tensor.  `pid` (None: 0..nparticles-1)
    is a contiguous int64 vector of the nparticles lanes' pids on that
    card."""
    dev = check_inject_inputs(mesh, device, dtype, rng_scheme)
    n = int(nparticles)
    if pid is not None and (pid.dtype != torch.int64 or pid.device != dev
                            or tuple(pid.shape) != (n,)
                            or not pid.is_contiguous()):
        raise ValueError(f"inject kernel: pid must be a contiguous ({n},) "
                         f"int64 vector on {dev}, got {tuple(pid.shape)} "
                         f"{pid.dtype} on {pid.device}")
    out = {f: torch.empty(n, dtype=INT_FIELDS.get(f, dtype), device=dev)
           for f in STATE_FIELDS}
    cls, sfx = _LAYOUTS[dtype]
    p = cls()
    for f, t in out.items():
        setattr(p, f, t.data_ptr())
    p.edgex, p.edgey = mesh.edgex.data_ptr(), mesh.edgey.data_ptr()
    p.pid_in = None if pid is None else pid.data_ptr()
    p.n = n
    p.nx, p.ny = mesh.nx, mesh.ny
    p.uniform = int(bool(mesh.uniform))
    p.local = int(local_coords is not None)
    p.rng = SCHEMES.index(rng_scheme)
    # ctypes rounds each Python float to float32 as xs.const does, or
    # keeps it whole in float64.
    p.x0, p.y0 = source_x0, source_y0
    p.width, p.height = source_width, source_height
    p.inv_x = float(mesh.nx) / float(mesh.width)
    p.inv_y = float(mesh.ny) / float(mesh.height)
    if local_coords is not None:
        p.dx, p.dy = local_coords
    p.two_pi = 2.0 * np.pi
    p.energy0 = initial_energy
    p.dt = dt
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # 2,048 threads an SM: the kernel stages nothing in shared memory
    p.blocks = max(1, min(sms * (2048 // THREADS), -(-n // THREADS)))
    lib = load_library()
    with torch.cuda.device(dev):
        build.check_launch(lib, getattr(lib, f"nt_inject_launch{sfx}")(
            ctypes.byref(p), torch.cuda.current_stream().cuda_stream),
            "inject kernel")
    inject_particles_kernel.launches += 1
    inject_particles_kernel.cards[dev.index] += 1
    return ParticleState(**out)


inject_particles_kernel.launches = 0
inject_particles_kernel.cards = collections.Counter()  # launches by card

