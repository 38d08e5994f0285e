"""The census-start kernel (csrc/begin.cu) and the choice of begin by
engine.

Counterpart of `neutral_tpu/transport.py::begin_timestep`, a `jax.jit`
function that XLA fuses into one program a census.  Its plain PyTorch
version, `transport.begin_timestep`, runs as a chain of eager operations;
`begin_timestep_kernel` computes the same state in one launch of the
hand-written CUDA kernel, bit for bit: each live lane's census clock reset
to dt and its fresh mean free path from the draw at counter 0, every
lane's counter set to 1, and the count of live lanes.

The kernel has float32 and float64 instantiations (the working type of
the state, which its tally-free inputs share: a grid deck's density and
the tables).  It reads no facet edge, so a geometry without a uniform
pitch (a non-uniform mesh, a fast_math 0 deck) is one it takes as it
takes any other.  `begin_timestep_kernel` launches the kernel or raises:
on a state that does not lie on a CUDA device and on any configuration
the kernel does not implement.  It never runs
the plain version.  `begin_census` is the steps' choice between the two:
the kernel engine takes the kernel, the plain engine
`transport.begin_timestep`.  `begin_timestep_kernel.launches` counts
kernel launches; callers may reset it.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import build, transport
from .particles import STATE_FIELDS, ParticleState
from .sweep_kernel import (REALS, TABLE_POINTERS, check_inputs, kernel_rects,
                           state_pointers, table_fields, window_fields)
from .transport import Geometry
from .xs import CrossSection

THREADS = 256              # threads per block (csrc/begin.cu kThreads)

# The fields that begin_timestep changes, each written to a fresh tensor.
CHANGED = ("dt_to_census", "mfp_to_collision", "counter")


def _begin_fields(real) -> list:
    """`BeginParamsT<Real>`'s fields in csrc/begin.cu, its census clock of
    the ctypes type `real`."""
    return (
        [(f, ctypes.c_void_p) for f in (
            *STATE_FIELDS, *(f"out_{f}" for f in CHANGED), "live",
            *TABLE_POINTERS, "scatter_grid", "absorb_grid", "region_bounds",
            "region_density", "density")]
        + [("master_key", ctypes.c_uint64), ("n", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in (
            "blocks", "nx", "ny", "scatter_entries", "absorb_entries",
            "scatter_shift", "absorb_shift", "same_xs", "nregions",
            "xs_mode", "density_mode", "rng", "x_off", "y_off", "global_nx",
            "global_ny")]
        + [("dt", real)])


class _BeginParams(ctypes.Structure):
    """Mirror of `BeginParams` (float32) in csrc/begin.cu."""
    _fields_ = _begin_fields(ctypes.c_float)


class _BeginParams64(ctypes.Structure):
    """Mirror of `BeginParams64` (float64) in csrc/begin.cu."""
    _fields_ = _begin_fields(ctypes.c_double)


# The parameter layout and entry-point suffix of each working type.
_LAYOUTS = {torch.float32: (_BeginParams, ""),
            torch.float64: (_BeginParams64, "_f64")}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = build.load()
    lib.nt_begin_threads.argtypes = []
    lib.nt_begin_threads.restype = ctypes.c_int
    for cls, sfx in _LAYOUTS.values():
        size = getattr(lib, f"nt_begin_params_size{sfx}")
        size.argtypes, size.restype = [], ctypes.c_int
        blocks = getattr(lib, f"nt_begin_blocks_per_sm{sfx}")
        blocks.argtypes = [ctypes.POINTER(cls), ctypes.POINTER(ctypes.c_int)]
        blocks.restype = ctypes.c_int
        launch = getattr(lib, f"nt_begin_launch{sfx}")
        launch.argtypes = [ctypes.POINTER(cls), ctypes.c_void_p]
        launch.restype = ctypes.c_int
        if size() != ctypes.sizeof(cls):
            raise RuntimeError(f"csrc/begin.cu BeginParams{sfx} does not "
                               f"match begin_kernel.{cls.__name__}")
    if lib.nt_begin_threads() != THREADS:
        raise RuntimeError("csrc/begin.cu kThreads does not match "
                           "begin_kernel.THREADS")
    return lib


@functools.cache
def _card_blocks(device: torch.device, real: torch.dtype, modes: tuple,
                 entries: int, shift: int) -> int:
    """Blocks that `device` holds at once of the instantiation `modes`
    (xs_mode, density_mode, rng) in working type `real` beside the coarse
    index of a table of `entries` entries and coarse shift `shift` in
    table mode, from the CUDA occupancy calculator; read once per process
    and key."""
    lib = load_library()
    cls, sfx = _LAYOUTS[real]
    p = cls()
    p.xs_mode, p.density_mode, p.rng = modes
    p.scatter_entries, p.scatter_shift = entries, shift
    blocks = ctypes.c_int()
    with torch.cuda.device(device):
        build.check_launch(lib, getattr(lib, f"nt_begin_blocks_per_sm{sfx}")(
            ctypes.byref(p), ctypes.byref(blocks)),
            "begin kernel occupancy query")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * max(blocks.value, 1)


def check_begin_inputs(state: ParticleState, geom: Geometry,
                       scatter_tab: CrossSection) -> None:
    """Raise ValueError unless the kernel implements this configuration:
    what sweep_kernel.check_inputs asks of the sweep kernel's (a float32 or
    float64 state, threefry or pcg64si draws, CUDA tensors of the state's
    dtypes, the table and a grid deck's density in the state's working
    type on its device), with or without a uniform pitch."""
    check_inputs(state, None, geom, scatter_tab, scatter_tab, "begin kernel",
                 REALS, pitch=False)


def begin_timestep_kernel(state: ParticleState, geom: Geometry,
                          scatter_tab: CrossSection, dt: float,
                          master_key: int, x_off=None, y_off=None):
    """transport.begin_timestep in one launch of the CUDA kernel, on the
    state's device and its current stream (no wait).

    Returns (the new state, a one-element int64 tensor on the device
    holding the count of live lanes).  The new state's dt_to_census,
    mfp_to_collision and counter are fresh tensors; its other fields are
    the caller's, which the launch does not change.  `x_off`/`y_off` is
    the window of a decomposed run's shard (a grid deck's density is
    window-local), None for none.
    """
    check_begin_inputs(state, geom, scatter_tab)
    dev = state.device
    out = {f: torch.empty_like(getattr(state, f)) for f in CHANGED}
    live = torch.zeros(1, dtype=torch.int64, device=dev)
    real = state.dtype
    cls, sfx = _LAYOUTS[real]
    p = cls()
    state_pointers(p, state)
    for f, t in out.items():
        setattr(p, f"out_{f}", t.data_ptr())
    p.live = live.data_ptr()
    # The absorb table is not read: its fields repeat the scatter table's.
    table_fields(p, geom, scatter_tab, scatter_tab, real)
    window_fields(p, geom, x_off, y_off)
    p.master_key = int(master_key)
    p.n = state.n
    # ctypes rounds the Python float to float32 as xs.const does, or keeps
    # it whole in float64.
    p.dt = dt
    if geom.regions is None:
        p.density_mode = 1
        p.density = geom.density.data_ptr()
    else:
        bounds, density = kernel_rects(geom.regions, dev, real)
        p.nregions = bounds.shape[0]
        p.region_bounds = bounds.data_ptr()
        p.region_density = density.data_ptr()
    card = _card_blocks(dev, real, (p.xs_mode, p.density_mode, p.rng),
                        p.scatter_entries, p.scatter_shift)
    p.blocks = max(1, min(card, -(-state.n // THREADS)))
    lib = load_library()
    with torch.cuda.device(dev):
        build.check_launch(lib, getattr(lib, f"nt_begin_launch{sfx}")(
            ctypes.byref(p), torch.cuda.current_stream().cuda_stream),
            "begin kernel")
    begin_timestep_kernel.launches += 1
    begin_timestep_kernel.cards[dev.index] += 1
    fields = {f: getattr(state, f) for f in STATE_FIELDS} | out
    return ParticleState(**fields), live


begin_timestep_kernel.launches = 0
begin_timestep_kernel.cards = collections.Counter()  # launches by card


def begin_census(engine: str, state: ParticleState, geom: Geometry,
                 scatter_tab: CrossSection, dt: float, master_key: int,
                 x_off=None, y_off=None):
    """The start of a census on `engine`'s path: (state, live lanes as a
    one-element int64 tensor on the state's device), from
    begin_timestep_kernel on the kernel engine and from
    transport.begin_timestep on the plain one."""
    if engine == "kernel":
        return begin_timestep_kernel(state, geom, scatter_tab, dt,
                                     master_key, x_off, y_off)
    state = transport.begin_timestep(state, geom, scatter_tab, dt,
                                     master_key, x_off, y_off)
    return state, (~state.dead).sum().reshape(1)
