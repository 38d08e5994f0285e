"""The fused sweep kernel (csrc/sweep.cu) and its plain version.

Counterpart of `neutral_tpu/pallas_sweep.py`.  `sweep_chunk_kernel` runs
every lane to census or death through the hand-written CUDA kernel: one
thread per lane, tally flushes by atomicAdd, event counts reduced in the
kernel.  It loops on the host: each launch runs at most `max_events`
events per lane, then the host reads back how many lanes still have work
and launches again until none has.  All per-history state, `deposit`
included, lives in the state tensors between launches, so the number of
launches changes nothing in the result.

`sweep_chunk_plain` is the plain PyTorch version (transport.sweep_chunk run
to completion).  `sweep_chunk_kernel` launches the kernel or raises: on a
state that does not lie on a CUDA device, and on any configuration the
kernel does not implement.  Choosing the plain version is the caller's
(the driver's `engine`).

`sweep_chunk_kernel.launches` counts kernel launches and
`sweep_chunk_plain.calls` counts plain runs; callers may reset both.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build, transport
from .particles import ParticleState
from .transport import Geometry
from .xs import CrossSection

MAX_EVENTS = 4096          # events per lane per launch
MAX_REGIONS = 16           # density regions or rects (csrc/common.cuh)


class _SweepParams(ctypes.Structure):
    """Mirror of `SweepParams` in csrc/sweep.cu."""
    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "x", "y", "omega_x", "omega_y", "energy", "weight",
            "dt_to_census", "mfp_to_collision", "deposit", "cellx",
            "celly", "dead", "pid", "counter", "tally", "counts")]
        + [("master_key", ctypes.c_uint64), ("n", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in (
            "max_events", "nx", "ny", "scatter_entries", "absorb_entries",
            "same_xs")]
        + [(f, ctypes.c_float) for f in ("dx", "dy", "inv_ntotal")]
        + [("nregions", ctypes.c_int),
           ("region_bounds", ctypes.c_int * (4 * MAX_REGIONS)),
           ("region_density", ctypes.c_float * MAX_REGIONS)])


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = build.load()
    lib.nt_params_size.argtypes = []
    lib.nt_params_size.restype = ctypes.c_int
    lib.nt_max_regions.argtypes = []
    lib.nt_max_regions.restype = ctypes.c_int
    lib.nt_sweep_launch.argtypes = [ctypes.POINTER(_SweepParams),
                                    ctypes.c_void_p]
    lib.nt_sweep_launch.restype = ctypes.c_int
    if (lib.nt_params_size() != ctypes.sizeof(_SweepParams)
            or lib.nt_max_regions() != MAX_REGIONS):
        raise RuntimeError("csrc/sweep.cu SweepParams does not match "
                           "sweep_kernel._SweepParams")
    return lib


_DTYPES = {"x": torch.float32, "y": torch.float32,
           "omega_x": torch.float32, "omega_y": torch.float32,
           "energy": torch.float32, "weight": torch.float32,
           "dt_to_census": torch.float32, "mfp_to_collision": torch.float32,
           "deposit": torch.float32, "cellx": torch.int32,
           "celly": torch.int32, "dead": torch.bool, "pid": torch.int64,
           "counter": torch.int64}


def check_inputs(state: ParticleState, tally: torch.Tensor, geom: Geometry,
                 scatter_tab: CrossSection, absorb_tab: CrossSection,
                 what: str, rects: tuple) -> None:
    """Raise unless the kernel `what` implements this configuration: CUDA
    tensors of the kernel's dtypes, a uniform pitch, threefry, analytic
    cross-sections and at most 16 density `rects`."""
    if not geom.dx:
        raise ValueError(f"{what} needs a uniform-pitch mesh (geom.dx)")
    if geom.rng_scheme != "threefry":
        raise NotImplementedError(f"{what}: only threefry draws are "
                                  "ported (ROADMAP: pcg64si)")
    if not (scatter_tab.analytic and absorb_tab.analytic):
        raise NotImplementedError(f"{what}: only analytic cross-"
                                  "sections are ported (ROADMAP: kernel 1 "
                                  "table mode)")
    if len(rects) > MAX_REGIONS:
        raise ValueError(f"{what} takes at most {MAX_REGIONS} density "
                         f"rectangles, got {len(rects)}")
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    for f, dt in _DTYPES.items():
        t = getattr(state, f)
        if t.device != dev or t.dtype != dt or t.shape != (state.n,) \
                or not t.is_contiguous():
            raise ValueError(f"state.{f}: expected a contiguous ({state.n},)"
                             f" {dt} tensor on {dev}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if (tally.device != dev or tally.dtype != torch.float32
            or tally.shape != (geom.nx * geom.ny,)
            or not tally.is_contiguous()):
        raise ValueError("tally: expected a contiguous float32 "
                         f"({geom.nx * geom.ny},) tensor on {dev}")


def state_pointers(p: ctypes.Structure, state: ParticleState) -> None:
    """Set the 14 state pointer fields of a kernel's parameter struct."""
    for f in _DTYPES:
        setattr(p, f, getattr(state, f).data_ptr())


def _params(state: ParticleState, tally: torch.Tensor, counts: torch.Tensor,
            geom: Geometry, scatter_tab: CrossSection,
            absorb_tab: CrossSection, master_key: int, inv_ntotal: float,
            max_events: int) -> _SweepParams:
    p = _SweepParams()
    state_pointers(p, state)
    p.tally = tally.data_ptr()
    p.counts = counts.data_ptr()
    p.master_key = int(master_key)
    p.n = state.n
    p.max_events = int(max_events)
    p.nx, p.ny = geom.nx, geom.ny
    p.scatter_entries = scatter_tab.nentries
    p.absorb_entries = absorb_tab.nentries
    p.same_xs = int(geom.same_xs)
    # ctypes rounds each Python float to float32 as np.float32 does.
    p.dx, p.dy, p.inv_ntotal = geom.dx, geom.dy, inv_ntotal
    p.nregions = len(geom.regions)
    for r, (ix0, ix1, iy0, iy1, d) in enumerate(geom.regions):
        p.region_bounds[4 * r:4 * r + 4] = [ix0, ix1, iy0, iy1]
        p.region_density[r] = d
    return p


def sweep_chunk_plain(state: ParticleState, tally: torch.Tensor,
                      geom: Geometry, scatter_tab: CrossSection,
                      absorb_tab: CrossSection, master_key: int,
                      inv_ntotal: float):
    """Plain version: event sweeps until no lane has work left.

    Returns (state, nfacets, ncollisions, nsweeps); `tally` is updated in
    place.
    """
    sweep_chunk_plain.calls += 1
    state, nf, nc, nsweeps, _ = transport.sweep_chunk(
        state, tally, geom, scatter_tab, absorb_tab, master_key,
        inv_ntotal, max_sweeps=np.iinfo(np.int64).max)
    return state, nf, nc, nsweeps


sweep_chunk_plain.calls = 0


def sweep_chunk_kernel(state: ParticleState, tally: torch.Tensor,
                       geom: Geometry, scatter_tab: CrossSection,
                       absorb_tab: CrossSection, master_key: int,
                       inv_ntotal: float, max_events: int = MAX_EVENTS):
    """Run every lane to census or death with the CUDA sweep kernel.

    Updates `state`'s tensors and `tally` in place (no copy of the 14
    state arrays).  Returns (state, nfacets, ncollisions, nlaunches).
    """
    check_inputs(state, tally, geom, scatter_tab, absorb_tab, "sweep kernel",
                 geom.regions)
    if max_events < 1:
        raise ValueError(f"max_events must be >= 1, got {max_events}")
    lib = load_library()
    # [facets, collisions, lanes still working after the launch]
    counts = torch.zeros(3, dtype=torch.int64, device=state.device)
    params = _params(state, tally, counts, geom, scatter_tab, absorb_tab,
                     master_key, inv_ntotal, max_events)
    launches = 0
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        while True:
            build.check_launch(
                lib, lib.nt_sweep_launch(ctypes.byref(params), stream),
                "sweep kernel")
            sweep_chunk_kernel.launches += 1
            launches += 1
            if int(counts[2]) == 0:      # waits for the launch
                break
            counts[2].zero_()
    nf, nc = (int(v) for v in counts[:2].tolist())
    return state, nf, nc, launches


sweep_chunk_kernel.launches = 0
