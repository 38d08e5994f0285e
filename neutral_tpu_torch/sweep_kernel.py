"""The fused sweep kernel (csrc/sweep.cu) and its plain version.

Counterpart of `neutral_tpu/pallas_sweep.py`.  `sweep_chunk_kernel` runs
every lane to census or death through the hand-written CUDA kernel: one
thread per lane, tally flushes by atomicAdd, event counts reduced in the
kernel.  It loops on the host: each launch runs at most `max_events`
events per lane, then the host reads back how many lanes still have work
and launches again until none has.  All per-history state, `deposit`
included, lives in the state tensors between launches, so the number of
launches changes nothing in the result.

The kernel's modes follow the deck: analytic cross-sections or stored
tables, region rectangles or a density grid, threefry or pcg64si draws;
each combination is its own instantiation (csrc/sweep.cu).  The spatial
window of a decomposed run (`x_off`/`y_off`, transport.py's) is a runtime
parameter of every instantiation.  `sweep_params` and `launch_sweep` are
one launch; `sweep_chunk_kernel` loops them for one state, and the
decomposed runs (parallel/) launch every shard before they read the
counters of all shards at once.

`sweep_chunk_plain` is the plain PyTorch version (transport.sweep_chunk run
to completion).  `sweep_chunk_kernel` launches the kernel or raises: on a
state that does not lie on a CUDA device, and on any configuration the
kernel does not implement.  Choosing the plain version is the caller's
(the driver's `engine`).

`sweep_chunk_kernel.launches` counts kernel launches (made by
`launch_sweep`, from either loop) and `sweep_chunk_plain.calls` counts
plain runs; callers may reset both.
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

# RngScheme codes of csrc/common.cuh (its XsMode and DensityMode codes are
# 0 for analytic/regions and 1 for table/grid).
RNG_SCHEMES = {"threefry": 0, "pcg64si": 1}


class _SweepParams(ctypes.Structure):
    """Mirror of `SweepParams` in csrc/sweep.cu."""
    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "x", "y", "omega_x", "omega_y", "energy", "weight",
            "dt_to_census", "mfp_to_collision", "deposit", "cellx",
            "celly", "dead", "pid", "counter", "tally", "counts",
            "scatter_keys", "scatter_values", "absorb_keys", "absorb_values",
            "region_bounds", "region_density", "density")]
        + [("master_key", ctypes.c_uint64), ("n", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in (
            "max_events", "nx", "ny", "scatter_entries", "absorb_entries",
            "same_xs", "nregions", "xs_mode", "density_mode", "rng",
            "x_off", "y_off", "global_nx", "global_ny")]
        + [(f, ctypes.c_float) for f in ("dx", "dy", "inv_ntotal")])


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = build.load()
    lib.nt_params_size.argtypes = []
    lib.nt_params_size.restype = ctypes.c_int
    lib.nt_sweep_launch.argtypes = [ctypes.POINTER(_SweepParams),
                                    ctypes.c_void_p]
    lib.nt_sweep_launch.restype = ctypes.c_int
    if lib.nt_params_size() != ctypes.sizeof(_SweepParams):
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


def _check_tensor(name: str, t: torch.Tensor, shape: tuple,
                  dtype: torch.dtype, dev: torch.device) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {shape} {dtype} "
                         f"tensor on {dev}, got {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}")


def check_inputs(state: ParticleState, tally: torch.Tensor, geom: Geometry,
                 scatter_tab: CrossSection, absorb_tab: CrossSection,
                 what: str) -> None:
    """Raise unless the kernel `what` implements this configuration: CUDA
    tensors of the kernel's dtypes, a uniform pitch, threefry or pcg64si
    draws, both cross-sections analytic or both stored tables (float32 on
    the device), and region rectangles or a float32 density grid."""
    if not geom.dx:
        raise ValueError(f"{what} needs a uniform-pitch mesh (geom.dx)")
    if geom.rng_scheme not in RNG_SCHEMES:
        raise ValueError(f"{what}: unknown rng scheme {geom.rng_scheme!r}")
    if scatter_tab.analytic != absorb_tab.analytic:
        raise NotImplementedError(
            f"{what}: one analytic and one stored cross-section table; the "
            "kernels take both in one mode (a quartic .cs file beside a "
            "non-quartic one runs on the plain engine)")
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    for f, dt in _DTYPES.items():
        _check_tensor(f"state.{f}", getattr(state, f), (state.n,), dt, dev)
    ncells = geom.nx * geom.ny
    _check_tensor("tally", tally, (ncells,), torch.float32, dev)
    if not scatter_tab.analytic:
        for name, tab in (("scatter", scatter_tab), ("absorb", absorb_tab)):
            if tab.nentries < 2:
                raise ValueError(f"{name} table: needs at least 2 entries")
            for part in ("keys", "values"):
                _check_tensor(f"{name} table {part}", getattr(tab, part),
                              (tab.nentries,), torch.float32, dev)
    if geom.regions is None:
        _check_tensor("geom.density", geom.density, (ncells,),
                      torch.float32, dev)


def rect_arrays(rects: tuple, device: torch.device):
    """Region or rect tables as the kernels take them: (R, 4) int32 bounds
    (ix0, ix1, iy0, iy1) and (R,) float32 densities on `device`; any R."""
    bounds = torch.tensor([r[:4] for r in rects], dtype=torch.int32,
                          device=device).reshape(len(rects), 4)
    density = torch.tensor([r[4] for r in rects], dtype=torch.float32,
                           device=device)
    return bounds, density


def window_fields(p: ctypes.Structure, geom: Geometry, x_off=None,
                  y_off=None) -> None:
    """Set a kernel's extent and window fields: nx/ny (the window's, or
    the whole mesh), the offsets (0 without a window) and the global
    extent; raise unless the window lies inside the mesh."""
    xo, yo = x_off or 0, y_off or 0
    if not (0 <= xo and xo + geom.nx <= geom.global_nx and 0 <= yo
            and yo + geom.ny <= geom.global_ny):
        raise ValueError(f"window at ({xo}, {yo}) of {geom.nx}x{geom.ny} "
                         "cells does not lie inside the "
                         f"{geom.global_nx}x{geom.global_ny} mesh")
    p.nx, p.ny = geom.nx, geom.ny
    p.x_off, p.y_off = xo, yo
    p.global_nx, p.global_ny = geom.global_nx, geom.global_ny


def state_pointers(p: ctypes.Structure, state: ParticleState) -> None:
    """Set the 14 state pointer fields of a kernel's parameter struct."""
    for f in _DTYPES:
        setattr(p, f, getattr(state, f).data_ptr())


def table_fields(p: ctypes.Structure, geom: Geometry,
                 scatter_tab: CrossSection, absorb_tab: CrossSection) -> None:
    """Set a kernel's cross-section and RNG fields: entry counts, same_xs,
    the mode codes, and in table mode the tables' device pointers."""
    p.scatter_entries = scatter_tab.nentries
    p.absorb_entries = absorb_tab.nentries
    p.same_xs = int(geom.same_xs)
    p.rng = RNG_SCHEMES[geom.rng_scheme]
    p.xs_mode = int(not scatter_tab.analytic)
    if not scatter_tab.analytic:
        p.scatter_keys = scatter_tab.keys.data_ptr()
        p.scatter_values = scatter_tab.values.data_ptr()
        p.absorb_keys = absorb_tab.keys.data_ptr()
        p.absorb_values = absorb_tab.values.data_ptr()


def sweep_params(state: ParticleState, tally: torch.Tensor,
                 counts: torch.Tensor, regions: tuple | None, geom: Geometry,
                 scatter_tab: CrossSection, absorb_tab: CrossSection,
                 master_key: int, inv_ntotal: float, max_events: int,
                 x_off=None, y_off=None) -> _SweepParams:
    """The parameters of one launch, after check_inputs: `counts` is the
    (3,) int64 [facets, collisions, lanes still working] the kernel adds
    to, `regions` is rect_arrays(geom.regions), or None for a grid deck,
    and `x_off`/`y_off` the window (None: none)."""
    check_inputs(state, tally, geom, scatter_tab, absorb_tab, "sweep kernel")
    if max_events < 1:
        raise ValueError(f"max_events must be >= 1, got {max_events}")
    p = _SweepParams()
    state_pointers(p, state)
    p.tally = tally.data_ptr()
    p.counts = counts.data_ptr()
    table_fields(p, geom, scatter_tab, absorb_tab)
    p.master_key = int(master_key)
    p.n = state.n
    p.max_events = int(max_events)
    window_fields(p, geom, x_off, y_off)
    # ctypes rounds each Python float to float32 as np.float32 does.
    p.dx, p.dy, p.inv_ntotal = geom.dx, geom.dy, inv_ntotal
    if regions is None:
        p.density_mode = 1
        p.density = geom.density.data_ptr()
    else:
        p.nregions = regions[0].shape[0]
        p.region_bounds = regions[0].data_ptr()
        p.region_density = regions[1].data_ptr()
    return p


def sweep_chunk_plain(state: ParticleState, tally: torch.Tensor,
                      geom: Geometry, scatter_tab: CrossSection,
                      absorb_tab: CrossSection, master_key: int,
                      inv_ntotal: float, x_off=None, y_off=None):
    """Plain version: event sweeps until no lane has work left (inside the
    window `x_off`/`y_off`, if given).

    Returns (state, nfacets, ncollisions, nsweeps); `tally` is updated in
    place.
    """
    sweep_chunk_plain.calls += 1
    state, nf, nc, nsweeps, _ = transport.sweep_chunk(
        state, tally, geom, scatter_tab, absorb_tab, master_key,
        inv_ntotal, max_sweeps=np.iinfo(np.int64).max, x_off=x_off,
        y_off=y_off)
    return state, nf, nc, nsweeps


sweep_chunk_plain.calls = 0


def launch_sweep(params: _SweepParams, device: torch.device) -> None:
    """One launch of the sweep kernel on `device`'s current stream; does
    not wait for it."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(
            lib, lib.nt_sweep_launch(ctypes.byref(params), stream),
            "sweep kernel")
    sweep_chunk_kernel.launches += 1


def sweep_chunk_kernel(state: ParticleState, tally: torch.Tensor,
                       geom: Geometry, scatter_tab: CrossSection,
                       absorb_tab: CrossSection, master_key: int,
                       inv_ntotal: float, max_events: int = MAX_EVENTS,
                       x_off=None, y_off=None):
    """Run every lane to census or death (or, under the window `x_off`/
    `y_off`, until it leaves the window) with the CUDA sweep kernel.

    Updates `state`'s tensors and `tally` in place (no copy of the 14
    state arrays).  Returns (state, nfacets, ncollisions, nlaunches).
    """
    # [facets, collisions, lanes still working after the launch]
    counts = torch.zeros(3, dtype=torch.int64, device=state.device)
    regions = (None if geom.regions is None
               else rect_arrays(geom.regions, state.device))
    params = sweep_params(state, tally, counts, regions, geom, scatter_tab,
                          absorb_tab, master_key, inv_ntotal, max_events,
                          x_off, y_off)
    launches = 0
    while True:
        launch_sweep(params, state.device)
        launches += 1
        if int(counts[2]) == 0:      # waits for the launch
            break
        counts[2].zero_()
    nf, nc = (int(v) for v in counts[:2].tolist())
    return state, nf, nc, launches


sweep_chunk_kernel.launches = 0
