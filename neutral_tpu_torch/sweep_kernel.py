"""The fused sweep kernel (csrc/sweep.cu) and its plain version.

Counterpart of `neutral_tpu/pallas_sweep.py`.  The kernel runs lanes to
census or death: persistent threads, each running one lane at a time and
taking the next from a work list, tally flushes by atomicAdd, event counts
reduced in the kernel.  `sweep_round` is one launch: at most `max_events`
events per lane, over the list of working lanes that the previous launch
wrote (a census's first launch runs over every lane, with no list); the
lanes still working after it make the next list, whose length the host
reads back.  The census loop (census.py: `census.sweep_chunk_kernel` for
one state, and the decompositions' shards) launches again until the list
is empty.  All per-history state, `deposit` included, lives in the state
tensors between launches, each lane at its own index, so the number of
launches and the order of the lanes change nothing in the result.

The kernel's modes follow the deck: analytic cross-sections or stored
tables, region rectangles or a density grid, threefry or pcg64si draws,
and facet edges from the uniform pitch or, for a geometry without one (a
non-uniform mesh, a fast_math 0 deck), from the mesh's edge arrays
(`edge_mode`, `check_edges`, `edge_fields`); each combination is its own
instantiation (csrc/sweep.cu), in float32 (cell-local positions on a
pitch, global without) and in float64 (global positions, the working type
of neutral_tpu's XLA float64 engine): `_SweepParams` and `_SweepParams64`
are the two parameter layouts.  The tally has a type of its own
(SimConfig.tally_dtype), float32 or float64 beside a state of either:
a state and a tally of different types take the instantiations of
csrc/sweep_mixed.cu, whose layouts (`_SweepParams32t64`,
`_SweepParams64t32`) hold the tally and inv_ntotal in the tally's type
(`_LAYOUTS`, by the pair).  The spatial
window of a decomposed run (`x_off`/`y_off`, transport.py's) is a runtime
parameter of every instantiation.  `sweep_params` is a census's launch
parameters and `sweep_round` one launch over the lists of `SweepBuffers`.
The grid fills the card once (`grid_blocks`, from the
occupancy that `resident_blocks` reads from the library for each launch's
instantiation and shared memory).

`sweep_chunk_plain` is the plain PyTorch version (transport.sweep_chunk run
to completion); `sweep_chunk_plain.calls` counts its calls, and callers
may reset it.  `sweep_params` raises on a state that does not lie on a
CUDA device and on any configuration the kernel does not implement;
choosing the plain version is the caller's (`driver.pick_engine`).
`SweepBuffers.slot_use` is the share of the launches' thread slots that
ran events, from the kernel's counters, and `thread_slot_use` the share
that one thread per lane in pid order would fill, from per-lane event
counts (the kernel's layout before it had a work list).
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
THREADS = 128              # threads per block (csrc/sweep.cu kThreads)

# RngScheme codes of csrc/common.cuh (its XsMode, DensityMode and EdgeMode
# codes are 0 for analytic/regions/pitch and 1 for table/grid/array).
RNG_SCHEMES = {"threefry": 0, "pcg64si": 1}

# The table-mode pointer fields of both kernels' parameters, in order: each
# table's keys, packed intervals and coarse index (xs.TableLayout).
TABLE_POINTERS = tuple(f"{t}_{part}" for t in ("scatter", "absorb")
                       for part in ("keys", "intervals", "coarse"))


# The working types of the sweep and begin kernels' instantiations.
REALS = (torch.float32, torch.float64)


def _sweep_fields(real, tally=None) -> list:
    """`SweepParamsT<Real, Tally>`'s fields in csrc/sweep.cuh, its scalars
    of the ctypes type `real` but inv_ntotal, of `tally` (None: `real`)."""
    return (
        [(f, ctypes.c_void_p) for f in (
            "x", "y", "omega_x", "omega_y", "energy", "weight",
            "dt_to_census", "mfp_to_collision", "deposit", "cellx",
            "celly", "dead", "pid", "counter", "tally", "counts", "active",
            "next", *TABLE_POINTERS, "scatter_grid", "absorb_grid",
            "region_bounds", "region_density", "density")]
        + [("master_key", ctypes.c_uint64), ("n", ctypes.c_int64),
           ("n_active", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in (
            "blocks", "max_events", "nx", "ny", "scatter_entries",
            "absorb_entries", "scatter_shift", "absorb_shift", "same_xs",
            "nregions", "xs_mode",
            "density_mode", "rng", "x_off", "y_off", "global_nx",
            "global_ny")]
        + [(f, real) for f in ("dx", "dy")]
        + [("inv_ntotal", tally or real)]
        + [(f, ctypes.c_void_p) for f in ("edgex", "edgey")]
        + [("edge_mode", ctypes.c_int)])


class _SweepParams(ctypes.Structure):
    """Mirror of `SweepParams` (float32) in csrc/sweep.cu."""
    _fields_ = _sweep_fields(ctypes.c_float)


class _SweepParams64(ctypes.Structure):
    """Mirror of `SweepParams64` (float64) in csrc/sweep.cu."""
    _fields_ = _sweep_fields(ctypes.c_double)


class _SweepParams32t64(ctypes.Structure):
    """Mirror of `SweepParams32t64` (a float32 state, a float64 tally) in
    csrc/sweep_mixed.cu."""
    _fields_ = _sweep_fields(ctypes.c_float, ctypes.c_double)


class _SweepParams64t32(ctypes.Structure):
    """Mirror of `SweepParams64t32` (a float64 state, a float32 tally) in
    csrc/sweep_mixed.cu."""
    _fields_ = _sweep_fields(ctypes.c_double, ctypes.c_float)


# The parameter layout and entry-point suffix of each (state, tally) pair.
_LAYOUTS = {(torch.float32, torch.float32): (_SweepParams, ""),
            (torch.float64, torch.float64): (_SweepParams64, "_f64"),
            (torch.float32, torch.float64): (_SweepParams32t64, "_f32t64"),
            (torch.float64, torch.float32): (_SweepParams64t32, "_f64t32")}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = build.load()
    lib.nt_sweep_threads.argtypes = []
    lib.nt_sweep_threads.restype = ctypes.c_int
    for cls, sfx in _LAYOUTS.values():
        size = getattr(lib, f"nt_params_size{sfx}")
        size.argtypes, size.restype = [], ctypes.c_int
        blocks = getattr(lib, f"nt_sweep_blocks_per_sm{sfx}")
        blocks.argtypes = [ctypes.POINTER(cls), ctypes.POINTER(ctypes.c_int)]
        blocks.restype = ctypes.c_int
        launch = getattr(lib, f"nt_sweep_launch{sfx}")
        launch.argtypes = [ctypes.POINTER(cls), ctypes.c_void_p]
        launch.restype = ctypes.c_int
        if size() != ctypes.sizeof(cls):
            raise RuntimeError(f"csrc/sweep.cuh's layout{sfx} does not "
                               f"match sweep_kernel.{cls.__name__}")
    if lib.nt_sweep_threads() != THREADS:
        raise RuntimeError("csrc/sweep.cu kThreads does not match "
                           "sweep_kernel.THREADS")
    return lib


def _suffix(params: ctypes.Structure) -> str:
    """The entry-point suffix of a parameter layout ("", "_f64", "_f32t64"
    or "_f64t32")."""
    return next(sfx for cls, sfx in _LAYOUTS.values()
                if type(params) is cls)


def resident_blocks(params: ctypes.Structure,
                    device: torch.device) -> tuple[int, int]:
    """(SMs, blocks per SM) of the sweep kernel's instantiation (modes,
    working type and tally type) for a launch with `params` on `device` (an
    indexed CUDA
    device), beside the launch's dynamic shared memory (its tables' coarse
    indexes), from the CUDA occupancy calculator."""
    lib = load_library()
    blocks = ctypes.c_int()
    query = getattr(lib, f"nt_sweep_blocks_per_sm{_suffix(params)}")
    with torch.cuda.device(device):
        build.check_launch(lib, query(
            ctypes.byref(params), ctypes.byref(blocks)),
            "sweep kernel occupancy query")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms, blocks.value


def grid_blocks(n_active: int, sms: int, blocks_per_sm: int) -> int:
    """Blocks of a persistent launch over a list of `n_active` lanes: as
    many as the card holds at once (`sms` x `blocks_per_sm`), but no more
    than the list needs at one lane a thread, and at least one."""
    need = -(-n_active // THREADS)
    return max(1, min(sms * max(blocks_per_sm, 1), need))


def thread_slot_use(events: torch.Tensor) -> float:
    """Share of the thread slots that run events when each thread runs the
    lane at its own index for `events[i]` events (one thread per lane in
    pid order): sum(n_i) over the sum over warps of 32 * max(n_i), a last
    partial warp padded with idle slots."""
    n = events.shape[0]
    pad = torch.zeros((-n) % 32, dtype=events.dtype, device=events.device)
    per_warp = torch.cat([events, pad]).reshape(-1, 32)
    slots = 32 * per_warp.max(dim=1).values.sum()
    return float(events.sum()) / float(slots) if float(slots) else 1.0


class SweepBuffers:
    """The sweep loop's device buffers for one state on one device, kept
    by the caller between censuses: the six counters [facets, collisions,
    lanes still working (the next list's length), the list cursor, lane
    events run, warp event steps] and the two lane lists of a launch (its
    own and the next, swapped after each launch).  `n_active` is the
    length of the next launch's list, None when the next launch covers
    every lane (the first of a census, or of a shard that received
    migrants).  counts[4] / (32 * counts[5]) is the share of the thread
    slots of the launches so far that ran events.  `grid` is (blocks, SMs,
    blocks an SM holds) of the latest launch over every lane."""

    def __init__(self, device):
        self.counts = torch.zeros(6, dtype=torch.int64, device=device)
        self.device = self.counts.device            # with its index
        self.lists = [torch.empty(0, dtype=torch.int32, device=self.device)
                      for _ in range(2)]
        self.grid = (0, 0, 0)
        self.start_census()

    def start_census(self) -> None:
        """The next launch is a census's first: it covers every lane, and
        the counters start at 0."""
        self.n_active = None
        self.counts.zero_()

    def slot_use(self) -> float:
        """counts[4] / (32 * counts[5]) (a host read)."""
        events, steps = (int(v) for v in self.counts[4:6].tolist())
        return events / (32 * steps) if steps else 1.0


_FLOATS = ("x", "y", "omega_x", "omega_y", "energy", "weight",
           "dt_to_census", "mfp_to_collision", "deposit")


def state_dtypes(real: torch.dtype = torch.float32) -> dict:
    """The dtype of each of the 14 state fields that the kernels take, with
    working type `real`."""
    return ({f: real for f in _FLOATS}
            | {"cellx": torch.int32, "celly": torch.int32,
               "dead": torch.bool, "pid": torch.int64,
               "counter": torch.int64})


def _check_tensor(name: str, t: torch.Tensor, shape: tuple,
                  dtype: torch.dtype, dev: torch.device) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {shape} {dtype} "
                         f"tensor on {dev}, got {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}")


def edge_mode(geom: Geometry) -> int:
    """The EdgeMode of csrc/common.cuh that a geometry takes: 0 (pitch)
    with a uniform pitch, 1 (array) without one (dx = 0: a non-uniform
    mesh or a fast_math 0 deck), whose facets read the edge arrays by
    global cell, as transport._facet_edges gathers them."""
    return int(not geom.dx)


def check_edges(geom: Geometry, real: torch.dtype, dev: torch.device,
                what: str) -> None:
    """Raise unless a geometry without a pitch carries the whole mesh's
    edge arrays as the kernels read them: geom.edgex of global_nx + 1 and
    geom.edgey of global_ny + 1 entries, contiguous, in the working type
    `real` on `dev` (nothing to check with a pitch)."""
    if not edge_mode(geom):
        return
    for name, t, n in (("geom.edgex", geom.edgex, geom.global_nx + 1),
                       ("geom.edgey", geom.edgey, geom.global_ny + 1)):
        if t is None:
            raise ValueError(f"{what}: a geometry without a pitch (dx = 0) "
                             f"needs {name}, the mesh's edge array")
        _check_tensor(name, t, (n,), real, dev)


def edge_fields(p: ctypes.Structure, geom: Geometry) -> None:
    """Set the sweep kernel's edge mode and, in edge-array mode, the
    device pointers of the edge arrays (after check_edges)."""
    p.edge_mode = edge_mode(geom)
    if p.edge_mode:
        p.edgex, p.edgey = geom.edgex.data_ptr(), geom.edgey.data_ptr()


def check_inputs(state: ParticleState, tally: torch.Tensor | None,
                 geom: Geometry,
                 scatter_tab: CrossSection, absorb_tab: CrossSection,
                 what: str, reals: tuple = (torch.float32,),
                 pitch: bool = True) -> None:
    """Raise unless the kernel `what` implements this configuration: CUDA
    tensors of the kernel's dtypes in one working type of `reals` (the
    state's floats, the tables and a density grid alike: a float64 state
    beside float32 tables raises), a tally of any type of `reals` (a
    float32 state with a float64 tally and the other way round run the
    mixed instantiations), a uniform pitch where
    `pitch` (the flight kernel; the sweep kernel checks a geometry without
    one with check_edges, and the begin kernel reads no facet edge),
    threefry or pcg64si draws, both cross-sections analytic or both stored
    tables, and region rectangles or a density grid.  A kernel without a
    tally passes None."""
    real = state.dtype
    if real not in reals:
        raise ValueError(f"{what} takes a state of "
                         f"{' or '.join(map(str, reals))}, got {real}")
    if tally is not None and tally.dtype not in reals:
        raise ValueError(f"{what} takes a tally of "
                         f"{' or '.join(map(str, reals))}, got {tally.dtype}")
    others = {"geom.density": geom.density if geom.regions is None else None}
    if not scatter_tab.analytic:
        others |= {f"{name} table {part}": getattr(tab, part)
                   for name, tab in (("scatter", scatter_tab),
                                     ("absorb", absorb_tab))
                   for part in ("keys", "values")}
    mixed = {k: str(t.dtype) for k, t in others.items()
             if t is not None and t.dtype != real}
    if mixed:
        raise ValueError(f"{what}: a {real} state beside {mixed}: the "
                         "kernels take one working type")
    if pitch and not geom.dx:
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
    for f, dt in state_dtypes(real).items():
        _check_tensor(f"state.{f}", getattr(state, f), (state.n,), dt, dev)
    ncells = geom.nx * geom.ny
    if tally is not None:
        _check_tensor("tally", tally, (ncells,), tally.dtype, dev)
    if not scatter_tab.analytic:
        for name, tab in (("scatter", scatter_tab), ("absorb", absorb_tab)):
            if tab.nentries < 2:
                raise ValueError(f"{name} table: needs at least 2 entries")
            for part in ("keys", "values"):
                _check_tensor(f"{name} table {part}", getattr(tab, part),
                              (tab.nentries,), real, dev)
            tab.table_layout       # made once per table; raises if it cannot
    elif scatter_tab.keys.device != dev or absorb_tab.keys.device != dev:
        raise ValueError(f"{what}: the analytic tables lie on "
                         f"{scatter_tab.keys.device}, the state on {dev}")
    if geom.regions is None:
        _check_tensor("geom.density", geom.density, (ncells,), real, dev)


def rect_arrays(rects: tuple, device: torch.device,
                dtype: torch.dtype = torch.float32):
    """Region or rect tables as the kernels take them: (R, 4) int32 bounds
    (ix0, ix1, iy0, iy1) and (R,) densities in the working type `dtype`
    (each rounded once, as xs.const rounds it) on `device`; any R."""
    bounds = torch.tensor([r[:4] for r in rects], dtype=torch.int32,
                          device=device).reshape(len(rects), 4)
    density = torch.tensor([r[4] for r in rects], dtype=dtype,
                           device=device)
    return bounds, density


@functools.cache
def kernel_rects(rects: tuple | None, device: torch.device,
                 dtype: torch.dtype):
    """rect_arrays(rects) on `device` in `dtype` (None for None), made
    once per process, deck, device and dtype, so that a census copies
    nothing from the host for them."""
    return None if rects is None else rect_arrays(rects, device, dtype)


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
    for f in state_dtypes():
        setattr(p, f, getattr(state, f).data_ptr())


def table_fields(p: ctypes.Structure, geom: Geometry,
                 scatter_tab: CrossSection, absorb_tab: CrossSection,
                 real: torch.dtype = torch.float32) -> None:
    """Set a kernel's cross-section and RNG fields: entry counts, same_xs,
    the mode codes, and the device pointers of the analytic grids in the
    working type `real` or, in table mode, of the tables' layouts (keys,
    intervals, coarse index) and their coarse strides."""
    p.scatter_entries = scatter_tab.nentries
    p.absorb_entries = absorb_tab.nentries
    p.same_xs = int(geom.same_xs)
    p.rng = RNG_SCHEMES[geom.rng_scheme]
    p.xs_mode = int(not scatter_tab.analytic)
    if scatter_tab.analytic:
        p.scatter_grid = scatter_tab.analytic_grid_in(real).data_ptr()
        p.absorb_grid = absorb_tab.analytic_grid_in(real).data_ptr()
    else:
        for name, tab in (("scatter", scatter_tab), ("absorb", absorb_tab)):
            lay = tab.table_layout
            for part in ("keys", "intervals", "coarse"):
                setattr(p, f"{name}_{part}", getattr(lay, part).data_ptr())
            setattr(p, f"{name}_shift", lay.shift)


def sweep_params(state: ParticleState, tally: torch.Tensor,
                 regions: tuple | None, geom: Geometry,
                 scatter_tab: CrossSection, absorb_tab: CrossSection,
                 master_key: int, inv_ntotal: float, x_off=None,
                 y_off=None) -> ctypes.Structure:
    """The parameters of a census's launches in the state's working type
    and the tally's type (`_LAYOUTS`), after check_inputs: `regions` is
    rect_arrays(geom.regions, dtype=the working type), or None for a grid
    deck, and `x_off`/`y_off` the window (None: none).  sweep_round sets
    the fields of each launch (lists, grid, events, counters)."""
    check_inputs(state, tally, geom, scatter_tab, absorb_tab, "sweep kernel",
                 REALS, pitch=False)
    check_edges(geom, state.dtype, state.device, "sweep kernel")
    if state.n >= 2**31:
        raise ValueError(f"sweep kernel: lane lists are int32, so at most "
                         f"2**31 - 1 lanes, got {state.n}")
    if regions is not None and regions[1].dtype != state.dtype:
        raise ValueError(f"sweep kernel: region densities in "
                         f"{regions[1].dtype}, state in {state.dtype}")
    p = _LAYOUTS[(state.dtype, tally.dtype)][0]()
    state_pointers(p, state)
    p.tally = tally.data_ptr()
    table_fields(p, geom, scatter_tab, absorb_tab, state.dtype)
    p.master_key = int(master_key)
    p.n = state.n
    window_fields(p, geom, x_off, y_off)
    # ctypes rounds each Python float to float32 as np.float32 does, or
    # keeps it whole in float64, as xs.const does (inv_ntotal in the
    # tally's type, the pitch in the working type).
    p.dx, p.dy, p.inv_ntotal = geom.dx, geom.dy, inv_ntotal
    edge_fields(p, geom)
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


def sweep_round(params: ctypes.Structure, buffers: SweepBuffers,
                max_events: int = MAX_EVENTS) -> bool:
    """One launch on the buffers' device and its current stream, over the
    next list of `buffers` (every lane when it has none), of at most
    `max_events` events per lane; the lanes still working after it make
    the next list, whose length counts[2] holds once the launch is done.
    Does not wait for it.  Returns whether a kernel ran (not for an empty
    list)."""
    if max_events < 1:
        raise ValueError(f"max_events must be >= 1, got {max_events}")
    b = buffers
    lanes = params.n if b.n_active is None else b.n_active
    if b.n_active is None and b.lists[1].shape[0] < params.n:
        # Room for every lane (a state grows only before a list-less launch)
        b.lists = [torch.empty(params.n, dtype=torch.int32,
                               device=b.device) for _ in range(2)]
    params.active = None if b.n_active is None else b.lists[0].data_ptr()
    params.next = b.lists[1].data_ptr()
    params.n_active = lanes
    params.counts = b.counts.data_ptr()
    params.max_events = int(max_events)
    sms, per_sm = resident_blocks(params, b.device)
    params.blocks = grid_blocks(lanes, sms, per_sm)
    if b.n_active is None:
        b.grid = (params.blocks, sms, per_sm)
    lib = load_library()
    with torch.cuda.device(b.device):
        b.counts[2:4].zero_()
        if lanes > 0:
            stream = torch.cuda.current_stream().cuda_stream
            launch = getattr(lib, f"nt_sweep_launch{_suffix(params)}")
            build.check_launch(lib, launch(ctypes.byref(params), stream),
                               "sweep kernel")
    b.lists.reverse()               # the next list is the next launch's
    return lanes > 0

