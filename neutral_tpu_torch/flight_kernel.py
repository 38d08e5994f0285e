"""The flight kernel (csrc/flight.cu) and its host loop.

Counterpart of `neutral_tpu/pallas_flight.py`.  `flight_chunk_kernel` runs
every lane to census or death with the hand-written CUDA flight kernel:
one thread per lane, each running up to `max_pieces` flight pieces per
launch (`max_pieces` means exactly that: pieces per lane per launch).
Flushes go into the tally by atomicAdd; segment rows go to a buffer of
n * max_pieces rows through an atomic counter, so no launch can overflow
it.  Per round the host resets the row counter, launches the flight
kernel, launches the segment-deposit kernel (raster_kernel.py) on the
buffer, whose row count it reads on the device, and reads back one slice
of the counters: how many lanes still have work, and the deposit's piece
count and overflow flag.  After an overflow it grows the deposit's piece
buffer (a `SegmentDeposit`, kept between censuses by the caller) and
deposits the same rows again (`redeposit`) before the next round.  All
per-history state lives in the state tensors between launches, so the
number of launches changes nothing in the result.

The kernel's modes follow the deck: analytic cross-sections or stored
tables, threefry or pcg64si draws (csrc/flight.cu); the rects are device
arrays of any length.  The spatial window of a decomposed run
(`x_off`/`y_off`, flight.py's) is a runtime parameter.  `flight_params`
and `flight_round` are one round (flight launch and segment deposit);
`flight_chunk_kernel` loops them for one state, and the decomposed runs
(parallel/) run a round on every shard before they read the counters of
all shards at once.  The plain version is `flight.flight_chunk_plain`.
`flight_chunk_kernel` launches the kernel or raises: on a state that does
not lie on a CUDA device, and on any configuration the kernel does not
implement.
`flight_chunk_kernel.launches` counts flight-kernel launches (made by
`flight_round`, from either loop); callers may reset it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .particles import ParticleState
from .raster_kernel import (SegmentDeposit, deposit_segments_kernel,
                            redeposit_segments)
from .sweep_kernel import (check_inputs, rect_arrays, state_pointers,
                           table_fields, window_fields)
from .transport import Geometry
from .xs import CrossSection

MAX_PIECES = 64            # flight pieces per lane per launch


class _FlightParams(ctypes.Structure):
    """Mirror of `FlightParams` in csrc/flight.cu."""
    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "x", "y", "omega_x", "omega_y", "energy", "weight",
            "dt_to_census", "mfp_to_collision", "deposit", "cellx",
            "celly", "dead", "pid", "counter", "tally", "segs", "counts",
            "scatter_keys", "scatter_values", "absorb_keys", "absorb_values",
            "rect_bounds", "rect_density")]
        + [("master_key", ctypes.c_uint64), ("n", ctypes.c_int64),
           ("seg_cap", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in (
            "max_pieces", "nx", "ny", "scatter_entries", "absorb_entries",
            "same_xs", "nrects", "xs_mode", "rng", "x_off", "y_off",
            "global_nx", "global_ny")]
        + [(f, ctypes.c_float) for f in (
            "dx", "dy", "inv_dx", "inv_dy", "inv_ntotal")])


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = build.load()
    lib.nt_flight_params_size.argtypes = []
    lib.nt_flight_params_size.restype = ctypes.c_int
    lib.nt_flight_launch.argtypes = [ctypes.POINTER(_FlightParams),
                                     ctypes.c_void_p]
    lib.nt_flight_launch.restype = ctypes.c_int
    if lib.nt_flight_params_size() != ctypes.sizeof(_FlightParams):
        raise RuntimeError("csrc/flight.cu FlightParams does not match "
                           "flight_kernel._FlightParams")
    return lib


def flight_params(state: ParticleState, tally: torch.Tensor,
                  segbuf: torch.Tensor, counts: torch.Tensor, rects: tuple,
                  geom: Geometry, scatter_tab: CrossSection,
                  absorb_tab: CrossSection, master_key: int,
                  inv_ntotal: float, max_pieces: int, x_off=None,
                  y_off=None) -> _FlightParams:
    """The parameters of one launch, after check_inputs: `segbuf` holds
    state.n * max_pieces rows, `counts` is the (6,) int64 [facets,
    collisions, lanes still working, segment rows written, the deposit's
    pieces, its overflow flag], `rects` is
    rect_arrays(geom.rects) and `x_off`/`y_off` the window (None: none)."""
    if geom.rects is None:
        raise ValueError("flight kernel needs geom.rects")
    check_inputs(state, tally, geom, scatter_tab, absorb_tab,
                 "flight kernel")
    if max_pieces < 1:
        raise ValueError(f"max_pieces must be >= 1, got {max_pieces}")
    p = _FlightParams()
    state_pointers(p, state)
    p.tally = tally.data_ptr()
    p.segs = segbuf.data_ptr()
    p.counts = counts.data_ptr()
    table_fields(p, geom, scatter_tab, absorb_tab)
    p.nrects = rects[0].shape[0]
    p.rect_bounds = rects[0].data_ptr()
    p.rect_density = rects[1].data_ptr()
    p.master_key = int(master_key)
    p.n = state.n
    p.seg_cap = segbuf.shape[0]
    p.max_pieces = int(max_pieces)
    window_fields(p, geom, x_off, y_off)
    # ctypes rounds each Python float to float32 as np.float32 does, as
    # xs.const does for the plain version.
    p.dx, p.dy, p.inv_ntotal = geom.dx, geom.dy, inv_ntotal
    p.inv_dx, p.inv_dy = 1.0 / geom.dx, 1.0 / geom.dy
    return p


def flight_round(params: _FlightParams, tally: torch.Tensor,
                 segbuf: torch.Tensor, counts: torch.Tensor, geom: Geometry,
                 device: torch.device, deposit: SegmentDeposit,
                 segments: list | None = None) -> list:
    """One round on `device`'s current stream: the reset of the row
    counter, a flight launch and the segment deposit of its rows into
    `tally` (geom.nx x geom.ny, the window's block under a window) with
    the buffers of `deposit`, which writes [pieces, overflow] to
    counts[4:6].  The rows and their count stay until the next round, so
    that `redeposit` can run the deposit again after an overflow.  When
    `segments` is a list, the round's rows are appended to it as an
    (nseg, 5) copy (a host read; for checks).  Does not wait otherwise.
    Returns the round's three CUDA events (start, flight done, deposit
    done)."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        counts[3].zero_()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        build.check_launch(
            lib, lib.nt_flight_launch(ctypes.byref(params), stream),
            "flight kernel")
        flight_chunk_kernel.launches += 1
        ev[1].record()
        deposit_segments_kernel(tally, segbuf, counts[3:4], geom.nx, geom.ny,
                                deposit, counts[4:6])
        ev[2].record()
        if segments is not None:
            segments.append(segbuf[:int(counts[3])].clone())
    return ev


def redeposit(tally: torch.Tensor, segbuf: torch.Tensor,
              counts: torch.Tensor, geom: Geometry, device: torch.device,
              deposit: SegmentDeposit, need: int) -> list:
    """After a round whose deposit overflowed (counts[5], read by the
    caller with need = counts[4]): grow the piece buffer and deposit the
    round's rows again, before the next flight launch.  Returns events as
    flight_round's, with no flight time."""
    with torch.cuda.device(device):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        redeposit_segments(tally, segbuf, counts[3:4], geom.nx, geom.ny,
                           deposit, counts[4:6], need)
        ev[1].record()
    return [ev[0], ev[0], ev[1]]


def event_phases(marks: list) -> dict:
    """Device seconds of the flight launches ("flight") and of the segment
    deposits ("raster") of rounds whose events have completed."""
    return {"flight": sum(e[0].elapsed_time(e[1]) for e in marks) / 1e3,
            "raster": sum(e[1].elapsed_time(e[2]) for e in marks) / 1e3}


def flight_chunk_kernel(state: ParticleState, tally: torch.Tensor,
                        geom: Geometry, scatter_tab: CrossSection,
                        absorb_tab: CrossSection, master_key: int,
                        inv_ntotal: float, max_pieces: int = MAX_PIECES,
                        segments: list | None = None, x_off=None,
                        y_off=None, deposit: SegmentDeposit | None = None):
    """Run every lane to census or death (or, under the window `x_off`/
    `y_off`, until it leaves the window) with the CUDA flight kernel.

    Updates `state`'s tensors and `tally` in place.  When `segments` is a
    list, each round's segment rows are appended to it (flight_round).
    `deposit` holds the segment deposit's buffers between calls (a new
    one when None).  Returns (state, nfacets, ncollisions, nlaunches,
    phases) with `phases` the device seconds of the flight launches
    ("flight") and of the segment deposits ("raster"), from CUDA events.
    """
    dev = state.device
    # [facets, collisions, lanes still working, segment rows written,
    #  pieces of the round's deposit, its overflow flag]
    counts = torch.zeros(6, dtype=torch.int64, device=dev)
    segbuf = torch.empty((state.n * max_pieces, 5), dtype=torch.float32,
                         device=dev)
    rects = (None if geom.rects is None else rect_arrays(geom.rects, dev))
    params = flight_params(state, tally, segbuf, counts, rects, geom,
                           scatter_tab, absorb_tab, master_key, inv_ntotal,
                           max_pieces, x_off, y_off)
    if deposit is None:
        deposit = SegmentDeposit(geom.nx, geom.ny, dev)
    marks = []
    nlaunches = 0
    while True:
        marks.append(flight_round(params, tally, segbuf, counts, geom, dev,
                                  deposit, segments))
        nlaunches += 1
        # One read per round; it waits for the flight launch and deposit.
        working, _, need, overflow = counts[2:].tolist()
        if overflow:
            marks.append(redeposit(tally, segbuf, counts, geom, dev, deposit,
                                   need))
        if working == 0:
            break
        counts[2].zero_()
    nf, nc = (int(v) for v in counts[:2].tolist())
    return state, nf, nc, nlaunches, event_phases(marks)


flight_chunk_kernel.launches = 0
