"""The flight kernel (csrc/flight.cu) and one round of its host loop.

Counterpart of `neutral_tpu/pallas_flight.py`.  The kernel runs lanes to
census or death, one thread per working lane, in rounds.  A round
(`flight_round`) is one flight launch and one segment deposit
(raster_kernel.py) of the launch's rows; then one host read of the
counters, and the host's part of the round (`after_round`).  The census
loop (census.py: `census.flight_chunk_kernel` for one state, and the
decompositions' shards) runs rounds until no lane works.

- *Lanes.*  A census's first launch covers every lane.  Each launch
  writes the lanes still working after it into a list, whose length is
  the counter the host reads; the next launch runs over that list alone,
  with a grid sized from that length.  The two lists swap between rounds.
- *Pieces.*  `max_pieces` means exactly that: pieces per lane per launch.
  By default they follow the census tail (`pieces_for`): few in the first
  launch, where short and long histories share every warp, then growing
  while the list shrinks, and in the end as many as the lanes need.
- *Segment rows.*  A piece that emits a row reserves it first; when the
  buffer is full the lane stops before that piece and goes on next round
  (csrc/flight.cu), so no row is dropped and the buffer bounds only the
  rows of one launch.  After a round that refused rows the host grows the
  buffer to GROWTH times the rows wanted, up to a byte budget
  (`grown_rows`); the deposit reads min(rows reserved, capacity)
  (`rows_written`).
- *Deposit.*  After an overflow of the deposit's piece buffer the host
  grows it and deposits the same rows again (`redeposit`, in the span
  nt.flight.redeposit) before the next round.  The overflowed launch
  deposited nothing; its device time is kept apart (`event_phases`).

All per-history state lives in the state tensors between launches, each
lane at its own index, so the rounds, the lists and the refusals change
nothing in the result.  The buffers of all this (`FlightBuffers`) are kept
between censuses by the caller.

The kernel's modes follow the deck: analytic cross-sections or stored
tables, threefry or pcg64si draws (csrc/flight.cu); the rects are device
arrays of any length.  Each mode has a float32 and a float64 instantiation
(the working type of the state, the rects' densities and the segment rows;
positions global in both, as flight.py keeps them), each with a tally of
either type (SimConfig.tally_dtype): `_FlightParams` and `_FlightParams64`
are the layouts with a tally of the state's type, `_FlightParams32t64`
and `_FlightParams64t32` those of the mixed pairs (`_LAYOUTS`), and the
segment deposit takes the rows' type and the tally's (raster_kernel.py).
The spatial window of a decomposed run (`x_off`/`y_off`, flight.py's) is
a runtime parameter.  `flight_params` raises on a state that does not lie
on a CUDA device and on any configuration the kernel does not implement.
The plain version is `flight.flight_chunk_plain`, and that of one launch
`flight.flight_round_plain`.

A round's CUDA events ("marks", one dict a deposit launch) time its flight
launch and its deposit's two stages, the bins and the tiles (raster_kernel
`stages`); `event_phases` sums them into the step's device phases.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .particles import ParticleState
from .profiler import span
from .raster_kernel import (GROWTH, SegmentDeposit, deposit_segments_kernel,
                            redeposit_segments)
from .sweep_kernel import (REALS, TABLE_POINTERS, check_inputs,
                           state_pointers, table_fields, window_fields)
from .transport import Geometry
from .xs import CrossSection

# The segment buffer's budgets are bytes: a row is 5 values of the working
# type, 20 bytes in float32 and 40 in float64.
SEG_BYTES = 80 << 20       # a new segment buffer (4M float32 rows)
SEG_BYTES_MAX = 5 << 28    # what it may grow to (1.25 GiB, 64M float32 rows)
SEG_ROWS = SEG_BYTES // 20          # float32 rows of a new buffer
SEG_ROWS_MAX = SEG_BYTES_MAX // 20  # float32 rows it may grow to
FIRST_PIECES = 16          # pieces per lane of a census's first launch
RUN_OUT = 1 << 14          # pieces of a launch that runs its lanes out


def seg_rows(nbytes: int, dtype: torch.dtype) -> int:
    """Segment rows of `dtype` that `nbytes` bytes hold."""
    return nbytes // (5 * dtype.itemsize)


def _flight_fields(real, tally=None) -> list:
    """`FlightParamsT<Real, Tally>`'s fields in csrc/flight.cu, its scalars
    of the ctypes type `real` but inv_ntotal, of `tally` (None: `real`)."""
    return (
        [(f, ctypes.c_void_p) for f in (
            "x", "y", "omega_x", "omega_y", "energy", "weight",
            "dt_to_census", "mfp_to_collision", "deposit", "cellx",
            "celly", "dead", "pid", "counter", "tally", "segs", "counts",
            "active", "next", *TABLE_POINTERS, "scatter_grid", "absorb_grid",
            "rect_bounds", "rect_density")]
        + [("master_key", ctypes.c_uint64), ("n", ctypes.c_int64),
           ("n_active", ctypes.c_int64), ("seg_cap", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in (
            "max_pieces", "nx", "ny", "scatter_entries", "absorb_entries",
            "scatter_shift", "absorb_shift", "same_xs", "nrects", "xs_mode",
            "rng", "x_off", "y_off", "global_nx", "global_ny")]
        + [(f, real) for f in ("dx", "dy", "inv_dx", "inv_dy")]
        + [("inv_ntotal", tally or real)])


class _FlightParams(ctypes.Structure):
    """Mirror of `FlightParams` (float32) in csrc/flight.cu."""
    _fields_ = _flight_fields(ctypes.c_float)


class _FlightParams64(ctypes.Structure):
    """Mirror of `FlightParams64` (float64) in csrc/flight.cu."""
    _fields_ = _flight_fields(ctypes.c_double)


class _FlightParams32t64(ctypes.Structure):
    """Mirror of `FlightParams32t64` (a float32 state, a float64 tally) in
    csrc/flight.cu."""
    _fields_ = _flight_fields(ctypes.c_float, ctypes.c_double)


class _FlightParams64t32(ctypes.Structure):
    """Mirror of `FlightParams64t32` (a float64 state, a float32 tally) in
    csrc/flight.cu."""
    _fields_ = _flight_fields(ctypes.c_double, ctypes.c_float)


# The parameter layout and entry-point suffix of each (state, tally) pair.
_LAYOUTS = {(torch.float32, torch.float32): (_FlightParams, ""),
            (torch.float64, torch.float64): (_FlightParams64, "_f64"),
            (torch.float32, torch.float64): (_FlightParams32t64, "_f32t64"),
            (torch.float64, torch.float32): (_FlightParams64t32, "_f64t32")}


def _types(params: ctypes.Structure) -> tuple:
    """(working type, tally type) of a parameter layout."""
    return next(pair for pair, (cls, _) in _LAYOUTS.items()
                if type(params) is cls)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = build.load()
    for cls, sfx in _LAYOUTS.values():
        size = getattr(lib, f"nt_flight_params_size{sfx}")
        size.argtypes, size.restype = [], ctypes.c_int
        launch = getattr(lib, f"nt_flight_launch{sfx}")
        launch.argtypes = [ctypes.POINTER(cls), ctypes.c_void_p]
        launch.restype = ctypes.c_int
        if size() != ctypes.sizeof(cls):
            raise RuntimeError(f"csrc/flight.cu FlightParams{sfx} does not "
                               f"match flight_kernel.{cls.__name__}")
    return lib


def pieces_for(round_: int, n_active: int, resident: int) -> int:
    """Pieces per lane of a census's launch number `round_` (0: the first)
    over `n_active` lanes, on a card that holds `resident` lanes at once.

    The first launch runs FIRST_PIECES: it finds the histories that end in
    a piece or two (vacuum), which share every warp with long ones, and
    drops them from the list.  Later ones double it, so that a long
    history takes a few launches and a warp idles at most as long as it
    worked.  Once the list fits on the card at once, compacting it further
    saves nothing, and the launch runs its lanes out (RUN_OUT)."""
    if round_ > 0 and n_active <= resident:
        return RUN_OUT
    return min(FIRST_PIECES << round_, RUN_OUT)


def rows_written(reserved: int, cap: int) -> int:
    """Rows a launch wrote into a `cap`-row segment buffer when it reserved
    `reserved` (the reservations past the buffer were refused)."""
    return min(reserved, cap)


def grown_rows(cap: int, reserved: int, max_rows: int) -> int:
    """Rows of the segment buffer for the next round, after a round that
    reserved `reserved` rows of `cap`: `cap` when none was refused, else
    GROWTH times the rows wanted, at most `max_rows` (never fewer than
    `cap`)."""
    if reserved <= cap:
        return cap
    return max(cap, min(int(GROWTH * reserved), max_rows))


class FlightBuffers:
    """The flight loop's device buffers for one state of working type
    `dtype` and one (nx, ny) tally of `tally_dtype` (None: `dtype`; each
    float32 or float64) on one device, kept by the caller between
    censuses: the six counters [facets, collisions, lanes
    still working, segment rows reserved, the deposit's pieces, its
    overflow flag]; the two lane lists of a round (the launch's and the
    next, swapped after each launch); the segment buffer of `rows` (rows,
    5) rows of `dtype` (None: SEG_BYTES' worth), grown after a round that
    refused rows, up to `max_rows` (None: SEG_BYTES_MAX' worth), both in
    bytes of the rows' type; and the segment deposit's buffers, for rows of
    `dtype` into a tally of `tally_dtype`.  `n_active` is the length of the
    next launch's list, None when the next launch covers every lane (the
    first of a census, or of a shard that received migrants); `round`
    counts the census's launches."""

    def __init__(self, nx: int, ny: int, device, rows: int | None = None,
                 max_rows: int | None = None,
                 dtype: torch.dtype = torch.float32,
                 tally_dtype: torch.dtype | None = None):
        if dtype not in REALS:
            raise ValueError(f"segment rows in float32 or float64, got "
                             f"{dtype}")
        rows = seg_rows(SEG_BYTES, dtype) if rows is None else rows
        if max_rows is None:
            max_rows = seg_rows(SEG_BYTES_MAX, dtype)
        if rows < 1:
            raise ValueError(f"segment buffer needs at least 1 row, got "
                             f"{rows}")
        self.deposit = SegmentDeposit(nx, ny, device, dtype=dtype,
                                      tally_dtype=tally_dtype)
        self.device = self.deposit.device          # with its index
        self.counts = torch.zeros(6, dtype=torch.int64, device=self.device)
        self.segs = torch.empty((rows, 5), dtype=dtype, device=self.device)
        self.max_rows = max(max_rows, rows)
        self.lists = [torch.empty(0, dtype=torch.int32, device=self.device)
                      for _ in range(2)]
        self.resident = 0
        if self.device.type == "cuda":
            props = torch.cuda.get_device_properties(self.device)
            self.resident = (props.multi_processor_count
                             * props.max_threads_per_multi_processor)
        self.start_census()

    def start_census(self) -> None:
        """The next launch is a census's first: it covers every lane, and
        the counters start at 0."""
        self.n_active = None
        self.round = 0
        self.counts.zero_()


def flight_params(state: ParticleState, tally: torch.Tensor, rects: tuple,
                  geom: Geometry, scatter_tab: CrossSection,
                  absorb_tab: CrossSection, master_key: int,
                  inv_ntotal: float, x_off=None,
                  y_off=None) -> ctypes.Structure:
    """The parameters of a census's launches in the state's working type
    and the tally's type (`_LAYOUTS`), after check_inputs: `rects` is
    rect_arrays(geom.rects, dtype=the working type) and `x_off`/`y_off`
    the window (None: none).
    flight_round sets the fields of each launch (lists, pieces, segment
    buffer, counters)."""
    if geom.rects is None:
        raise ValueError("flight kernel needs geom.rects")
    check_inputs(state, tally, geom, scatter_tab, absorb_tab,
                 "flight kernel", REALS)
    if state.n >= 2**31:
        raise ValueError(f"flight kernel: lane lists are int32, so at most "
                         f"2**31 - 1 lanes, got {state.n}")
    if rects[1].dtype != state.dtype:
        raise ValueError(f"flight kernel: rect densities in "
                         f"{rects[1].dtype}, state in {state.dtype}")
    p = _LAYOUTS[(state.dtype, tally.dtype)][0]()
    state_pointers(p, state)
    p.tally = tally.data_ptr()
    table_fields(p, geom, scatter_tab, absorb_tab, state.dtype)
    p.nrects = rects[0].shape[0]
    p.rect_bounds = rects[0].data_ptr()
    p.rect_density = rects[1].data_ptr()
    p.master_key = int(master_key)
    p.n = state.n
    window_fields(p, geom, x_off, y_off)
    # ctypes rounds each Python float to float32 as np.float32 does, or
    # keeps it whole in float64, as xs.const does for the plain version
    # (inv_ntotal in the tally's type, the rest in the working type).
    p.dx, p.dy, p.inv_ntotal = geom.dx, geom.dy, inv_ntotal
    p.inv_dx, p.inv_dy = 1.0 / geom.dx, 1.0 / geom.dy
    return p


def flight_round(params: ctypes.Structure, buffers: FlightBuffers,
                 tally: torch.Tensor, geom: Geometry,
                 max_pieces: int | None = None,
                 segments: list | None = None) -> dict:
    """One round on the buffers' device and its current stream: a flight
    launch over the next list of `buffers` (every lane when it has none),
    of `max_pieces` pieces per lane (None: pieces_for), and the segment
    deposit of its rows into `tally` (geom.nx x geom.ny, the window's block
    under a window).  The rows and their count stay until the next round,
    so that `redeposit` can run the deposit again after an overflow.  When
    `segments` is a list, the round's rows are appended to it as an
    (nseg, 5) copy (a host read; for checks).  Does not wait otherwise.
    Returns the round's record: the lanes launched, the pieces per lane and
    its CUDA events as "marks": {"flight": (start, flight done),
    "deposit": (deposit start = flight done, bins done, deposit done),
    "overflow": False, which after_round sets when the deposit
    overflowed}."""
    b = buffers
    real, tally_dtype = _types(params)
    if (b.segs.dtype, b.deposit.tally_dtype) != (real, tally_dtype):
        raise ValueError(f"flight kernel: parameters of a {real} state and "
                         f"a {tally_dtype} tally beside buffers of "
                         f"{b.segs.dtype} rows into a "
                         f"{b.deposit.tally_dtype} tally")
    lanes = params.n if b.n_active is None else b.n_active
    if max_pieces is None:
        max_pieces = pieces_for(b.round, lanes, b.resident)
    if max_pieces < 1:
        raise ValueError(f"max_pieces must be >= 1, got {max_pieces}")
    if b.n_active is None and b.lists[1].shape[0] < params.n:
        # Room for every lane (a state grows only before a list-less launch)
        b.lists = [torch.empty(params.n, dtype=torch.int32,
                               device=b.device) for _ in range(2)]
    params.active = None if b.n_active is None else b.lists[0].data_ptr()
    params.next = b.lists[1].data_ptr()
    params.n_active = lanes
    params.counts = b.counts.data_ptr()
    params.segs = b.segs.data_ptr()
    params.seg_cap = b.segs.shape[0]
    params.max_pieces = int(max_pieces)
    lib = load_library()
    sfx = _LAYOUTS[(real, tally_dtype)][1]
    launch = getattr(lib, f"nt_flight_launch{sfx}")
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        b.counts[2:4].zero_()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        build.check_launch(lib, launch(ctypes.byref(params), stream),
                           "flight kernel")
        ev[1].record()
        stages = []
        deposit_segments_kernel(tally, b.segs, b.counts[3:4], geom.nx,
                                geom.ny, b.deposit, b.counts[4:6], stages)
        if segments is not None:
            n = rows_written(int(b.counts[3]), b.segs.shape[0])
            segments.append(b.segs[:n].clone())
    b.lists.reverse()               # the next list is the next launch's
    b.round += 1
    _, bins, done = stages[0]
    return {"lanes": lanes, "pieces": int(max_pieces),
            "marks": {"flight": tuple(ev), "deposit": (ev[1], bins, done),
                      "overflow": False}}


def after_round(buffers: FlightBuffers, tally: torch.Tensor, geom: Geometry,
                record: dict, ctrl, marks: list) -> None:
    """The host's part of a round after its one read of the counters
    (`ctrl` = counts[2:6] as read: lanes still working, segment rows
    reserved, the deposit's pieces, its overflow flag): deposit the rows
    again after an overflow (the round's marks flagged as overflowed, the
    re-run's appended to `marks`), grow the segment buffer after a
    refusal, and take the next list's length.  Adds to `record` the lanes
    still working, the rows written, whether rows were refused, the
    deposit's pieces ("deposit_pieces") and whether the deposit
    overflowed (a re-deposit)."""
    working, reserved, need, overflow = (int(v) for v in ctrl)
    b = buffers
    if overflow:
        record["marks"]["overflow"] = True
        with span("flight.redeposit"):
            marks.append(redeposit(tally, b, geom, need))
    cap = b.segs.shape[0]
    if reserved > cap:
        rows = grown_rows(cap, reserved, b.max_rows)
        if rows != cap:
            dtype = b.segs.dtype
            b.segs = None                     # free it before the new one
            b.segs = torch.empty((rows, 5), dtype=dtype, device=b.device)
    b.n_active = working
    record.update(working=working, rows=rows_written(reserved, cap),
                  refused=reserved > cap, deposit_pieces=need,
                  overflow=bool(overflow))


def redeposit(tally: torch.Tensor, buffers: FlightBuffers, geom: Geometry,
              need: int) -> dict:
    """After a round whose deposit overflowed (counts[5], read by the
    caller with need = counts[4]): grow the piece buffer and deposit the
    round's rows again, before the next flight launch.  Returns its marks
    as flight_round's, with no flight launch: the deposit's span runs from
    before the buffer's growth."""
    b = buffers
    with torch.cuda.device(b.device):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        stages = []
        redeposit_segments(tally, b.segs, b.counts[3:4], geom.nx, geom.ny,
                           b.deposit, b.counts[4:6], need, stages)
    _, bins, done = stages[0]
    return {"deposit": (start, bins, done), "overflow": False}


def event_phases(marks: list) -> dict:
    """Device seconds of completed rounds and re-runs (their marks): the
    flight launches ("flight"); every segment deposit launch, re-runs
    included ("raster"), split into its bin stage ("raster_bins") and its
    tile stage ("raster_tiles"), the two adding up to "raster"; and of
    "raster" the launches whose piece buffer overflowed, which deposited
    nothing ("raster_overflow").  Waits for each mark's last event: a
    re-run launched after the census's last read may still be running."""
    def seconds(a, b):
        return a.elapsed_time(b) / 1e3

    out = dict.fromkeys(("flight", "raster", "raster_bins", "raster_tiles",
                         "raster_overflow"), 0.0)
    for m in marks:
        start, bins, done = m["deposit"]
        done.synchronize()
        if "flight" in m:
            out["flight"] += seconds(*m["flight"])
        whole = seconds(start, done)
        out["raster"] += whole
        out["raster_bins"] += seconds(start, bins)
        out["raster_tiles"] += seconds(bins, done)
        if m["overflow"]:
            out["raster_overflow"] += whole
    return out


def launch_records(rounds: list) -> list:
    """The records of completed rounds without their events, each with its
    flight launch's device milliseconds ("flight_ms")."""
    out = []
    for r in rounds:
        start, done = r["marks"]["flight"]
        out.append({k: v for k, v in r.items() if k != "marks"}
                   | {"flight_ms": start.elapsed_time(done)})
    return out

