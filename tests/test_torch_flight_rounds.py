"""The flight kernel's launch loop, on the CPU through its plain versions.

A census on the card runs in rounds (neutral_tpu_torch.flight_kernel):
each launch covers a list of working lanes (all lanes in the first),
runs some pieces per lane (`pieces_for`), and may refuse segment rows
when the buffer is full, the lane then stopping before that piece; the
host grows the buffer (`grown_rows`) and the deposit reads
`rows_written` rows.  `flight.flight_round_plain` is one such launch in
plain PyTorch, so these tests drive the same rounds on the CPU: under
every schedule, with and without lists, with refusals and under a
window, the census must equal `flight.flight_chunk_plain` bitwise (event
counts, all 14 per-lane fields, the segment rows as a sorted multiset;
tally sums to summation order), and over whole steps in float64 the
counts must equal JAX's flight engine, as
tests/test_torch_flight.py::test_flight_path_matches_jax_flight_f64
holds the plain driver to it.  The families are those of
tests/test_torch_flight.py (400 particles, 64x64 mesh).
"""

import functools

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver, flight, flight_kernel, transport
from neutral_tpu_torch.flight_kernel import (FIRST_PIECES, RUN_OUT,
                                             FlightBuffers, grown_rows,
                                             pieces_for, rows_written)
from neutral_tpu_torch.particles import STATE_FIELDS
from neutral_tpu_torch.raster_kernel import TILE, TILES
from test_torch_flight import FAMILIES, make_cfg, run_jax

RESIDENT = 64        # lanes "on the card at once" of the growing schedule

SCHEDULES = {
    "one": lambda k, lanes: 1,
    "three": lambda k, lanes: 3,
    "sixty_four": lambda k, lanes: 64,
    "growing": lambda k, lanes: pieces_for(k, lanes, RESIDENT),
    "to_end": lambda k, lanes: RUN_OUT,
}


def census_start(kind, dtype):
    """(simulation, step 1's begin_timestep state, the census's arguments
    after the geometry) of a family."""
    cfg = make_cfg(tt, kind, dtype=dtype)
    sim = driver.Simulation(cfg, device="cpu", transport="flight",
                            quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    args = (sim.cs_scatter, sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    return sim, start, args


@functools.cache
def chunk_reference(kind, dtype, window=None):
    """flight_chunk_plain's census of step 1: (state, nf, nc, rows,
    tally sum, sweeps)."""
    sim, start, args = census_start(kind, dtype)
    geom, win, tally = windowed(sim, window)
    segs = []
    state, nf, nc, sweeps, _ = flight.flight_chunk_plain(
        start.clone(), tally, geom, *args, segments=segs, **win)
    return (state, nf, nc, sorted_rows(segs), float(tally.double().sum()),
            sweeps)


def windowed(sim, window):
    """(geom, {x_off, y_off}, tally) of a census in `window` = (x_off,
    y_off, nx, ny), or of none."""
    import dataclasses
    if window is None:
        return sim.geom, {}, torch.zeros_like(sim.tally)
    x_off, y_off, nx, ny = window
    geom = dataclasses.replace(sim.geom, nx=nx, ny=ny)
    return (geom, {"x_off": x_off, "y_off": y_off},
            torch.zeros(nx * ny, dtype=sim.tally.dtype))


def sorted_rows(segs):
    rows = torch.cat(segs).numpy()
    return rows[np.lexsort(rows.T[::-1])]


def run_rounds(state, tally, geom, args, schedule, compact=True, rows=None,
               max_rows=None, segments=None, win=None):
    """The kernel loop's rounds in plain PyTorch: (state, nf, nc, rounds,
    refusals, lanes per round).  `rows`/`max_rows` size the segment buffer
    as FlightBuffers does (None: unbounded)."""
    win = win or {}
    active, nf, nc, k, refusals, lanes = None, 0, 0, 0, 0, []
    while True:
        lanes.append(state.n if active is None else active.numel())
        got = []
        state, nxt, f, c, reserved = flight.flight_round_plain(
            state, tally, geom, *args, active, schedule(k, lanes[-1]),
            rows=rows, segments=got, **win)
        if rows is not None:
            assert got[0].shape[0] == rows_written(reserved, rows)
            if reserved > rows:
                refusals += 1
                rows = grown_rows(rows, reserved, max_rows)
        if segments is not None:
            segments.extend(got)
        nf, nc, k = nf + f, nc + c, k + 1
        if nxt.numel() == 0:
            return state, nf, nc, k, refusals, lanes
        active = nxt if compact else None


def assert_equal_census(kind, dtype, state, nf, nc, segs, tally, window=None):
    ref_state, ref_nf, ref_nc, ref_rows, ref_sum, _ = chunk_reference(
        kind, dtype, window)
    assert (nf, nc) == (ref_nf, ref_nc)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(state, f), getattr(ref_state, f)), f
    np.testing.assert_array_equal(sorted_rows(segs), ref_rows)
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert abs(float(tally.double().sum()) - ref_sum) <= tol * abs(ref_sum)


# ---------------------------------------------------------------------------
# schedules, lists and refusals against the whole census
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compact", [True, False], ids=["list", "no_list"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", FAMILIES)
def test_rounds_equal_chunk_plain(kind, dtype, schedule, compact):
    """Step 1's census in rounds of the schedule equals flight_chunk_plain
    bitwise; with lists, after the first round no round covers a lane
    without work."""
    sim, start, args = census_start(kind, dtype)
    tally, segs = torch.zeros_like(sim.tally), []
    state, nf, nc, k, _, lanes = run_rounds(
        start.clone(), tally, sim.geom, args, SCHEDULES[schedule], compact,
        segments=segs)
    assert_equal_census(kind, dtype, state, nf, nc, segs, tally)
    assert lanes[0] == start.n
    if compact:
        assert all(n > 0 for n in lanes[1:])
        assert lanes == sorted(lanes, reverse=True)
    if schedule == "one":
        assert k == chunk_reference(kind, dtype)[5]
    if schedule == "to_end":
        assert k == 1


@pytest.mark.parametrize("kind", ["stream", "csp", "split"])
def test_refused_rows_resume_bitwise(kind):
    """A segment buffer of 4 rows, grown by the host rule up to 64: rows
    are refused in many rounds, no row is lost, and the census still
    equals flight_chunk_plain bitwise."""
    sim, start, args = census_start(kind, "float32")
    tally, segs = torch.zeros_like(sim.tally), []
    state, nf, nc, k, refusals, _ = run_rounds(
        start.clone(), tally, sim.geom, args, SCHEDULES["growing"],
        rows=4, max_rows=64, segments=segs)
    assert_equal_census(kind, "float32", state, nf, nc, segs, tally)
    assert refusals >= 2 and k > refusals


@pytest.mark.parametrize("rows", [None, 8], ids=["unbounded", "8_rows"])
def test_rounds_under_window_equal_chunk_plain(rows):
    """The split family in the 2x2 block [0, 32)^2 (vacuum) that its
    source box straddles: rounds over lists (and refused rows) equal the
    windowed flight_chunk_plain, and lanes outside the window stay
    untouched."""
    window = (0, 0, 32, 32)
    sim, start, args = census_start("split", "float32")
    geom, win, tally = windowed(sim, window)
    segs = []
    state, nf, nc, _, refusals, _ = run_rounds(
        start.clone(), tally, geom, args, SCHEDULES["growing"], rows=rows,
        max_rows=rows, segments=segs, win=win)
    assert_equal_census("split", "float32", state, nf, nc, segs, tally,
                        window)
    _, _, inside = transport.window_cells(start, geom, **win)
    assert bool((~inside).any()) and nf > 0
    for f in STATE_FIELDS:
        assert torch.equal(getattr(state, f)[~inside],
                           getattr(start, f)[~inside]), f
    assert (refusals > 0) == (rows is not None)


@pytest.mark.parametrize("kind", FAMILIES)
def test_rounds_counts_match_jax_flight_f64(kind):
    """Two steps, each census in rounds of the default schedule over lists
    with a small segment buffer: per-step counts equal JAX's flight
    engine's, and the tally agrees as in test_torch_flight.py."""
    cfg = make_cfg(tt, kind)
    sim = driver.Simulation(cfg, device="cpu", transport="flight",
                            quiet=True)
    stats = []
    for step in range(1, cfg.niters + 1):
        state = transport.begin_timestep(sim.state, sim.geom,
                                         sim.cs_scatter, cfg.dt, step)
        live = int((~state.dead).sum())
        args = (sim.cs_scatter, sim.cs_absorb, step, 1.0 / cfg.nparticles)
        sim.state, nf, nc, _, _, _ = run_rounds(
            state, sim.tally, sim.geom, args, SCHEDULES["growing"], rows=32,
            max_rows=128)
        stats.append((nf, nc, live))
    j_tally, j_stats = run_jax(kind, "flight")
    assert stats == j_stats
    t_tally = sim.host_tally()
    np.testing.assert_allclose(t_tally.sum(), j_tally.sum(), rtol=1e-11)
    np.testing.assert_allclose(t_tally, j_tally, rtol=1e-7, atol=1e-30)


# ---------------------------------------------------------------------------
# the host's rules as plain functions
# ---------------------------------------------------------------------------

def test_pieces_for_grows_then_runs_out():
    assert pieces_for(0, 10**6, 1000) == FIRST_PIECES
    assert pieces_for(0, 10, 1000) == FIRST_PIECES       # the first launch
    assert [pieces_for(k, 10**6, 1000) for k in range(1, 5)] == [
        2 * FIRST_PIECES, 4 * FIRST_PIECES, 8 * FIRST_PIECES,
        16 * FIRST_PIECES]
    assert pieces_for(3, 1000, 1000) == RUN_OUT         # fits on the card
    assert pieces_for(40, 10**6, 1000) == RUN_OUT       # capped
    assert all(pieces_for(k, n, 0) >= 1 for k in range(30) for n in (0, 1))


@pytest.mark.parametrize("cap,reserved,max_rows,want", [
    (100, 0, 1000, 100),          # nothing emitted
    (100, 100, 1000, 100),        # exactly full: nothing refused
    (100, 101, 1000, 202),        # refused: twice the rows wanted
    (100, 400, 1000, 800),
    (100, 600, 1000, 1000),       # at most the budget
    (1000, 5000, 1000, 1000),     # at the budget already: stays
    (1000, 1200, 500, 1000),      # never below the buffer it has
])
def test_segment_buffer_growth_rule(cap, reserved, max_rows, want):
    assert grown_rows(cap, reserved, max_rows) == want
    assert rows_written(reserved, cap) == min(reserved, cap)


def test_flight_buffers_start_small_and_reject_empty():
    """A new loop's buffers hold SEG_ROWS rows (not n x pieces), no list
    yet, and start a census covering every lane."""
    b = FlightBuffers(64, 64, "cpu")
    assert b.segs.shape == (flight_kernel.SEG_ROWS, 5)
    assert b.max_rows == flight_kernel.SEG_ROWS_MAX
    assert b.n_active is None and b.round == 0
    assert b.counts.tolist() == [0] * 6
    b.n_active, b.round = 7, 3
    b.start_census()
    assert b.n_active is None and b.round == 0
    assert FlightBuffers(64, 64, "cpu", rows=8, max_rows=2).max_rows == 8
    with pytest.raises(ValueError, match="at least 1 row"):
        FlightBuffers(64, 64, "cpu", rows=0)


def test_float64_segment_buffer_budgets_are_bytes():
    """The segment buffer's budgets are bytes (SEG_BYTES, SEG_BYTES_MAX):
    a float64 buffer, whose rows are 40 bytes, starts at and grows to half
    the float32 buffer's rows in the same bytes; a round that refused rows
    grows it in its own type (twice the rows wanted, up to the budget);
    its segment deposit takes float64 rows at the float64 tile side; other
    types raise."""
    f64 = torch.float64
    b32, b = FlightBuffers(64, 64, "cpu"), FlightBuffers(64, 64, "cpu",
                                                         dtype=f64)
    assert (b32.segs.dtype, b.segs.dtype) == (torch.float32, f64)
    assert b.segs.shape == (flight_kernel.SEG_ROWS // 2, 5)
    assert b.segs.nbytes == b32.segs.nbytes == flight_kernel.SEG_BYTES
    assert b.max_rows == flight_kernel.SEG_ROWS_MAX // 2
    assert b.max_rows * 40 == b32.max_rows * 20 == flight_kernel.SEG_BYTES_MAX
    assert (b.deposit.dtype, b.deposit.tile) == (f64, TILES[f64])
    assert b.deposit.ntiles == 1 and b32.deposit.tile == TILE
    for reserved, rows in ((400, 800), (10**9, b.max_rows)):
        small = FlightBuffers(64, 64, "cpu", rows=100,
                              max_rows=None if rows == b.max_rows else 1000,
                              dtype=f64)
        rec = {}
        flight_kernel.after_round(small, torch.zeros(64 * 64, dtype=f64),
                                  None, rec, [5, reserved, 0, 0], [])
        assert small.segs.shape == (rows, 5) and small.segs.dtype == f64
        assert rec == {"working": 5, "rows": 100, "refused": True,
                       "deposit_pieces": 0, "overflow": False}
        assert small.n_active == 5
    with pytest.raises(ValueError, match="float32 or float64"):
        FlightBuffers(64, 64, "cpu", dtype=torch.float16)
