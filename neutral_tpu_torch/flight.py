"""Free-flight transport: one closed-form flight piece per lane per sweep.

Port of `neutral_tpu/flight.py`.  The facet-stepping engine
(transport.sweep_core) advances a particle one cell at a time.  Draws
happen only at collisions (omp3/neutral.c:234,294), and the deck's
material is constant on cell-aligned rectangles, so within one rectangle
the next event is closed-form:

    one *flight piece* = trace the ray to the nearest of
      rect exit | boundary reflection | collision | census
    crossing any number of cells at once.

The energy deposited along a piece is K * path length per cell with one K
per piece, so a piece leaves at most two tally flushes (the first cell's
accumulated deposit on leaving it, and the final cell's on death or
census, as the reference flushes) and one line segment over the full cells
in between, which raster.py deposits per cell.  Facet events are counted
as cell-boundary crossings, +1 for a reflection (omp3/neutral.c:171).
Collision physics is transport.collision_physics, unchanged, so each
history draws the same numbers as on the facet-stepping engine.

`flight_chunk_plain` is the plain version of the CUDA flight kernel
(flight_kernel.py, csrc/flight.cu), and `flight_round_plain` that of one
of its launches: a list of lanes, pieces per lane and a segment buffer of
bounded rows.  Both keep `neutral_tpu`'s operation order, so float64 runs
reproduce the JAX flight engine's event counts exactly and float32 runs on
one device reproduce the kernel's per-lane state bitwise.  Under a spatial decomposition (parallel/) `x_off`/`y_off`
place the shard's window on the mesh, as in `neutral_tpu`: rect walls
clamp to the window, lanes outside it freeze bitwise until migrated, and
flush cells and segment rows are window-local.  A decomposed run therefore
equals a single-device run over `split_rects` at the shard grid lines.
Not ported: the `gate` argument, which belongs to the TPU's rings, and the
TPU driver's buffer budgets and vetoes, which only delay a lane.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from . import raster
from .constants import BARNS, OPEN_BOUND_CORRECTION
from .particles import STATE_FIELDS, ParticleState
from .transport import (Geometry, _INV_MOLAR, _heating_response, _speed_of,
                        collision_physics, working_mask)
from .xs import CrossSection, const, to_int


def disjoint_rects(regions: tuple, nx: int, ny: int) -> tuple:
    """Partition the domain into disjoint cell-index rectangles.

    `regions` are the deck's problem_N boxes as cell-index rects
    (mesh.region_cell_bounds) with last-wins overwrite semantics, exactly
    like the reference's density set-up; uncovered cells have density 0.
    Returns ((ix0, ix1, iy0, iy1, density), ...) covering every cell once.
    Adjacent same-density strips are merged so the count stays small
    (at most a handful for the shipped decks).
    """
    xs = sorted({0, nx, *(r[0] for r in regions), *(r[1] for r in regions)})
    ys = sorted({0, ny, *(r[2] for r in regions), *(r[3] for r in regions)})
    xs = [v for v in xs if 0 <= v <= nx]
    ys = [v for v in ys if 0 <= v <= ny]

    def slab_density(x0, x1, y0, y1):
        d = 0.0
        for (ix0, ix1, iy0, iy1, dd) in regions:
            if ix0 <= x0 and x1 <= ix1 and iy0 <= y0 and y1 <= iy1:
                d = dd
        return d

    # Row bands of x-merged runs, then merge vertically-adjacent bands
    # whose run structure is identical.
    bands = []
    for j in range(len(ys) - 1):
        runs = []
        for i in range(len(xs) - 1):
            d = slab_density(xs[i], xs[i + 1], ys[j], ys[j + 1])
            if runs and runs[-1][2] == d:
                runs[-1] = (runs[-1][0], xs[i + 1], d)
            else:
                runs.append((xs[i], xs[i + 1], d))
        bands.append([ys[j], ys[j + 1], runs])
    merged = []
    for band in bands:
        if merged and merged[-1][2] == band[2] and merged[-1][1] == band[0]:
            merged[-1] = [merged[-1][0], band[1], merged[-1][2]]
        else:
            merged.append(band)
    out = []
    for (y0, y1, runs) in merged:
        for (x0, x1, d) in runs:
            out.append((int(x0), int(x1), int(y0), int(y1), float(d)))
    return tuple(out)


def split_rects(rects: tuple, xcuts, ycuts) -> tuple:
    """Split disjoint rects along global cell-index grid lines.

    A spatial decomposition with shard boundaries at `xcuts`/`ycuts`
    clamps every rect wall to the shard's window (flight_core's window),
    so its per-piece arithmetic equals a single-device run over this
    partition: the one geometric effect of the window.
    """
    out = []
    for (ix0, ix1, iy0, iy1, d) in rects:
        xs = [ix0] + [int(c) for c in sorted(set(xcuts))
                      if ix0 < c < ix1] + [ix1]
        ys = [iy0] + [int(c) for c in sorted(set(ycuts))
                      if iy0 < c < iy1] + [iy1]
        for j in range(len(ys) - 1):
            for i in range(len(xs) - 1):
                out.append((xs[i], xs[i + 1], ys[j], ys[j + 1], float(d)))
    return tuple(out)


class FlightPiece(NamedTuple):
    """One flight piece of every lane, in `neutral_tpu.flight.flight_core`'s
    order.  flush1/cell1/val1: the deposit flushed on leaving the first
    cell (omp3/neutral.c:325-327); flush2/cell2/val2: the death or census
    flush in the final cell (:247-250, :400-402); emit and p0x..kk: the
    interior segment in cell units, for raster.py (only where the piece
    crosses at least 2 cell boundaries); nf_lane: facet events."""
    state: ParticleState
    flush1: torch.Tensor
    cell1: torch.Tensor
    val1: torch.Tensor
    flush2: torch.Tensor
    cell2: torch.Tensor
    val2: torch.Tensor
    emit: torch.Tensor
    p0x: torch.Tensor
    p0y: torch.Tensor
    p1x: torch.Tensor
    p1y: torch.Tensor
    kk: torch.Tensor
    nf_lane: torch.Tensor
    is_coll: torch.Tensor


def flight_core(state: ParticleState, geom: Geometry,
                scatter_tab: CrossSection, absorb_tab: CrossSection,
                master_key: int, inv_ntotal: float,
                tally_dtype: torch.dtype, x_off=None,
                y_off=None) -> FlightPiece:
    """Advance every live lane through exactly one flight piece.

    Pure math, no tally update.  Needs geom.rects and the uniform pitch;
    positions are global coordinates (a piece spans many cells, so the
    float32 cell-local frame of the facet-stepping engine does not apply;
    cell membership is decided once per piece by a floor division).
    `x_off`/`y_off` place the window [x_off, x_off + geom.nx) x [y_off,
    y_off + geom.ny) (see the module note); None for both: no window.
    """
    if geom.rects is None or not geom.dx:
        raise ValueError("flight transport requires a uniform mesh with "
                         "disjoint constant-density rects (geom.rects)")
    dtype = state.dtype
    i32 = torch.int32
    windowed = x_off is not None or y_off is not None
    xo, yo = x_off or 0, y_off or 0
    live = working_mask(state, geom, x_off, y_off)

    dx = const(geom.dx, dtype)
    dy = const(geom.dy, dtype)
    inv_dx = const(1.0 / geom.dx, dtype)
    inv_dy = const(1.0 / geom.dy, dtype)

    # ---- current rect by cell membership (exact integer tests) -----------
    rho = torch.zeros_like(state.x)
    rix0 = torch.zeros_like(state.cellx)
    rix1 = torch.full_like(state.cellx, geom.global_nx)
    riy0 = torch.zeros_like(state.cellx)
    riy1 = torch.full_like(state.cellx, geom.global_ny)
    for (ix0, ix1, iy0, iy1, d) in geom.rects:
        inside = ((state.cellx >= ix0) & (state.cellx < ix1) &
                  (state.celly >= iy0) & (state.celly < iy1))
        rho = torch.where(inside, const(d, dtype), rho)
        rix0 = torch.where(inside, ix0, rix0)
        rix1 = torch.where(inside, ix1, rix1)
        riy0 = torch.where(inside, iy0, riy0)
        riy1 = torch.where(inside, iy1, riy1)
    if windowed:
        # The window's walls act as rect walls (split_rects).
        rix0 = rix0.clamp_min(xo)
        rix1 = rix1.clamp_max(xo + geom.nx)
        riy0 = riy0.clamp_min(yo)
        riy1 = riy1.clamp_max(yo + geom.ny)

    # ---- material state (the formulas of sweep_core) ----------------------
    sig_s = scatter_tab.lookup(state.energy)
    sig_a = sig_s if geom.same_xs else absorb_tab.lookup(state.energy)
    sig_t = sig_s + sig_a
    number_density = rho * const(_INV_MOLAR, dtype)
    mac_s = number_density * sig_s * const(BARNS, dtype)
    mac_a = number_density * sig_a * const(BARNS, dtype)
    mac_t = mac_s + mac_a
    cell_mfp = 1.0 / mac_t
    speed = _speed_of(state.energy)

    # ---- distances to the rect walls (calc_distance_to_facet,
    # omp3/neutral.c:423-471, with the cell edge replaced by the wall) ----
    obc = const(OPEN_BOUND_CORRECTION, dtype)
    u_x_inv = 1.0 / (state.omega_x * speed)
    u_y_inv = 1.0 / (state.omega_y * speed)
    wx_pos = rix1.to(dtype) * dx
    wx_neg = rix0.to(dtype) * dx - obc
    wy_pos = riy1.to(dtype) * dy
    wy_neg = riy0.to(dtype) * dy - obc
    dt_x = torch.where(state.omega_x >= 0.0, (wx_pos - state.x) * u_x_inv,
                       (wx_neg - state.x) * u_x_inv)
    dt_y = torch.where(state.omega_y >= 0.0, (wy_pos - state.y) * u_y_inv,
                       (wy_neg - state.y) * u_y_inv)
    x_wall = dt_x < dt_y
    d_exit = torch.where(x_wall, dt_x, dt_y) * speed

    d_coll = state.mfp_to_collision * cell_mfp
    d_census = speed * state.dt_to_census

    is_coll = (d_coll < d_exit) & (d_coll < d_census) & live
    is_exit = (~is_coll) & (d_exit < d_census) & live
    is_census = live & (~is_coll) & (~is_exit)

    d = torch.where(is_coll, d_coll, torch.where(is_exit, d_exit, d_census))
    d = d.clamp_min(0.0)

    # ---- endpoint and new cell --------------------------------------------
    x1 = state.x + torch.where(live, d * state.omega_x, 0.0)
    y1 = state.y + torch.where(live, d * state.omega_y, 0.0)

    pos_x = state.omega_x > 0.0
    pos_y = state.omega_y > 0.0
    exit_x = is_exit & x_wall
    exit_y = is_exit & (~x_wall)
    # Reflection: the exited wall is the domain boundary
    # (omp3/neutral.c:333-369).
    refl_x = exit_x & ((pos_x & (rix1 == geom.global_nx))
                       | ((~pos_x) & (rix0 == 0)))
    refl_y = exit_y & ((pos_y & (riy1 == geom.global_ny))
                       | ((~pos_y) & (riy0 == 0)))
    is_refl = refl_x | refl_y

    fcx = to_int(torch.floor(x1 * inv_dx), i32)
    fcy = to_int(torch.floor(y1 * inv_dy), i32)
    in_cx = torch.minimum(torch.maximum(fcx, rix0), rix1 - 1)
    in_cy = torch.minimum(torch.maximum(fcy, riy0), riy1 - 1)
    # x-exit: step across the wall (or stay in the boundary cell when
    # reflecting); the other axis clips into the rect.
    cx1 = torch.where(
        exit_x,
        torch.where(refl_x, torch.where(pos_x, rix1 - 1, rix0),
                    torch.where(pos_x, rix1, rix0 - 1)),
        in_cx)
    cy1 = torch.where(
        exit_y,
        torch.where(refl_y, torch.where(pos_y, riy1 - 1, riy0),
                    torch.where(pos_y, riy1, riy0 - 1)),
        in_cy)
    cx1 = torch.where(live, cx1, state.cellx)
    cy1 = torch.where(live, cy1, state.celly)

    # ---- facet events: boundary crossings (+1 for the reflection) ---------
    ncross = (cx1 - state.cellx).abs() + (cy1 - state.celly).abs()
    nf_lane = torch.where(live, ncross + is_refl.to(i32), 0)

    # ---- deposit bookkeeping ----------------------------------------------
    # K = deposit per unit path, constant along the piece
    # (calculate_energy_deposition, omp3/neutral.c:474-495).
    K = (state.weight * (sig_t * const(BARNS, dtype))
         * _heating_response(state.energy, sig_a, sig_t) * number_density)

    # Exit distance of the first cell (the cell-edge form of the wall math).
    ex_pos = (state.cellx + 1).to(dtype) * dx
    ex_neg = state.cellx.to(dtype) * dx - obc
    ey_pos = (state.celly + 1).to(dtype) * dy
    ey_neg = state.celly.to(dtype) * dy - obc
    cdt_x = torch.where(state.omega_x >= 0.0, (ex_pos - state.x) * u_x_inv,
                        (ex_neg - state.x) * u_x_inv)
    cdt_y = torch.where(state.omega_y >= 0.0, (ey_pos - state.y) * u_y_inv,
                        (ey_neg - state.y) * u_y_inv)
    d_head = torch.minimum(
        (torch.minimum(cdt_x, cdt_y) * speed).clamp_min(0.0), d)

    # Entry distance of the final cell along the ray.
    d_inx = torch.where(
        cx1 > state.cellx, (cx1.to(dtype) * dx - state.x) * u_x_inv,
        torch.where(cx1 < state.cellx,
                    ((cx1 + 1).to(dtype) * dx - state.x) * u_x_inv, 0.0))
    d_iny = torch.where(
        cy1 > state.celly, (cy1.to(dtype) * dy - state.y) * u_y_inv,
        torch.where(cy1 < state.celly,
                    ((cy1 + 1).to(dtype) * dy - state.y) * u_y_inv, 0.0))
    d_in = torch.minimum(
        (torch.maximum(d_inx, d_iny) * speed).clamp_min(0.0), d)
    d_in = torch.maximum(d_in, d_head)

    crossed = live & (ncross > 0)
    emit = live & (ncross >= 2)
    # A piece with exactly one crossing has no interior cells: the
    # (float-noise) gap between head and final-cell entry goes to the
    # head, so the piece deposits exactly K*d.
    d_head_eff = torch.where(emit, d_head, d_in)

    # First cell: accumulate, then flush on leaving it.
    acc1 = state.deposit + torch.where(
        live, K * torch.where(crossed, d_head_eff, d), 0.0)
    flush1 = crossed
    cell1 = (state.celly - yo) * geom.nx + (state.cellx - xo)
    inv = const(inv_ntotal, tally_dtype)
    val1 = torch.where(flush1, acc1, 0.0).to(tally_dtype) * inv

    # Final cell: the tail accumulates; flushed on death or census.
    acc2 = torch.where(crossed, K * (d - d_in), acc1)

    # ---- collision physics (shared with sweep_core) ------------------------
    (omega_x, omega_y, energy, weight, died, mfp,
     counter) = collision_physics(state, geom, scatter_tab, master_key,
                                  is_coll, mac_a, mac_t, number_density)
    omega_x = torch.where(refl_x, -omega_x, omega_x)
    omega_y = torch.where(refl_y, -omega_y, omega_y)

    flush2 = live & (died | is_census)
    cell2 = (cy1 - yo) * geom.nx + (cx1 - xo)
    val2 = torch.where(flush2, acc2, 0.0).to(tally_dtype) * inv
    deposit = torch.where(flush2, 0.0,
                          torch.where(live, acc2, state.deposit))

    # ---- interior segment in cell units (window-local: the integer shift
    # is exact, so the deposit walks the same arithmetic) -----------------
    p0x = (state.x + d_head_eff * state.omega_x) * inv_dx
    p0y = (state.y + d_head_eff * state.omega_y) * inv_dy
    p1x = (state.x + d_in * state.omega_x) * inv_dx
    p1y = (state.y + d_in * state.omega_y) * inv_dy
    if windowed:
        p0x, p1x = p0x - float(xo), p1x - float(xo)
        p0y, p1y = p0y - float(yo), p1y - float(yo)
    seg_len = (d_in - d_head_eff).clamp_min(0.0)
    kk = (K * seg_len).to(tally_dtype) * inv

    # ---- mean free path and census clock (omp3/neutral.c:317-318,
    # 396-404) --------------------------------------------------------------
    mfp = torch.where(is_exit | is_census, mfp - d / cell_mfp, mfp)
    dt_to_census = state.dt_to_census - torch.where(live, d / speed, 0.0)
    dt_to_census = torch.where(is_census, 0.0, dt_to_census)

    new_state = ParticleState(
        x=x1, y=y1, omega_x=omega_x, omega_y=omega_y, energy=energy,
        weight=weight, dt_to_census=dt_to_census, mfp_to_collision=mfp,
        deposit=deposit, cellx=cx1, celly=cy1, dead=state.dead | died,
        pid=state.pid, counter=counter)
    return FlightPiece(new_state, flush1, cell1, val1, flush2, cell2, val2,
                       emit, p0x, p0y, p1x, p1y, kk, nf_lane, is_coll)


def flight_chunk_plain(state: ParticleState, tally: torch.Tensor,
                       geom: Geometry, scatter_tab: CrossSection,
                       absorb_tab: CrossSection, master_key: int,
                       inv_ntotal: float, segments: list | None = None,
                       x_off=None, y_off=None):
    """Plain version of the flight kernel: flight pieces until no lane has
    work left (inside the window `x_off`/`y_off`, if given; the tally and
    segment rows are then window-local).

    Flushes go into the flat tally with `index_add_` after every piece.
    Segment rows [gx0, gy0, gx1, gy1, kk] are collected and deposited by
    raster.deposit_segments_plain at the end; when `segments` is a list,
    the (nseg, 5) row tensor is appended to it as well.  Returns (state,
    nfacets, ncollisions, nsweeps, phases) with `phases` the wall seconds
    of the pieces ("flight") and of the deposit ("raster"); both loops
    wait for the device on every iteration, so on CUDA these are device
    times too.
    """
    flight_chunk_plain.calls += 1
    t0 = time.perf_counter()
    nf = torch.zeros((), dtype=torch.int64, device=tally.device)
    nc = torch.zeros((), dtype=torch.int64, device=tally.device)
    rows = []
    nsweeps = 0
    while bool(working_mask(state, geom, x_off, y_off).any()):
        p = flight_core(state, geom, scatter_tab, absorb_tab, master_key,
                        inv_ntotal, tally.dtype, x_off=x_off, y_off=y_off)
        cells = torch.cat([p.cell1[p.flush1], p.cell2[p.flush2]])
        vals = torch.cat([p.val1[p.flush1], p.val2[p.flush2]])
        tally.index_add_(0, cells.to(torch.int64), vals)
        rows.append(torch.stack([p.p0x, p.p0y, p.p1x, p.p1y,
                                 p.kk.to(state.dtype)], dim=1)[p.emit])
        nf += p.nf_lane.sum()
        nc += p.is_coll.sum()
        state = p.state
        nsweeps += 1
    segs = (torch.cat(rows) if rows
            else torch.zeros((0, 5), dtype=state.dtype, device=tally.device))
    t1 = time.perf_counter()
    raster.deposit_segments_plain(tally, segs, geom.nx, geom.ny)
    if segments is not None:
        segments.append(segs)
    phases = {"flight": t1 - t0, "raster": time.perf_counter() - t1}
    return state, int(nf), int(nc), nsweeps, phases


flight_chunk_plain.calls = 0


def flight_round_plain(state: ParticleState, tally: torch.Tensor,
                       geom: Geometry, scatter_tab: CrossSection,
                       absorb_tab: CrossSection, master_key: int,
                       inv_ntotal: float, active: torch.Tensor | None,
                       pieces: int, rows: int | None = None,
                       segments: list | None = None, x_off=None, y_off=None):
    """Plain version of one flight-kernel launch: up to `pieces` flight
    pieces on the lanes `active` only (a 1-d int64 tensor of lane indices;
    None: every lane), each stopping early when it dies, reaches census or
    leaves the window `x_off`/`y_off`.

    `rows` is the segment buffer's capacity (None: no limit).  A piece
    that would emit a row past it is refused as the kernel refuses it: the
    lane stops before that piece, still working (the plain version serves
    lanes in index order, the kernel in the order of its atomics).  Every
    piece is flight_core on the whole state, the lanes not running masked
    out and left bitwise as they were, so each lane takes the same
    arithmetic as in flight_chunk_plain.  Flushes go into `tally` with
    `index_add_` after every piece; the round's rows are deposited at its
    end (raster.deposit_segments_plain) and appended to `segments` when it
    is a list.  Returns (state, next, nfacets, ncollisions, reserved):
    `next` the lanes of `active` still working, in increasing order, and
    `reserved` the rows the round asked for, refused ones included.
    """
    gate = working_mask(state, geom, x_off, y_off)
    if active is not None:
        listed = torch.zeros_like(gate)
        listed[active] = True
        gate &= listed
    run = gate.clone()
    nf = nc = 0
    reserved = 0
    out = []
    for _ in range(pieces):
        if not bool(run.any()):
            break
        # flight_core leaves lanes without work bitwise as they are, so
        # only working lanes that do not run need masking and restoring.
        gated = not torch.equal(run, working_mask(state, geom, x_off, y_off))
        masked = (dataclasses.replace(state, dt_to_census=torch.where(
            run, state.dt_to_census, 0.0)) if gated else state)
        p = flight_core(masked, geom, scatter_tab, absorb_tab, master_key,
                        inv_ntotal, tally.dtype, x_off=x_off, y_off=y_off)
        left = rows - reserved if rows is not None else p.emit.shape[0]
        refused = p.emit & (torch.cumsum(p.emit, 0) > left)
        reserved += int(p.emit.sum())
        apply = run & ~refused
        state = (ParticleState(**{
            f: torch.where(apply, getattr(p.state, f), getattr(state, f))
            for f in STATE_FIELDS}) if gated or bool(refused.any())
            else p.state)
        flush1, flush2 = p.flush1 & apply, p.flush2 & apply
        cells = torch.cat([p.cell1[flush1], p.cell2[flush2]])
        vals = torch.cat([p.val1[flush1], p.val2[flush2]])
        tally.index_add_(0, cells.to(torch.int64), vals)
        out.append(torch.stack([p.p0x, p.p0y, p.p1x, p.p1y,
                                p.kk.to(state.dtype)], dim=1)[p.emit & apply])
        nf += int(p.nf_lane[apply].sum())
        nc += int(p.is_coll[apply].sum())
        run = apply & working_mask(state, geom, x_off, y_off)
    segs = (torch.cat(out) if out
            else torch.zeros((0, 5), dtype=state.dtype, device=tally.device))
    raster.deposit_segments_plain(tally, segs, geom.nx, geom.ny)
    if segments is not None:
        segments.append(segs)
    nxt = torch.nonzero(gate & working_mask(state, geom, x_off, y_off))[:, 0]
    return state, nxt, nf, nc, reserved
