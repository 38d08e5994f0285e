"""Segment deposit: a line segment's energy into the cells it crosses.

Port of `neutral_tpu/raster.py`'s deposit semantics.  A flight piece
(flight.py) leaves one segment row [gx0, gy0, gx1, gy1, kk] in cell units
over the full cells it crossed; each cell receives kk times the fraction
of the segment inside it, the clipped overlap

    kk * max(0, min(tx_out, ty_out) - max(tx_in, ty_in))

in the segment's parameter t.  The TPU computed it in two Pallas kernels
(raster.py::_raster_kernel over sorted segment x tile pairs, and
::_walk_kernel over a VMEM-resident buffer); the port has one CUDA kernel
(raster_kernel.py, csrc/raster.cu) that bins each segment's pieces by
tally tile and deposits every tile's pieces into the tile held in shared
memory.

`deposit_segments_plain` is the function's plain version: `neutral_tpu.
raster.rasterize_xla`'s walk in PyTorch, with its conventions — the start
cell is clipped into the grid, fractions that fall off the grid are
dropped, and axis-parallel extents are nudged to 1e-12 so their
reciprocal stays finite.

`tile_pieces_plain` and `deposit_pieces_plain` are the plain versions of
the kernel's two stages, with its arithmetic.  A piece is one segment
inside one `tile` x `tile` block of cells.  The bins come from a walk over
tile walls with the same wall times (w - gx0) * ivx and step rule as the
walk over cell walls, so a segment visits exactly the tiles whose cells
the whole-segment walk visits.  Each piece then restarts that walk where
it enters its tile: at the entry wall's time, in the cell that the
whole-segment walk occupies at that time (found by comparing the other
axis's wall times with it), so that every cell receives the same kk *
frac as in `deposit_segments_plain`, seams included.
"""

from __future__ import annotations

import torch

from .xs import const, to_int

_BIG = 1.0e30
_TINY = 1.0e-12


def _clipfloor(u: torch.Tensor, n: int) -> torch.Tensor:
    return to_int(torch.floor(u), torch.int32).clamp(0, n - 1)


def _walk_setup(segs: torch.Tensor, nx: int, ny: int) -> dict:
    """Per-row quantities of the walk: start, reciprocal extents (nudged
    to 1e-12), steps and the start cell clipped into the grid."""
    dtype = segs.dtype
    gx0 = segs[:, 0]
    gy0 = segs[:, 1]
    dgx = segs[:, 2] - gx0
    dgy = segs[:, 3] - gy0
    tiny = const(_TINY, dtype)
    ivx = 1.0 / torch.where(dgx.abs() < tiny,
                            torch.where(dgx < 0.0, -tiny, tiny), dgx)
    ivy = 1.0 / torch.where(dgy.abs() < tiny,
                            torch.where(dgy < 0.0, -tiny, tiny), dgy)
    sx = (dgx > 0.0).to(torch.int32) - (dgx < 0.0).to(torch.int32)
    sy = (dgy > 0.0).to(torch.int32) - (dgy < 0.0).to(torch.int32)
    return dict(gx0=gx0, gy0=gy0, dgx=dgx, dgy=dgy, ivx=ivx, ivy=ivy,
                sx=sx, sy=sy, cx=_clipfloor(gx0, nx), cy=_clipfloor(gy0, ny),
                kk=segs[:, 4])


def deposit_segments_plain(tally: torch.Tensor, segs: torch.Tensor,
                           nx: int, ny: int) -> None:
    """Add every segment row of `segs` (nseg, >=5) into the flat (ny*nx,)
    `tally` in place, one DDA step per cell (rasterize_xla's arithmetic).

    Each step adds kk * frac at the current cell, then moves to the
    neighbour across the nearer of the two cell walls; a segment ends when
    its parameter reaches 1, after at most nx + ny + 2 steps.  Finished
    segments leave the working set as it halves.  `.calls` counts calls;
    callers may reset it.
    """
    deposit_segments_plain.calls += 1
    dtype = segs.dtype
    gx0 = segs[:, 0]
    gy0 = segs[:, 1]
    dgx = segs[:, 2] - gx0
    dgy = segs[:, 3] - gy0
    kk = segs[:, 4].to(tally.dtype)
    tiny = const(_TINY, dtype)
    big = const(_BIG, dtype)
    ivx = 1.0 / torch.where(dgx.abs() < tiny,
                            torch.where(dgx < 0.0, -tiny, tiny), dgx)
    ivy = 1.0 / torch.where(dgy.abs() < tiny,
                            torch.where(dgy < 0.0, -tiny, tiny), dgy)
    sx = (dgx > 0.0).to(torch.int32) - (dgx < 0.0).to(torch.int32)
    sy = (dgy > 0.0).to(torch.int32) - (dgy < 0.0).to(torch.int32)
    cx = _clipfloor(gx0, nx)
    cy = _clipfloor(gy0, ny)
    t_cur = torch.zeros_like(gx0)
    live = torch.ones(gx0.shape, dtype=torch.bool, device=gx0.device)
    n_live = gx0.shape[0]
    for _ in range(nx + ny + 2):
        if n_live == 0:
            break
        ex = torch.where(sx > 0, cx + 1, cx).to(dtype)
        ey = torch.where(sy > 0, cy + 1, cy).to(dtype)
        tx = torch.where(sx == 0, big, (ex - gx0) * ivx)
        ty = torch.where(sy == 0, big, (ey - gy0) * ivy)
        tn = torch.minimum(torch.minimum(tx, ty), torch.ones_like(tx))
        frac = (tn - t_cur).clamp_min(0.0).to(tally.dtype)
        # An edge crossing that rounds to just below t=1 can step cx/cy one
        # past the grid; such float-noise fractions are dropped.
        hit = live & (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
        tally.index_add_(0, (cy * nx + cx)[hit].to(torch.int64),
                         (kk * frac)[hit])
        step_x = (tx <= ty) & (tx < 1.0)
        step_y = (~step_x) & (ty < 1.0)
        cx = cx + torch.where(step_x, sx, 0)
        cy = cy + torch.where(step_y, sy, 0)
        t_cur = tn
        live = live & (t_cur < 1.0)
        n_now = int(live.sum())
        if n_now <= n_live // 2:
            keep = live.nonzero().squeeze(1)
            (gx0, gy0, kk, ivx, ivy, sx, sy, cx, cy, t_cur) = (
                v[keep] for v in (gx0, gy0, kk, ivx, ivy, sx, sy, cx, cy,
                                  t_cur))
            live = live[keep]
        n_live = n_now


deposit_segments_plain.calls = 0


def _wall_t(w: torch.Tensor, g0: torch.Tensor, iv: torch.Tensor
            ) -> torch.Tensor:
    """The segment's parameter t at the cell wall of integer coordinate
    `w`: the walk's (ex - gx0) * ivx."""
    return (w.to(g0.dtype) - g0) * iv


def tile_pieces_plain(segs: torch.Tensor, nx: int, ny: int, tile: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bins of the kernel's first stage: (offsets, pieces).

    A row visits the tiles (`tile` x `tile` cells, tile id ty * ntx + tx
    with ntx = ceil(nx / tile)) that the cell walk of
    `deposit_segments_plain` visits: it starts in the tile of its clipped
    start cell, steps across the nearer of the next x and y tile walls (x
    on a tie) while that wall's t is below 1, and stops when it leaves the
    tile grid.  `pieces` holds, for every tile in turn, the int64 indices
    of the rows that visit it, ascending; tile k's are
    pieces[offsets[k]:offsets[k + 1]].  Rows with kk == 0 deposit nothing
    and have no pieces.
    """
    ntx, nty = -(-nx // tile), -(-ny // tile)
    w = _walk_setup(segs, nx, ny)
    rows = (w["kk"] != 0).nonzero().squeeze(1)
    gx0, gy0, ivx, ivy, sx, sy, cx, cy = (
        w[k][rows] for k in ("gx0", "gy0", "ivx", "ivy", "sx", "sy", "cx",
                             "cy"))
    big = const(_BIG, segs.dtype)
    tx, ty = cx // tile, cy // tile
    live = torch.ones(rows.shape, dtype=torch.bool, device=segs.device)
    tiles, owners = [], []
    for _ in range(ntx + nty + 2):
        if not bool(live.any()):
            break
        tiles.append((ty * ntx + tx)[live])
        owners.append(rows[live])
        t_x = torch.where(sx == 0, big, _wall_t(
            torch.where(sx > 0, tx + 1, tx) * tile, gx0, ivx))
        t_y = torch.where(sy == 0, big, _wall_t(
            torch.where(sy > 0, ty + 1, ty) * tile, gy0, ivy))
        step_x = (t_x <= t_y) & (t_x < 1.0)
        step_y = (~step_x) & (t_y < 1.0)
        tx = tx + torch.where(step_x, sx, 0)
        ty = ty + torch.where(step_y, sy, 0)
        live = (live & (step_x | step_y) & (tx >= 0) & (tx < ntx)
                & (ty >= 0) & (ty < nty))
    tile_id = torch.cat(tiles).to(torch.int64) if tiles else rows
    owner = torch.cat(owners) if owners else rows
    order = torch.sort(owner, stable=True)[1]
    order = order[torch.sort(tile_id[order], stable=True)[1]]
    offsets = torch.zeros(ntx * nty + 1, dtype=torch.int64,
                          device=segs.device)
    offsets[1:] = torch.cumsum(torch.bincount(tile_id, minlength=ntx * nty),
                               0)
    return offsets, owner[order]


def _cross_cell(g0: torch.Tensor, iv: torch.Tensor, dg: torch.Tensor,
                s: torch.Tensor, c0: torch.Tensor, tidx: torch.Tensor,
                t: torch.Tensor, tile: int) -> torch.Tensor:
    """The cell along one axis that the walk occupies when it crosses the
    other axis's wall at parameter `t`, inside tile index `tidx` of this
    axis: past every wall of this axis whose t is below `t` (a wall with
    the same t comes after the crossing: ties step the other axis first,
    or this one when it is x, which the caller never asks here).  The
    estimate floor(g0 + t * dg) is corrected by comparing wall times, so
    the answer is the walk's own.  Axis-parallel rows (s == 0) stay in
    their start cell c0."""
    lo = tidx * tile
    hi = lo + tile - 1
    lo = torch.where(s > 0, torch.maximum(lo, c0), lo)
    hi = torch.where(s < 0, torch.minimum(hi, c0), hi)
    dtype = g0.dtype
    # fmin/fmax drop a NaN, so est lies in [lo, hi] and converts in range.
    est = torch.fmin(torch.fmax(g0 + t * dg, lo.to(dtype)), hi.to(dtype))
    c = torch.floor(est).to(torch.int32)
    pos = s > 0
    for _ in range(tile):            # onwards while the next wall is passed
        move = (s != 0) & torch.where(pos, (c < hi) & (_wall_t(c + 1, g0, iv)
                                                       < t),
                                      (c > lo) & (_wall_t(c, g0, iv) < t))
        if not bool(move.any()):
            break
        c = c + torch.where(pos, 1, -1) * move
    for _ in range(tile):            # back while the wall behind is not
        move = (s != 0) & torch.where(
            pos, (c > lo) & ~(_wall_t(c, g0, iv) < t),
            (c < hi) & ~(_wall_t(c + 1, g0, iv) < t))
        if not bool(move.any()):
            break
        c = c - torch.where(pos, 1, -1) * move
    return torch.where(s == 0, c0, c)


def deposit_pieces_plain(tally: torch.Tensor, segs: torch.Tensor,
                         bins: tuple[torch.Tensor, torch.Tensor], nx: int,
                         ny: int, tile: int) -> None:
    """The kernel's second stage: add every piece of `bins`
    (tile_pieces_plain's (offsets, pieces) at this `tile`) into the flat
    (ny*nx,) `tally` in place.

    A piece restarts its row's cell walk where the row enters the tile:
    in the tile of its clipped start cell at t = 0 from that cell;
    elsewhere at the t of the tile wall crossed last (the x wall if the
    y wall's t is below it, else the y wall), in the first cell past that
    wall and, along the other axis, the cell that `_cross_cell` finds.  It
    then walks as `deposit_segments_plain` does until it leaves the tile
    or t reaches 1, adding kk * frac to each cell inside the grid.
    """
    offsets, pieces = bins
    dtype = segs.dtype
    ntx = -(-nx // tile)
    ntiles = offsets.shape[0] - 1
    tile_id = torch.repeat_interleave(
        torch.arange(ntiles, device=segs.device), offsets[1:] - offsets[:-1])
    w = _walk_setup(segs[pieces], nx, ny)
    gx0, gy0, ivx, ivy, sx, sy = (w[k] for k in ("gx0", "gy0", "ivx", "ivy",
                                                 "sx", "sy"))
    kk = w["kk"].to(tally.dtype)
    tx = (tile_id % ntx).to(torch.int32)
    ty = (tile_id // ntx).to(torch.int32)
    x_lo, y_lo = tx * tile, ty * tile

    # ---- where the piece enters its tile ----
    cross_x = tx != w["cx"] // tile
    cross_y = ty != w["cy"] // tile
    t_x = _wall_t(torch.where(sx > 0, x_lo, x_lo + tile), gx0, ivx)
    t_y = _wall_t(torch.where(sy > 0, y_lo, y_lo + tile), gy0, ivy)
    via_x = cross_x & (~cross_y | (t_y < t_x))
    via_y = cross_y & ~via_x
    zero = torch.zeros_like(gx0)
    t_cur = torch.where(via_x, t_x, torch.where(via_y, t_y, zero))
    cx = torch.where(via_x, torch.where(sx > 0, x_lo, x_lo + tile - 1),
                     torch.where(via_y, _cross_cell(gx0, ivx, w["dgx"], sx,
                                                    w["cx"], tx, t_y, tile),
                                 w["cx"]))
    cy = torch.where(via_y, torch.where(sy > 0, y_lo, y_lo + tile - 1),
                     torch.where(via_x, _cross_cell(gy0, ivy, w["dgy"], sy,
                                                    w["cy"], ty, t_x, tile),
                                 w["cy"]))

    # ---- the walk inside the tile ----
    big = const(_BIG, dtype)
    live = torch.ones(gx0.shape, dtype=torch.bool, device=segs.device)
    for _ in range(2 * tile + 2):
        live = (live & (t_cur < 1.0) & (cx >= x_lo) & (cx < x_lo + tile)
                & (cy >= y_lo) & (cy < y_lo + tile))
        if not bool(live.any()):
            break
        t_nx = torch.where(sx == 0, big,
                           _wall_t(torch.where(sx > 0, cx + 1, cx), gx0, ivx))
        t_ny = torch.where(sy == 0, big,
                           _wall_t(torch.where(sy > 0, cy + 1, cy), gy0, ivy))
        tn = torch.minimum(torch.minimum(t_nx, t_ny), torch.ones_like(t_nx))
        frac = (tn - t_cur).clamp_min(0.0).to(tally.dtype)
        hit = live & (cx < nx) & (cy < ny)
        tally.index_add_(0, (cy * nx + cx)[hit].to(torch.int64),
                         (kk * frac)[hit])
        step_x = (t_nx <= t_ny) & (t_nx < 1.0)
        step_y = (~step_x) & (t_ny < 1.0)
        cx = cx + torch.where(step_x, sx, 0)
        cy = cy + torch.where(step_y, sy, 0)
        t_cur = tn
