"""Segment deposit: a line segment's energy into the cells it crosses.

Port of `neutral_tpu/raster.py`'s deposit semantics.  A flight piece
(flight.py) leaves one segment row [gx0, gy0, gx1, gy1, kk] in cell units
over the full cells it crossed; each cell receives kk times the fraction
of the segment inside it, the clipped overlap

    kk * max(0, min(tx_out, ty_out) - max(tx_in, ty_in))

in the segment's parameter t.  The TPU computed it in two Pallas kernels
(raster.py::_raster_kernel over sorted segment x tile pairs, and
::_walk_kernel over a VMEM-resident buffer); the port has one CUDA kernel
(raster_kernel.py, csrc/raster.cu) that walks each segment's cells.

`deposit_segments_plain` is its plain version: `neutral_tpu.raster.
rasterize_xla`'s walk in PyTorch, with its conventions — the start cell
is clipped into the grid, fractions that fall off the grid are dropped,
and axis-parallel extents are nudged to 1e-12 so their reciprocal stays
finite.
"""

from __future__ import annotations

import torch

from .xs import const

_BIG = 1.0e30
_TINY = 1.0e-12


def _clipfloor(u: torch.Tensor, n: int) -> torch.Tensor:
    return torch.floor(u).to(torch.int32).clamp(0, n - 1)


def deposit_segments_plain(tally: torch.Tensor, segs: torch.Tensor,
                           nx: int, ny: int) -> None:
    """Add every segment row of `segs` (nseg, >=5) into the flat (ny*nx,)
    `tally` in place, one DDA step per cell (rasterize_xla's arithmetic).

    Each step adds kk * frac at the current cell, then moves to the
    neighbour across the nearer of the two cell walls; a segment ends when
    its parameter reaches 1, after at most nx + ny + 2 steps.  Finished
    segments leave the working set as it halves.
    """
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
