"""Spatially decomposed transport: tally blocks and particle migration.

Port of `neutral_tpu/parallel/spatial.py`.  The mesh is cut into a py x px
grid of blocks of rows x cols cells; shard s = iy * px + ix owns block
(iy, ix): the window [ix*cols, (ix+1)*cols) x [iy*rows, (iy+1)*rows), its
private tally block and, for a grid deck, its block of the density.
`SpatialSimulation` cuts y-slabs (px = 1), `Spatial2DSimulation` 2D
blocks.  An axis that is not cut has no window on it (offset None), as
in JAX.

Each shard injects the pids born in its block (source_cells: the birth
cell is a function of the pid alone), so the global pid streams do not
depend on the decomposition.  Lanes that leave their window freeze there
(the windowed kernels and plain versions); the loop of common.py then
sends each one straight to its owner, which keeps a lane's deposit, RNG
counter and all.  Capacity starts at each shard's own lanes and grows
where arrivals find no dead slot; the JAX package's 2x headroom, its
transfer budgets and its repartition on overflow have no counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..census import new_shard
from ..particles import source_cells
from .common import DecomposedSimulation


def factor_grid(ndev: int, nx: int, ny: int) -> tuple[int, int]:
    """(py, px) near-square factorization with py | ny and px | nx."""
    best = None
    for py in range(1, ndev + 1):
        if ndev % py:
            continue
        px = ndev // py
        if ny % py or nx % px:
            continue
        score = abs(py - px)
        if best is None or score < best[0]:
            best = (score, py, px)
    if best is None:
        raise ValueError(f"cannot factor {ndev} devices over {nx}x{ny} mesh")
    return best[1], best[2]


class SpatialSimulation(DecomposedSimulation):
    """y-slab decomposition with particle migration."""

    decomposition = "spatial"
    migrates = True

    def shard_grid(self) -> tuple[int, int]:
        """(py, px) of the decomposition."""
        if self.cfg.ny % self.nshards:
            raise ValueError(f"ny={self.cfg.ny} not divisible by "
                             f"{self.nshards} shards")
        return self.nshards, 1

    def grid_note(self) -> str:
        return (f", {self.py}x{self.px} blocks of {self.rows}x{self.cols} "
                "cells")

    def owner(self, cellx: torch.Tensor, celly: torch.Tensor) -> torch.Tensor:
        oy = (celly // self.rows).clamp(0, self.py - 1)
        ox = (cellx // self.cols).clamp(0, self.px - 1)
        return (oy * self.px + ox).to(torch.int64)

    def make_shards(self) -> list:
        cfg = self.cfg
        self.py, self.px = self.shard_grid()
        self.rows, self.cols = cfg.ny // self.py, cfg.nx // self.px
        src = self.source()
        pid = torch.arange(cfg.nparticles, device=self.device)
        _, _, cellx, celly = source_cells(
            self.mesh, pid, source_x0=src["source_x0"],
            source_y0=src["source_y0"], source_width=src["source_width"],
            source_height=src["source_height"], dtype=self.dtype,
            rng_scheme=cfg.rng)
        owner = self.owner(cellx, celly)
        shards = []
        for s in self.local:
            dev = self.devices[s]
            iy, ix = divmod(s, self.px)
            y0, x0 = iy * self.rows, ix * self.cols
            density = self.geom.density
            if density is not None:
                density = density.reshape(cfg.ny, cfg.nx)[
                    y0:y0 + self.rows, x0:x0 + self.cols].reshape(-1)
            geom = dataclasses.replace(self.geom, nx=self.cols,
                                       ny=self.rows, density=density)
            shards.append(new_shard(
                self, dev, geom, pid[owner == s],
                x_off=x0 if self.px > 1 else None,
                y_off=y0 if self.py > 1 else None))
        return shards

    def tally_part(self, tally: np.ndarray, s: int) -> np.ndarray:
        """Shard s's block of the flat global tally, row-major."""
        iy, ix = divmod(s, self.px)
        return np.ascontiguousarray(
            np.asarray(tally).reshape(self.cfg.ny, self.cfg.nx)[
                iy * self.rows:(iy + 1) * self.rows,
                ix * self.cols:(ix + 1) * self.cols]).reshape(-1)

    def host_tally(self) -> np.ndarray:
        """Flat (ny*nx,) global tally assembled from the shards' blocks, in
        float64 on the host."""
        grid = np.zeros((self.cfg.ny, self.cfg.nx))
        for s, tally in enumerate(self.shard_tallies()):
            iy, ix = divmod(s, self.px)
            grid[iy * self.rows:(iy + 1) * self.rows,
                 ix * self.cols:(ix + 1) * self.cols] = (
                tally.reshape(self.rows, self.cols))
        return grid.reshape(-1)


class Spatial2DSimulation(SpatialSimulation):
    """2D (x, y) block decomposition with particle migration: `grid` =
    (py, px), by default the near-square factor_grid."""

    decomposition = "spatial2d"

    def __init__(self, cfg, *, grid: tuple[int, int] | None = None, **kw):
        self.grid = grid
        super().__init__(cfg, **kw)

    def shard_grid(self) -> tuple[int, int]:
        cfg = self.cfg
        py, px = self.grid or factor_grid(self.nshards, cfg.nx, cfg.ny)
        if py * px != self.nshards or cfg.ny % py or cfg.nx % px:
            raise ValueError(
                f"grid {py}x{px} must use all {self.nshards} devices and "
                f"divide the {cfg.nx}x{cfg.ny} mesh")
        return py, px
