"""2D structured mesh: edge coordinates and the material density field.

Port of `neutral_tpu/mesh.py`.  Host math stays numpy float64, line for
line as in the JAX package, so the density field and the region cell
bounds come out identical; only the finished arrays become tensors.

  * edgex (nx+1,), edgey (ny+1,) — cell edge coordinates (tensors),
  * density (ny, nx) — a host array built from the deck's `problem_N`
    rectangles, later entries overwriting earlier ones (membership test:
    cell center inside the half-open box [lo, hi)), or read from the
    deck's `density_file`; `density_grid` puts it on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .config import SimConfig


@dataclass
class Mesh2D:
    nx: int
    ny: int
    width: float
    height: float
    edgex: torch.Tensor   # (nx+1,)
    edgey: torch.Tensor   # (ny+1,)
    # Edges are uniformly spaced (edge[i] = i * pitch).
    uniform: bool = True


def _load_edges(path: str, n_edges: int, extent: float) -> np.ndarray:
    """Read an edge-coordinate file (.npy or whitespace text), validated."""
    if path.endswith(".npy"):
        e = np.load(path)
    else:
        e = np.loadtxt(path, dtype=np.float64)
    e = np.asarray(e, np.float64).reshape(-1)
    if e.shape[0] != n_edges:
        raise ValueError(f"{path}: expected {n_edges} edge coordinates, "
                         f"got {e.shape[0]}")
    if not np.all(np.diff(e) > 0):
        raise ValueError(f"{path}: edge coordinates must be strictly "
                         "ascending")
    if abs(e[0]) > 1e-12 * extent or abs(e[-1] - extent) > 1e-9 * extent:
        raise ValueError(
            f"{path}: edges must span [0, {extent}] (the deck's domain "
            f"extent); got [{e[0]}, {e[-1]}]")
    e[0], e[-1] = 0.0, extent  # snap away file-format rounding
    return e


def _stretch_edges(n: int, extent: float, ratio: float) -> np.ndarray:
    """Geometric-progression edges: cell i+1 is `ratio` x cell i."""
    w = ratio ** np.arange(n, dtype=np.float64)
    e = np.concatenate([[0.0], np.cumsum(w)])
    return e * (extent / e[-1])


def build_edges(cfg: SimConfig) -> tuple[np.ndarray, np.ndarray]:
    """(edgex, edgey) float64 host arrays per the deck's mesh grammar."""
    if cfg.edgex_file:
        edgex = _load_edges(cfg.edgex_file, cfg.nx + 1, cfg.width)
    elif cfg.mesh_stretch_x != 1.0:
        edgex = _stretch_edges(cfg.nx, cfg.width, cfg.mesh_stretch_x)
    else:
        edgex = (np.arange(cfg.nx + 1, dtype=np.float64)
                 * (cfg.width / cfg.nx))
    if cfg.edgey_file:
        edgey = _load_edges(cfg.edgey_file, cfg.ny + 1, cfg.height)
    elif cfg.mesh_stretch_y != 1.0:
        edgey = _stretch_edges(cfg.ny, cfg.height, cfg.mesh_stretch_y)
    else:
        edgey = (np.arange(cfg.ny + 1, dtype=np.float64)
                 * (cfg.height / cfg.ny))
    return edgex, edgey


def _cell_centers(cfg: SimConfig) -> tuple[np.ndarray, np.ndarray]:
    """(cx, cy) float64 cell centers; uniform decks use the closed form."""
    if cfg.uniform_mesh:
        cx = (np.arange(cfg.nx) + 0.5) * (cfg.width / cfg.nx)
        cy = (np.arange(cfg.ny) + 0.5) * (cfg.height / cfg.ny)
        return cx, cy
    edgex, edgey = build_edges(cfg)
    return 0.5 * (edgex[:-1] + edgex[1:]), 0.5 * (edgey[:-1] + edgey[1:])


def build_density(cfg: SimConfig, dtype=np.float64) -> np.ndarray:
    """Density field (host numpy) from the problem regions, or the deck's
    (ny, nx) grid file."""
    if cfg.density_file:
        if cfg.density_file.endswith(".npy"):
            density = np.load(cfg.density_file)
        else:
            density = np.loadtxt(cfg.density_file, dtype=np.float64)
        density = np.asarray(density, np.float64)
        if density.shape != (cfg.ny, cfg.nx):
            raise ValueError(
                f"{cfg.density_file}: density grid shape {density.shape} "
                f"!= mesh (ny, nx) = ({cfg.ny}, {cfg.nx})")
        if np.any(density < 0) or not np.all(np.isfinite(density)):
            raise ValueError(f"{cfg.density_file}: densities must be "
                             "finite and non-negative")
        return density.astype(dtype)
    density = np.zeros((cfg.ny, cfg.nx), dtype=np.float64)
    cx, cy = _cell_centers(cfg)
    for region in cfg.problems:
        x0 = region.xpos * cfg.width
        y0 = region.ypos * cfg.height
        x1 = x0 + region.width * cfg.width
        y1 = y0 + region.height * cfg.height
        mx = (cx >= x0) & (cx < x1)
        my = (cy >= y0) & (cy < y1)
        density[np.ix_(my, mx)] = region.density
    return density.astype(dtype)


def region_cell_bounds(cfg: SimConfig) -> tuple:
    """Problem regions as global cell-index rectangles
    ((ix0, ix1, iy0, iy1, density), ...), selected with the same float64
    cell-center math as build_density."""
    cx, cy = _cell_centers(cfg)
    out = []
    for region in cfg.problems:
        x0 = region.xpos * cfg.width
        y0 = region.ypos * cfg.height
        x1 = x0 + region.width * cfg.width
        y1 = y0 + region.height * cfg.height
        mx = (cx >= x0) & (cx < x1)
        my = (cy >= y0) & (cy < y1)
        ix = np.flatnonzero(mx)
        iy = np.flatnonzero(my)
        if ix.size == 0 or iy.size == 0:
            continue
        out.append((int(ix[0]), int(ix[-1]) + 1, int(iy[0]),
                    int(iy[-1]) + 1, float(region.density)))
    return tuple(out)


def density_grid(cfg: SimConfig, dtype: torch.dtype = torch.float32,
                 device=None) -> torch.Tensor:
    """The flat (ny*nx,) density field as a tensor in `dtype`, row-major
    (flat cell = celly*nx + cellx): what a grid deck's transport gathers
    from (transport.Geometry.density)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return torch.as_tensor(build_density(cfg, np_dtype).reshape(-1),
                           device=device)


def build_mesh(cfg: SimConfig, dtype: torch.dtype = torch.float32,
               device=None) -> Mesh2D:
    """Mesh edges as tensors.

    The mesh carries no density: the analytic-region transport never reads
    the (ny, nx) grid (64 MB in f32 at 4000^2), and a grid deck's geometry
    holds it (density_grid).
    """
    edgex, edgey = build_edges(cfg)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return Mesh2D(
        nx=cfg.nx, ny=cfg.ny, width=cfg.width, height=cfg.height,
        edgex=torch.as_tensor(edgex.astype(np_dtype), device=device),
        edgey=torch.as_tensor(edgey.astype(np_dtype), device=device),
        uniform=cfg.uniform_mesh,
    )
