"""The stored-table cross-section lookup on its own (csrc/table.cu).

The sweep and flight kernels look stored tables up inside their events
(csrc/common.cuh `table_lookup`, over `xs.TableLayout`).
`table_lookup_kernel` runs that device function over a tensor of
energies, so that the lookup can be held alone to its plain versions and
timed: `xs.TableLayout.lookup` (the same two-level search in plain
PyTorch) and `xs.CrossSection.lookup` (torch.searchsorted, the gathers and
the interpolation).  It launches the kernel or raises: on energies that do
not lie on the layout's CUDA device, and on anything but float32 or
float64 energies and a table of one dtype (the kernel's two
instantiations).
`table_lookup_kernel.launches` counts its own launches; callers may reset
it.

`PROBE_TABLES`, `probe_table` and `probe_energies` are the tables and
energies that the lookup is held to its plain versions on, in the CPU
tests, the `cuda` tests and chip_smoke.py: the 30,000-entry resampled
resonance table, tables on both sides of every size at which the coarse
stride changes, and runs of equal keys across the coarse index's entries;
every key, one ulp either side, both ends, 0, +-inf and NaN.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .xs import COARSE_KEYS, TableLayout, resonance_log_table

# Table sizes: the smallest, both sides of every stride change up to S = 2
# and S = 4, a power of two, and one with S = 64 > 16.
PROBE_SIZES = (2, 3, COARSE_KEYS - 1, COARSE_KEYS, COARSE_KEYS + 1,
               2 * COARSE_KEYS + 1, 1 << 15, 64 * COARSE_KEYS - 3)
PROBE_TABLES = ("resonance", "runs", *(f"n{n}" for n in PROBE_SIZES))


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = build.load()
    for sfx in _SUFFIX.values():
        blocks = getattr(lib, f"nt_table_lookup_blocks{sfx}")
        blocks.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
        blocks.restype = ctypes.c_int
        launch = getattr(lib, f"nt_table_lookup_launch{sfx}")
        launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        launch.restype = ctypes.c_int
    return lib


# The entry-point suffix of each working type of the kernel.
_SUFFIX = {torch.float32: "", torch.float64: "_f64"}


@functools.cache
def max_blocks(n: int, shift: int, device: torch.device,
               dtype: torch.dtype = torch.float32) -> int:
    """Blocks of the lookup kernel in `dtype` that `device` (an indexed
    CUDA device) holds at once for an n-entry table of coarse shift
    `shift`, from the CUDA occupancy calculator; read once per process,
    device, size and dtype."""
    lib = load_library()
    blocks = ctypes.c_int()
    query = getattr(lib, f"nt_table_lookup_blocks{_SUFFIX[dtype]}")
    with torch.cuda.device(device):
        build.check_launch(lib, query(n, shift, ctypes.byref(blocks)),
                           "table lookup occupancy query")
    return blocks.value


def table_lookup_kernel(layout: TableLayout, energy: torch.Tensor,
                        index: bool = False):
    """The interpolated cross-section at each of `energy` (float32 or
    float64, the layout's dtype, on its CUDA device), as the kernels'
    table mode computes it, on the current stream; with `index`, also the
    bracketing indices (int32).  Returns values, or (values, indices)."""
    dev = layout.keys.device
    if dev.type != "cuda" or energy.device != dev:
        raise ValueError(f"table lookup kernel needs the energies and the "
                         f"table on one CUDA device, got {energy.device} "
                         f"and {dev}")
    if energy.dtype not in _SUFFIX or layout.keys.dtype != energy.dtype:
        raise ValueError(f"table lookup kernel takes float32 or float64 "
                         f"energies and a table of their dtype, got "
                         f"{energy.dtype} energies, {layout.keys.dtype} table")
    energy = energy.contiguous()
    value = torch.empty_like(energy)
    idx = (torch.empty(energy.shape, dtype=torch.int32, device=dev)
           if index else None)
    if energy.numel() > 0:
        lib = load_library()
        grid = max_blocks(layout.nentries, layout.shift, dev, energy.dtype)
        launch = getattr(lib,
                         f"nt_table_lookup_launch{_SUFFIX[energy.dtype]}")
        with torch.cuda.device(dev):
            build.check_launch(lib, launch(
                energy.data_ptr(), value.data_ptr(),
                None if idx is None else idx.data_ptr(), energy.numel(),
                layout.keys.data_ptr(), layout.intervals.data_ptr(),
                layout.coarse.data_ptr(), layout.nentries, layout.shift,
                grid, torch.cuda.current_stream().cuda_stream),
                "table lookup kernel")
        table_lookup_kernel.launches += 1
    return (value, idx) if index else value


table_lookup_kernel.launches = 0


def sized_table(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """An n-entry table: float32 keys log-spaced over [1e-2, 1e8] eV with
    jitter, ascending, and wiggly descending float32 values."""
    rng = np.random.default_rng(seed)
    keys = np.sort(np.logspace(-2.0, 8.0, n)
                   * (1.0 + 0.05 * rng.random(n) / n)).astype(np.float32)
    keys = np.maximum.accumulate(keys)
    u = np.linspace(0.0, 1.0, n)
    values = 1.0 + 1e3 * (1.0 - u) * (1.0 + 0.2 * np.sin(37.0 * u))
    return keys, values.astype(np.float32)


def runs_table() -> tuple[np.ndarray, np.ndarray]:
    """5,000 entries (S = 4) whose keys repeat in runs of 1 to 13 that
    start and end on and across the coarse index's entries (j * 4), the
    first and the last keys repeated too."""
    keys, values = sized_table(5000, seed=3)
    rng = np.random.default_rng(4)
    i = 0
    while i < keys.shape[0]:
        run = int(rng.integers(1, 14))
        keys[i:i + run] = keys[i]
        i += run
    keys[:5] = keys[0]
    keys[-6:] = keys[-1]
    return keys, values


def probe_table(name: str) -> tuple[np.ndarray, np.ndarray]:
    """A table of PROBE_TABLES by name, float32 keys and values:
    "resonance" (xs.resonance_log_table, 30,000 entries), "runs"
    (runs_table) or "n<size>" (sized_table)."""
    if name == "resonance":
        keys, values = resonance_log_table()
        return keys.astype(np.float32), values.astype(np.float32)
    if name == "runs":
        return runs_table()
    return sized_table(int(name[1:]))


def probe_energies(keys: np.ndarray, count: int,
                   seed: int = 0) -> np.ndarray:
    """float32 energies for a table's `keys`: every key, one ulp above and
    below each, below the first key, at and above the last, 0, +-inf and
    NaN, then `count` log-uniform over [1e-3, 1e9] eV (past both ends of
    the probe tables)."""
    rng = np.random.default_rng(seed)
    k = keys.astype(np.float32)
    inf = np.float32(np.inf)
    return np.concatenate([
        k, np.nextafter(k, inf), np.nextafter(k, -inf),
        [k[0] / 2, np.nextafter(k[0], -inf), k[-1], k[-1] * 2, 0.0, inf,
         -inf, np.nan],
        10.0 ** rng.uniform(-3.0, 9.0, count)]).astype(np.float32)
