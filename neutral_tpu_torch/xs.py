"""Cross-section tables: generation, loading, and vectorized lookup.

Port of `neutral_tpu/xs.py`.  The reference ships two 29,999-row
`(energy_eV, cross_section_barns)` tables (capture.cs / elastic_scatter.cs,
byte-identical dummy resonance data) generated by

    energy[r] = 1e8 * (r/29999)^4 + 1e-2          for r in 1..29999
    value[r]  = 1e3 * ((30000-r)/29999) + 1       (descending)

The tables are regenerated from that formula, or read from user `.cs`
files in the reference's text format.  `CrossSection.lookup` has three
modes: analytic (keys and values in closed form, no memory reads),
quartic (O(1) bracketing index into a stored table) and searchsorted (any
ascending table: max{i : keys[i] <= E}, clipped to [0, n-2]).  The CUDA
kernels implement the analytic mode, reading its keys and values from
`analytic_grid_in(dtype)` instead of dividing, and, for any stored table, the
searchsorted index by a two-level search over the table's `TableLayout`
(csrc/common.cuh `xs_lookup`, `table_lookup`): a coarse index of every
S-th key, which each block keeps in shared memory, then the S keys of one
group, then one packed interval (keys[i], keys[i+1], values[i],
values[i+1]).  `TableLayout.index`/`.lookup` are that search in plain
PyTorch; `CrossSection.lookup` stays the plain version of the function.
On the generated grid the quartic index equals the searchsorted one for
every energy from 1e-2 eV up, which tests/test_torch_table.py checks.
Below 1e-2 eV the quartic formula takes the root of a negative number;
`to_int` sends that NaN to index 0, as XLA and the card's conversion do,
which again is searchsorted's index (tests/test_torch_lowenergy.py).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from .constants import CS_CAPTURE_FILENAME, CS_SCATTER_FILENAME

# PyTorch's CPU build computes sqrt, log and their kin with MKL's vector
# math library, which sets itself up at its first call in a process.  When
# that first call runs on several threads at once, one thread's share can
# come back wrong in its low digits (square roots of a 100,000-lane lookup,
# in some fresh processes).  One call on a tensor small enough to run on
# this thread alone sets the library up before any parallel call.
torch.sqrt(torch.ones(16))

_N_DEFAULT = 30000

# Entries of a stored table's coarse index at most: 8 KiB of float32 in
# shared memory, 16 KiB for two tables, so that the sweep kernel's 9 blocks
# a streaming multiprocessor (csrc/sweep.cu) fit beside each other; in
# float64 16 KiB and 32 KiB, within a block's default 48 KiB, beside the
# fewer blocks an SM that the float64 instantiations' registers allow.
COARSE_KEYS = 2048


def make_resonance_table(n: int = _N_DEFAULT) -> tuple[np.ndarray, np.ndarray]:
    """Regenerate the dummy resonance table (float64 host arrays)."""
    r = np.arange(1, n, dtype=np.float64)
    u = r / (n - 1)
    energy = 1.0e8 * u**4 + 1.0e-2
    value = 1.0e3 * ((n - r) / (n - 1)) + 1.0
    return energy, value


def resonance_log_table(n: int = _N_DEFAULT
                        ) -> tuple[np.ndarray, np.ndarray]:
    """The generating formula of the resonance table sampled at n
    log-spaced energies over the generated table's range.  Its keys are
    not on the quartic grid, so it takes the stored-table mode, and its
    interpolated values agree with the generated table's to 4.3e-8
    relative over 1 eV - 1 MeV: a user table that the shipped goldens still
    validate."""
    grid, _ = make_resonance_table(n)
    keys = np.geomspace(grid[0], grid[-1], n)
    r = (n - 1) * ((keys - 1.0e-2) * 1.0e-8) ** 0.25
    return keys, 1.0e3 * ((n - r) / (n - 1)) + 1.0


def find_cs_files(params_path: str | None = None
                  ) -> tuple[str, str] | None:
    """Locate user (elastic_scatter.cs, capture.cs) table files, or None.

    The reference loads both tables by fixed filename from the working
    directory (neutral_data.c:119,173-178).  We look in cwd first, then the
    deck's own directory, and require the PAIR (a lone file would silently
    mix user and generated data).
    """
    dirs = [os.getcwd()]
    if params_path:
        dirs.append(os.path.dirname(os.path.abspath(params_path)))
    for d in dirs:
        s_path = os.path.join(d, CS_SCATTER_FILENAME)
        a_path = os.path.join(d, CS_CAPTURE_FILENAME)
        if os.path.isfile(s_path) and os.path.isfile(a_path):
            return s_path, a_path
    return None


def read_cs_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a `.cs` text table (rows of `energy value`)."""
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None, :]
    return np.ascontiguousarray(data[:, 0]), np.ascontiguousarray(data[:, 1])


def write_cs_file(path: str, keys: np.ndarray, values: np.ndarray) -> None:
    """Write a table in the reference's `.cs` text format."""
    with open(path, "w") as f:
        for k, v in zip(keys, values):
            f.write(f"{k:.12e} {v:.12e}\n")


def is_quartic_grid(keys: np.ndarray, rtol: float = 1e-9) -> bool:
    """Whether `keys` follow the generated resonance grid."""
    n = keys.shape[0]
    r = np.arange(1, n + 1, dtype=np.float64)
    expect = 1.0e8 * (r / n) ** 4 + 1.0e-2
    return bool(np.allclose(keys, expect, rtol=rtol, atol=1e-12))


def const(v: float, dtype: torch.dtype) -> float:
    """The Python float `v` rounded once to `dtype` (neutral_tpu's
    `np.dtype(dtype).type(v)`), so that every constant enters the
    arithmetic already in the working precision, as in the CUDA kernel."""
    return float(np.float32(v)) if dtype == torch.float32 else float(v)


def to_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x converted to the integer `dtype` as XLA converts, and as the
    kernels' cvt instructions do (csrc `__float2int_rd`): toward zero, NaN
    to 0, values beyond the type's range saturated to its ends.  PyTorch
    on an x86 CPU gives the type's minimum for all three, so every floor
    that a NaN, an infinity or a huge value can reach converts here."""
    info = torch.iinfo(dtype)
    lo, hi = float(info.min), -float(info.min)   # both exact in any float
    inside = (x >= lo) & (x < hi)                 # False for NaN
    out = torch.where(inside, x, torch.zeros_like(x)).to(dtype)
    out = torch.where(x >= hi, info.max, out)
    return torch.where(x < lo, info.min, out)


def div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s as a true division.

    PyTorch's CUDA backend turns division by a host scalar into a
    multiplication by its reciprocal, which rounds differently; dividing
    by a device tensor keeps IEEE division, as the CUDA kernel does.
    """
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def coarse_shift(n: int) -> int:
    """log2 of the coarse index's stride S for an n-entry table: the
    smallest power of two for which ceil(n / S) <= COARSE_KEYS (S = 16 for
    30,000 entries)."""
    shift = 0
    while (n - 1) >> shift >= COARSE_KEYS:
        shift += 1
    return shift


def _bisect(arr: torch.Tensor, energy: torch.Tensor, lo: torch.Tensor,
            hi: torch.Tensor) -> torch.Tensor:
    """Per energy, the end of the run of arr[lo:hi] with !(arr[i] > energy)
    (arr ascending), by the kernel's bisection: the test of
    torch.searchsorted(right=True), so a NaN energy runs to `hi`."""
    last = arr.shape[0] - 1
    while True:
        active = lo < hi
        if not bool(active.any()):
            return lo
        mid = (lo + hi) >> 1
        up = ~(arr[mid.clamp(max=last)] > energy)
        lo = torch.where(active & up, mid + 1, lo)
        hi = torch.where(active & ~up, mid, hi)


@dataclass(frozen=True)
class TableLayout:
    """A stored table as the CUDA kernels search it (csrc/common.cuh
    `table_lookup`), made once per table (CrossSection.table_layout):

    * `keys`: the (n,) ascending keys;
    * `intervals`: (n - 1, 4) rows (keys[i], keys[i+1], values[i],
      values[i+1]), so that one interpolation is one aligned 16-byte load;
    * `coarse`: keys[0], keys[S], keys[2S], ... with S = 2**shift
      (coarse_shift), at most COARSE_KEYS entries, which each block of a
      kernel copies into shared memory.

    `index` and `lookup` are the kernels' two-level search in plain
    PyTorch: they give CrossSection.lookup_index's and lookup's results,
    bit for bit.  (The kernels start a lane's first level from its last
    lookup's position, since a collision never raises the energy; that
    changes the steps, not the result.)"""
    keys: torch.Tensor
    intervals: torch.Tensor
    coarse: torch.Tensor
    shift: int

    @property
    def nentries(self) -> int:
        return self.keys.shape[0]

    @classmethod
    def build(cls, keys: torch.Tensor, values: torch.Tensor
              ) -> "TableLayout":
        """The layout of (keys, values) on their device and in their dtype;
        raises ValueError unless both are (n,) with 2 <= n < 2**31 and the
        keys ascend (equal neighbours allowed) with no NaN."""
        n = keys.shape[0]
        if keys.ndim != 1 or tuple(values.shape) != (n,):
            raise ValueError(f"table keys {tuple(keys.shape)} and values "
                             f"{tuple(values.shape)}: want two (n,) arrays")
        if not 2 <= n < 2**31:
            raise ValueError(f"table of {n} entries: want 2 <= n < 2**31")
        if bool(torch.isnan(keys).any()) or bool((keys[1:] < keys[:-1]).any()):
            raise ValueError("table keys must ascend (equal neighbours "
                             "allowed) and hold no NaN")
        shift = coarse_shift(n)
        intervals = torch.stack([keys[:-1], keys[1:], values[:-1],
                                 values[1:]], dim=1).contiguous()
        return cls(keys.contiguous(), intervals,
                   keys[::1 << shift].contiguous(), shift)

    def index(self, energy: torch.Tensor) -> torch.Tensor:
        """max{i : keys[i] <= energy} clipped to [0, n-2] (int64), by the
        kernels' two levels: c = #{j : coarse[j] <= energy}, then the keys
        [(c - 1) S + 1, min(c S, n)) of that group."""
        n, s = self.nentries, 1 << self.shift
        zero = torch.zeros(energy.shape, dtype=torch.int64,
                           device=energy.device)
        c = _bisect(self.coarse, energy, zero, zero + self.coarse.shape[0])
        c = _bisect(self.keys, energy, ((c - 1) * s + 1).clamp(min=0),
                    (c * s).clamp(max=n))
        return (c - 1).clamp(0, n - 2)

    def lookup(self, energy: torch.Tensor) -> torch.Tensor:
        """The interpolation over interval index(energy), as the kernels
        compute it."""
        iv = self.intervals[self.index(energy)]
        k0, k1, v0, v1 = iv.unbind(-1)
        return v0 + ((energy - k0) / (k1 - k0)) * (v1 - v0)


@dataclass
class CrossSection:
    """Cross-section table with optional closed-form modes.

    `keys`/`values` are 1-D tensors in the working dtype.  `quartic` marks
    tables on the generated resonance grid (O(1) bracketing index);
    `analytic` evaluates keys and values from the generating formula and
    reads no memory.  Analytic results match the table path to float
    rounding only, so comparisons must use the same mode.
    """
    keys: torch.Tensor
    values: torch.Tensor
    quartic: bool = False
    analytic: bool = False

    @property
    def nentries(self) -> int:
        return self.keys.shape[0]

    @classmethod
    def resonance(cls, n: int = _N_DEFAULT, dtype=torch.float64,
                  analytic: bool = False, device=None) -> "CrossSection":
        keys, values = make_resonance_table(n)
        return cls(torch.as_tensor(keys, dtype=dtype, device=device),
                   torch.as_tensor(values, dtype=dtype, device=device),
                   quartic=True, analytic=analytic)

    @classmethod
    def from_file(cls, path: str, dtype=torch.float64,
                  device=None) -> "CrossSection":
        keys, values = read_cs_file(path)
        return cls(torch.as_tensor(keys, dtype=dtype, device=device),
                   torch.as_tensor(values, dtype=dtype, device=device),
                   quartic=is_quartic_grid(keys))

    # ------------------------------------------------------------------
    def lookup_index(self, energy: torch.Tensor) -> torch.Tensor:
        """Bracketing index i with keys[i] <= energy < keys[i+1] (clipped)."""
        n = self.nentries
        if self.quartic:
            u = ((energy - 1.0e-2) * 1.0e-8) ** 0.25
            # Below 1e-2 eV the root is NaN, which converts to 0 (XLA's).
            idx = to_int(torch.floor(u * float(n)), torch.int64) - 1
            idx = idx.clamp(0, n - 2)
            # Float rounding can land one bin off; nudge once each way.
            idx = torch.where(energy < self.keys[idx], idx - 1, idx)
            k_hi = self.keys[(idx + 1).clamp(0, n - 1)]
            idx = torch.where(energy >= k_hi, idx + 1, idx)
            return idx.clamp(0, n - 2)
        idx = torch.searchsorted(self.keys, energy, right=True) - 1
        return idx.clamp(0, n - 2)

    # -- closed-form grid evaluation (analytic mode) -------------------
    def _key_at(self, i: torch.Tensor, dtype) -> torch.Tensor:
        """keys[i] from the generating formula: 1e8*((i+1)/M)^4 + 1e-2."""
        t = div(i.to(dtype) + 1.0, const(float(self.nentries), dtype))
        t2 = t * t
        return const(1.0e8, dtype) * (t2 * t2) + const(1.0e-2, dtype)

    def _val_at(self, i: torch.Tensor, dtype) -> torch.Tensor:
        """values[i] from the formula: 1e3*(M - i)/M + 1."""
        m = const(float(self.nentries), dtype)
        return const(1.0e3, dtype) * div(m - i.to(dtype), m) + 1.0

    def analytic_grid_in(self, dtype: torch.dtype) -> torch.Tensor:
        """The analytic mode's keys and values at every index 0..n-1 in
        `dtype`, as one contiguous (n, 2) tensor of (key, value) rows on
        the table's device, made at first use per dtype: the grid that the
        CUDA kernels' analytic lookup reads in that working type
        (csrc/common.cuh xs_lookup).  _key_at and _val_at make it, so its
        entries are bitwise those the plain version computes in `dtype`."""
        grids = self.__dict__.setdefault("_analytic_grids", {})
        if dtype not in grids:
            i = torch.arange(self.nentries, dtype=torch.int32,
                             device=self.keys.device)
            grids[dtype] = torch.stack([self._key_at(i, dtype),
                                        self._val_at(i, dtype)], dim=1)
        return grids[dtype]

    @functools.cached_property
    def table_layout(self) -> TableLayout:
        """The stored table's TableLayout on its device, made at first use:
        what the CUDA kernels' table mode reads.  Raises ValueError for a
        table they cannot search (TableLayout.build)."""
        return TableLayout.build(self.keys, self.values)

    def _analytic_index(self, energy: torch.Tensor) -> torch.Tensor:
        """lookup_index without the one-off nudge gathers."""
        n = self.nentries
        dtype = energy.dtype
        u = torch.sqrt(torch.sqrt((energy - const(1.0e-2, dtype))
                                  * const(1.0e-8, dtype)))
        idx = to_int(torch.floor(u * const(float(n), dtype)), torch.int32) - 1
        idx = idx.clamp(0, n - 2)
        idx = torch.where(energy < self._key_at(idx, dtype), idx - 1, idx)
        idx = torch.where(
            energy >= self._key_at((idx + 1).clamp(0, n - 1), dtype),
            idx + 1, idx)
        return idx.clamp(0, n - 2)

    def lookup(self, energy: torch.Tensor) -> torch.Tensor:
        """Linearly interpolated microscopic cross-section at `energy`
        (the reference's interpolation, omp3/neutral.c:513-516)."""
        if self.analytic:
            dtype = energy.dtype
            idx = self._analytic_index(energy)
            k0 = self._key_at(idx, dtype)
            k1 = self._key_at(idx + 1, dtype)
            v0 = self._val_at(idx, dtype)
            v1 = self._val_at(idx + 1, dtype)
        else:
            idx = self.lookup_index(energy)
            k0 = self.keys[idx]
            k1 = self.keys[idx + 1]
            v0 = self.values[idx]
            v1 = self.values[idx + 1]
        return v0 + ((energy - k0) / (k1 - k0)) * (v1 - v0)
