"""The segment-deposit kernel (csrc/raster.cu).

Counterpart of `neutral_tpu/raster.py`'s two Pallas rasterizers
(`_raster_kernel` and `_walk_kernel`): every row [gx0, gy0, gx1, gy1, kk]
of a segment buffer adds kk times its clipped overlap into each cell it
crosses.  The kernel bins the rows' pieces by T x T tally tile and
deposits every tile's pieces, in work items of C pieces (chosen on the
device for each call, 1024 to 16384), into the tile held in shared
memory, which it then adds into the tally.  It runs float32 or float64
rows into a float32 or float64 tally, the four instantiations of
csrc/raster.cu: the walk in the rows' type, each cell's value kk * frac
in the tally's, and T the tally's type's (`TILES`: 128 for a float32
tally, 64 for a float64 one).  A float32 state with a float64 tally
writes float32 rows into a float64 tally, a float64 state with a float32
tally float64 rows into a float32 tally (flight.py).  Other types
raise.  The
plain version of the function is `raster.deposit_segments_plain`, those
of the two stages `raster.tile_pieces_plain` and
`raster.deposit_pieces_plain`; this wrapper launches the kernel or raises
(on tensors that are not on a CUDA device, or of other types and shapes).

The row count is passed as a one-element int64 tensor on the device and
read there, so the flight kernel's segment counter feeds the deposit
without a host round trip.  The piece buffer lives in a `SegmentDeposit`,
which a caller keeps between calls; the kernel writes the number of
pieces and an overflow flag (more pieces than the buffer holds) into two
int64 counters.  On overflow it deposits nothing: the caller, having read
the flag, calls `redeposit_segments`, which grows the buffer and launches
again on the same rows.  `deposit_segments_kernel.launches` counts
launches (both stages, a re-run included) and `.overflows` the re-runs;
callers may reset them.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import build

# The tile side T in cells of each tally type (csrc/raster.cu kTile), the
# same for rows of either type.
TILES = {torch.float32: 128, torch.float64: 64}
TILE = TILES[torch.float32]
INITIAL_PIECES = 1 << 20   # piece buffer of a new SegmentDeposit
GROWTH = 2                 # an overflow grows it to this times the need

_RASTER_FIELDS = [("segs", ctypes.c_void_p), ("nseg", ctypes.c_void_p),
                  ("tally", ctypes.c_void_p), ("pieces", ctypes.c_void_p),
                  ("work", ctypes.c_void_p), ("out", ctypes.c_void_p),
                  ("cap", ctypes.c_int64), ("piece_cap", ctypes.c_int64),
                  ("nx", ctypes.c_int), ("ny", ctypes.c_int)]


class _RasterParams(ctypes.Structure):
    """Mirror of `RasterParams` (float32) in csrc/raster.cu."""
    _fields_ = _RASTER_FIELDS


class _RasterParams64(ctypes.Structure):
    """Mirror of `RasterParams64` (float64) in csrc/raster.cu: the same
    fields, its rows and tally of doubles."""
    _fields_ = _RASTER_FIELDS


class _RasterParams32t64(ctypes.Structure):
    """Mirror of `RasterParams32t64` in csrc/raster.cu: float32 rows into a
    float64 tally."""
    _fields_ = _RASTER_FIELDS


class _RasterParams64t32(ctypes.Structure):
    """Mirror of `RasterParams64t32` in csrc/raster.cu: float64 rows into a
    float32 tally."""
    _fields_ = _RASTER_FIELDS


# The parameter layout and entry-point suffix of each (rows, tally) pair.
_LAYOUTS = {(torch.float32, torch.float32): (_RasterParams, ""),
            (torch.float64, torch.float64): (_RasterParams64, "_f64"),
            (torch.float32, torch.float64): (_RasterParams32t64, "_f32t64"),
            (torch.float64, torch.float32): (_RasterParams64t32, "_f64t32")}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = build.load()
    lib.nt_raster_tile_side.argtypes = [ctypes.c_int]
    lib.nt_raster_tile_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.nt_raster_tile_side.restype = ctypes.c_int
    lib.nt_raster_tile_blocks.restype = ctypes.c_int
    for (rows, tally), (cls, sfx) in _LAYOUTS.items():
        size = getattr(lib, f"nt_raster_params_size{sfx}")
        size.argtypes, size.restype = [], ctypes.c_int
        for stage in ("bin", "tiles"):
            fn = getattr(lib, f"nt_raster_{stage}{sfx}")
            fn.argtypes = [ctypes.POINTER(cls), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        if size() != ctypes.sizeof(cls):
            raise RuntimeError(f"csrc/raster.cu RasterParams{sfx} does not "
                               f"match raster_kernel.{cls.__name__}")
        if lib.nt_raster_tile_side(_f64(tally)) != TILES[tally]:
            raise RuntimeError(f"csrc/raster.cu kTile of a {tally} tally "
                               f"does not match raster_kernel.TILES")
    return lib


def _f64(dtype: torch.dtype) -> int:
    """The 0/1 type code of nt_raster_tile_side/nt_raster_tile_blocks."""
    return int(dtype == torch.float64)


def tile_blocks_per_sm(dtype: torch.dtype, device,
                       tally_dtype: torch.dtype | None = None) -> int:
    """Blocks of the tile kernel of rows of `dtype` into a tally of
    `tally_dtype` (None: `dtype`) that one SM of the CUDA `device` holds
    beside its T x T tile (the occupancy its persistent grid is sized
    by)."""
    lib = load_library()
    with torch.cuda.device(device):
        blocks = lib.nt_raster_tile_blocks(_f64(dtype),
                                           _f64(tally_dtype or dtype))
    if blocks <= 0:
        raise RuntimeError("segment-deposit kernel: no tile-kernel occupancy "
                           f"on {device}")
    return blocks // torch.cuda.get_device_properties(
        device).multi_processor_count


class SegmentDeposit:
    """The kernel's buffers for rows of `dtype` into one (nx, ny) tally of
    `tally_dtype` (None: `dtype`; each float32 or float64) on one device,
    kept between calls: the int32 piece buffer (row indices grouped by
    tile, grown on overflow), the per-tile workspace of `csrc/raster.cu`'s
    `Work` (4 * ntiles + 4 int64 over the tally type's T x T tiles, the
    counts zero between calls) and, for callers that pass no counters of
    their own, the [pieces, overflow] counters."""

    def __init__(self, nx: int, ny: int, device,
                 pieces: int = INITIAL_PIECES,
                 dtype: torch.dtype = torch.float32,
                 tally_dtype: torch.dtype | None = None):
        tally_dtype = tally_dtype or dtype
        if dtype not in TILES or tally_dtype not in TILES:
            raise ValueError(f"segment deposit of float32 or float64 rows "
                             f"into a float32 or float64 tally, got "
                             f"{dtype} rows, a {tally_dtype} tally")
        self.nx, self.ny, self.dtype = nx, ny, dtype
        self.tally_dtype = tally_dtype
        self.tile = TILES[tally_dtype]
        self.ntiles = -(-nx // self.tile) * -(-ny // self.tile)
        self.work = torch.zeros(4 * self.ntiles + 4, dtype=torch.int64,
                                device=device)
        self.device = self.work.device          # with its index
        self.pieces = torch.empty(pieces, dtype=torch.int32,
                                  device=self.device)
        self.out = torch.zeros(2, dtype=torch.int64, device=self.device)

    def grow(self, need: int) -> None:
        """Room for GROWTH times `need` pieces (after an overflow), so that
        rounds that grow a little do not overflow again."""
        self.pieces = None                    # free it before the new one
        self.pieces = torch.empty(int(need * GROWTH) + 1, dtype=torch.int32,
                                  device=self.device)

    def stats(self) -> dict:
        """Of the last call's bins (a host read): T, its C, the pieces,
        the pieces per tile (largest, and mean over the tiles with any), the
        work items and the piece buffer's capacity."""
        nt = self.ntiles
        w = self.work.cpu()
        per_tile = w[nt + 1:2 * nt + 1] - w[nt:2 * nt]
        busy = per_tile[per_tile > 0]
        return {"tile": self.tile, "chunk": int(w[4 * nt + 3]),
                "pieces": int(w[2 * nt]), "tiles_with_pieces": busy.numel(),
                "pieces_per_tile_max": int(per_tile.max()),
                "pieces_per_tile_mean": (float(busy.double().mean())
                                         if busy.numel() else 0.0),
                "work_items": int(w[4 * nt + 1]),
                "piece_capacity": self.pieces.shape[0]}


def _check(tally, segs, nseg, nx, ny):
    real = tally.dtype
    if real not in TILES or segs.dtype not in TILES:
        raise ValueError(f"segment-deposit kernel: rows of {segs.dtype} into "
                         f"a tally of {real}: it takes float32 or float64 "
                         "rows into a float32 or float64 tally")
    dev = tally.device
    if dev.type != "cuda":
        raise ValueError(f"segment-deposit kernel needs CUDA tensors, got "
                         f"{dev}")
    if tally.shape != (nx * ny,) or not tally.is_contiguous():
        raise ValueError(f"tally: expected a contiguous {real} "
                         f"({nx * ny},) tensor")
    if (segs.device != dev or segs.dim() != 2
            or segs.shape[1] != 5 or not segs.is_contiguous()
            or segs.shape[0] >= 2**31):
        raise ValueError(f"segs: expected a contiguous (cap, 5) "
                         f"tensor on {dev} with cap < 2**31, got "
                         f"{tuple(segs.shape)} {segs.dtype} on {segs.device}")
    if (nseg.device != dev or nseg.dtype != torch.int64
            or nseg.numel() != 1):
        raise ValueError(f"nseg: expected a one-element int64 tensor on {dev}")


def deposit_segments_kernel(tally: torch.Tensor, segs: torch.Tensor,
                            nseg: torch.Tensor, nx: int, ny: int,
                            deposit: SegmentDeposit | None = None,
                            counts: torch.Tensor | None = None,
                            stages: list | None = None) -> None:
    """Add the first min(nseg, len(segs)) rows of `segs` into `tally`.

    `tally` is the flat (ny*nx,) tally, `segs` a contiguous (cap, 5)
    buffer (each of float32 or float64, either pair) and `nseg` a
    one-element int64 tensor, all on one CUDA device.  `deposit` holds the
    buffers (a new SegmentDeposit of those dtypes when None).  With
    `counts`, a (2,) int64 tensor on the device, the call launches on the
    current stream, writes [pieces, overflow] there and does not wait: on
    overflow the caller calls `redeposit_segments` before the rows change.
    Without it the call reads its own counters (a host wait) and does so
    itself.  When `stages` is a list, the CUDA events (start, bins done,
    deposit done) of each launch are appended to it.
    """
    _check(tally, segs, nseg, nx, ny)
    dev = tally.device
    if deposit is None:
        deposit = SegmentDeposit(nx, ny, dev, dtype=segs.dtype,
                                 tally_dtype=tally.dtype)
    elif ((deposit.nx, deposit.ny, deposit.device, deposit.dtype,
           deposit.tally_dtype) != (nx, ny, dev, segs.dtype, tally.dtype)):
        raise ValueError(f"deposit holds buffers of {deposit.dtype} rows "
                         f"into a ({deposit.nx}, {deposit.ny}) "
                         f"{deposit.tally_dtype} tally on {deposit.device}, "
                         f"not {segs.dtype} rows into ({nx}, {ny}) "
                         f"{tally.dtype} on {dev}")
    own = counts is None
    if own:
        counts = deposit.out
    elif (counts.device != dev or counts.dtype != torch.int64
          or counts.shape != (2,) or not counts.is_contiguous()):
        raise ValueError(f"counts: expected a contiguous (2,) int64 tensor "
                         f"on {dev}")
    if segs.shape[0] == 0:
        counts.zero_()
        return
    _launch(deposit, tally, segs, nseg, counts, stages)
    if own:
        need, overflow = counts.tolist()
        if overflow:
            redeposit_segments(tally, segs, nseg, nx, ny, deposit, counts,
                               need, stages)


def redeposit_segments(tally: torch.Tensor, segs: torch.Tensor,
                       nseg: torch.Tensor, nx: int, ny: int,
                       deposit: SegmentDeposit, counts: torch.Tensor,
                       need: int, stages: list | None = None) -> None:
    """After a deposit whose overflow flag the caller has read (counts =
    [need, 1]): grow `deposit`'s piece buffer and launch again on the same
    rows, as deposit_segments_kernel with `counts`.  Counts one overflow."""
    deposit.grow(need)
    deposit_segments_kernel(tally, segs, nseg, nx, ny, deposit, counts, stages)
    deposit_segments_kernel.overflows += 1


def _launch(deposit, tally, segs, nseg, counts, stages) -> None:
    """Both stages of one deposit on the current stream."""
    lib = load_library()
    cls, sfx = _LAYOUTS[(deposit.dtype, deposit.tally_dtype)]
    p = cls(segs=segs.data_ptr(), nseg=nseg.data_ptr(),
            tally=tally.data_ptr(), pieces=deposit.pieces.data_ptr(),
            work=deposit.work.data_ptr(), out=counts.data_ptr(),
            cap=segs.shape[0], piece_cap=deposit.pieces.shape[0],
            nx=deposit.nx, ny=deposit.ny)
    bins = getattr(lib, f"nt_raster_bin{sfx}")
    tiles = getattr(lib, f"nt_raster_tiles{sfx}")
    with torch.cuda.device(tally.device):
        stream = torch.cuda.current_stream().cuda_stream
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
              if stages is not None else None)
        if ev:
            ev[0].record()
        build.check_launch(lib, bins(ctypes.byref(p), stream),
                           "segment-deposit kernel (bins)")
        if ev:
            ev[1].record()
        build.check_launch(lib, tiles(ctypes.byref(p), stream),
                           "segment-deposit kernel (tiles)")
        if ev:
            ev[2].record()
            stages.append(ev)
    deposit_segments_kernel.launches += 1
    deposit_segments_kernel.cards[tally.device.index] += 1


deposit_segments_kernel.launches = 0
deposit_segments_kernel.cards = collections.Counter()  # launches by card
deposit_segments_kernel.overflows = 0
