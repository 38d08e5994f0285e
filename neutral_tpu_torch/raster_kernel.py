"""The segment-deposit kernel (csrc/raster.cu).

Counterpart of `neutral_tpu/raster.py`'s two Pallas rasterizers
(`_raster_kernel` and `_walk_kernel`): every row [gx0, gy0, gx1, gy1, kk]
of a segment buffer adds kk times its clipped overlap into each cell it
crosses, one thread per segment, by atomicAdd into the flat tally.  The
plain version is `raster.deposit_segments_plain`; this wrapper launches the
kernel or raises (on tensors that are not on a CUDA device, or of other
types and shapes).

The row count is passed as a one-element int64 tensor on the device and
read there, so the flight kernel's segment counter feeds the deposit
without a host round trip.  `deposit_segments_kernel.launches` counts
launches; callers may reset it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build


class _RasterParams(ctypes.Structure):
    """Mirror of `RasterParams` in csrc/raster.cu."""
    _fields_ = [("segs", ctypes.c_void_p), ("nseg", ctypes.c_void_p),
                ("tally", ctypes.c_void_p), ("cap", ctypes.c_int64),
                ("nx", ctypes.c_int), ("ny", ctypes.c_int)]


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = build.load()
    lib.nt_raster_params_size.argtypes = []
    lib.nt_raster_params_size.restype = ctypes.c_int
    lib.nt_raster_launch.argtypes = [ctypes.POINTER(_RasterParams),
                                     ctypes.c_void_p]
    lib.nt_raster_launch.restype = ctypes.c_int
    if lib.nt_raster_params_size() != ctypes.sizeof(_RasterParams):
        raise RuntimeError("csrc/raster.cu RasterParams does not match "
                           "raster_kernel._RasterParams")
    return lib


def deposit_segments_kernel(tally: torch.Tensor, segs: torch.Tensor,
                            nseg: torch.Tensor, nx: int, ny: int) -> None:
    """Add the first min(nseg, len(segs)) rows of `segs` into `tally`.

    `tally` is the flat (ny*nx,) float32 tally, `segs` a contiguous
    (cap, 5) float32 buffer and `nseg` a one-element int64 tensor, all on
    one CUDA device.  Launches on the current stream and does not wait.
    """
    dev = tally.device
    if dev.type != "cuda":
        raise ValueError(f"segment-deposit kernel needs CUDA tensors, got "
                         f"{dev}")
    if (tally.dtype != torch.float32 or tally.shape != (nx * ny,)
            or not tally.is_contiguous()):
        raise ValueError("tally: expected a contiguous float32 "
                         f"({nx * ny},) tensor")
    if (segs.device != dev or segs.dtype != torch.float32 or segs.dim() != 2
            or segs.shape[1] != 5 or not segs.is_contiguous()):
        raise ValueError("segs: expected a contiguous (cap, 5) float32 "
                         f"tensor on {dev}, got {tuple(segs.shape)} "
                         f"{segs.dtype} on {segs.device}")
    if (nseg.device != dev or nseg.dtype != torch.int64
            or nseg.numel() != 1):
        raise ValueError(f"nseg: expected a one-element int64 tensor on {dev}")
    if segs.shape[0] == 0:
        return
    lib = load_library()
    p = _RasterParams(segs=segs.data_ptr(), nseg=nseg.data_ptr(),
                      tally=tally.data_ptr(), cap=segs.shape[0], nx=nx, ny=ny)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib, lib.nt_raster_launch(ctypes.byref(p), stream),
                           "segment-deposit kernel")
    deposit_segments_kernel.launches += 1


deposit_segments_kernel.launches = 0
