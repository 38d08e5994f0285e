"""The port's plain segment deposit (neutral_tpu_torch.raster) against
neutral_tpu.raster's numpy per-cell overlap oracle (rasterize_ref) and its
XLA walk (rasterize_xla), on random segments made with numpy.

The segments include the shapes that stress the walk: axis-parallel ones
(the 1e-12 nudge), long ones across many 128-cell tiles, and ones that
start or end exactly on the grid's outer edges.  Per cell the deposit
agrees with the oracle to 1e-12 in float64 and to a relative 1e-5 of the
largest cell in float32.  The CUDA kernel against this plain version is
checked on the card below and in chip_smoke.py (raster_kernel.py raises
on the CPU, tested below); its two stages' plain versions are tested in
test_torch_tiles.py.
"""

import numpy as np
import pytest
import torch

from neutral_tpu_torch import raster
from neutral_tpu_torch.raster_kernel import (TILES, SegmentDeposit,
                                             deposit_segments_kernel)

NX, NY = 300, 260          # more than two 128-cell tiles each way


def make_segments(seed: int) -> np.ndarray:
    """(n, 5) rows [gx0, gy0, gx1, gy1, kk] inside [0, NX] x [0, NY]."""
    rng = np.random.default_rng(seed)
    n = 40
    rows = np.column_stack([rng.uniform(0, NX, n), rng.uniform(0, NY, n),
                            rng.uniform(0, NX, n), rng.uniform(0, NY, n),
                            rng.uniform(0.5, 2.0, n)])
    # boundary-to-boundary starts, as the flight transport emits them
    rows[:10, 0] = np.floor(rows[:10, 0])
    rows[10:20, 1] = np.floor(rows[10:20, 1])
    # axis-parallel
    rows[20:24, 3] = rows[20:24, 1]
    rows[24:28, 2] = rows[24:28, 0]
    # across the whole grid, corner to corner and edge to edge
    extra = np.array([[0.0, 0.0, NX, NY, 1.0],
                      [NX, 0.0, 0.0, NY, 1.5],
                      [0.0, 17.25, NX, 17.25, 0.75],
                      [133.5, NY, 133.5, 0.0, 1.25],
                      [NX, 3.0, 5.0, NY, 0.5],
                      [0.0, NY, NX, 101.0, 2.0]])
    return np.concatenate([rows, extra])


def deposit(segs: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    tally = torch.zeros(NX * NY, dtype=dtype)
    raster.deposit_segments_plain(tally, torch.tensor(segs, dtype=dtype),
                                  NX, NY)
    return tally.numpy().astype(np.float64).reshape(NY, NX)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_deposit_matches_oracle_f64(seed):
    from neutral_tpu import raster as jraster

    segs = make_segments(seed)
    got = deposit(segs, torch.float64)
    want = jraster.rasterize_ref(np.zeros((NY, NX)), segs)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # every segment lies inside the grid, so all of kk is deposited
    np.testing.assert_allclose(got.sum(), segs[:, 4].sum(), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_deposit_matches_oracle_f32(seed):
    from neutral_tpu import raster as jraster

    segs = make_segments(seed).astype(np.float32)
    got = deposit(segs, torch.float32)
    want = jraster.rasterize_ref(np.zeros((NY, NX)),
                                 segs.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-5)


def test_plain_deposit_matches_rasterize_xla():
    import jax.numpy as jnp
    from neutral_tpu import raster as jraster

    segs = make_segments(2)
    buf = np.zeros((segs.shape[0], 8))
    buf[:, :5] = segs
    want = jraster.rasterize_xla(jnp.zeros(NX * NY, jnp.float64),
                                 jnp.asarray(buf),
                                 jnp.int32(segs.shape[0]), nx=NX, ny=NY,
                                 max_steps=NX + NY + 2)
    got = deposit(segs, torch.float64)
    np.testing.assert_allclose(got, np.asarray(want).reshape(NY, NX),
                               rtol=1e-12, atol=1e-12)


def test_plain_deposit_drops_fractions_off_the_grid():
    """A segment running along the outer edge x = NX would step into the
    column past the grid; those fractions are dropped, never wrapped into
    the next row."""
    segs = np.array([[NX - 0.5, 2.0, NX + 3.0, 9.0, 1.0],
                     [4.0, NY - 0.25, 11.0, NY + 2.0, 1.0]])
    got = deposit(segs, torch.float64)
    from neutral_tpu import raster as jraster
    want = jraster.rasterize_ref(np.zeros((NY, NX)), segs)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert got[:, 0].sum() == 0.0 and got[0].sum() == 0.0
    assert 0.0 < got.sum() < 2.0


def test_segment_kernel_wrapper_on_cpu_raises():
    launches0 = deposit_segments_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        deposit_segments_kernel(torch.zeros(NX * NY), torch.zeros((4, 5)),
                                torch.tensor([4]), NX, NY)
    assert deposit_segments_kernel.launches == launches0


def test_segment_kernel_refuses_mixed_working_types():
    """The wrapper takes float32 or float64 rows into a float32 or float64
    tally, a mixed pair included (the kernel's mixed instantiations: here
    on CPU tensors they pass the type check and raise at the device); any
    other type raises before the device is looked at; nothing launches."""
    launches0 = deposit_segments_kernel.launches
    for tally, segs in ((torch.float32, torch.float64),
                        (torch.float64, torch.float32)):
        with pytest.raises(ValueError, match="CUDA"):
            deposit_segments_kernel(torch.zeros(NX * NY, dtype=tally),
                                    torch.zeros((4, 5), dtype=segs),
                                    torch.tensor([4]), NX, NY)
    for tally, segs in ((torch.float16, torch.float16),
                        (torch.float32, torch.float16),
                        (torch.float16, torch.float64)):
        with pytest.raises(ValueError, match="float32 or float64 rows into "
                                             "a float32 or float64 tally"):
            deposit_segments_kernel(torch.zeros(NX * NY, dtype=tally),
                                    torch.zeros((4, 5), dtype=segs),
                                    torch.tensor([4]), NX, NY)
    with pytest.raises(ValueError, match="CUDA"):
        deposit_segments_kernel(torch.zeros(NX * NY, dtype=torch.float64),
                                torch.zeros((4, 5), dtype=torch.float64),
                                torch.tensor([4]), NX, NY)
    assert deposit_segments_kernel.launches == launches0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_kernel_matches_plain_on_card(dtype):
    """The CUDA segment deposit against the plain one on the card: per
    cell to 1e-5 of the largest cell and sums to 1e-5 in float32, 1e-12 in
    float64 (atomics add overlapping segments in another order).  Rows
    past `nseg` are ignored.  Besides make_segments' rows, rows on the
    kernel's tile grid (its T in that type): through tile corners, along
    and from tile walls, with x/y ties.  Twice: with a new SegmentDeposit,
    and with one whose piece buffer is too small, so that the first launch
    overflows and deposits nothing and the re-run gives the same tally."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = TILES[dtype]
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    seams = np.array([[0.0, 0.0, 3 * t, 3 * t, 1.0],
                      [3 * t, 3 * t, 0.0, 0.0, 1.25],
                      [t, 1.5, t, 3 * t + 0.5, 1.0],
                      [0.5, t, NX - 0.5, t, 1.0],
                      [t, t, 5.5, 9.75, 0.9],
                      [40.0, 3.0, 2 * t, 2 * t, 0.8],
                      [0.5, 0.5, 2 * t + 0.5, 2 * t + 0.5, 0.75]])
    segs = torch.tensor(np.concatenate([seams, make_segments(0)]),
                        dtype=dtype, device="cuda")
    nseg = segs.shape[0] - 3
    pt = torch.zeros(NX * NY, dtype=dtype, device="cuda")
    raster.deposit_segments_plain(pt, segs[:nseg], NX, NY)
    p = pt.double().cpu().numpy()
    for pieces, overflows in ((None, 0), (8, 1)):
        dep = (None if pieces is None
               else SegmentDeposit(NX, NY, "cuda", pieces=pieces,
                                   dtype=dtype))
        kt = torch.zeros_like(pt)
        launches0 = deposit_segments_kernel.launches
        overflows0 = deposit_segments_kernel.overflows
        deposit_segments_kernel(kt, segs, torch.tensor([nseg], device="cuda"),
                                NX, NY, dep)
        assert deposit_segments_kernel.overflows == overflows0 + overflows
        assert deposit_segments_kernel.launches == (launches0 + 1
                                                    + overflows)
        k = kt.double().cpu().numpy()
        np.testing.assert_allclose(k, p, rtol=0, atol=tol * np.abs(p).max())
        np.testing.assert_allclose(k.sum(), p.sum(), rtol=tol)
