"""The segment-deposit kernel's two stages as plain PyTorch
(neutral_tpu_torch.raster.tile_pieces_plain and deposit_pieces_plain)
against neutral_tpu.raster: the bins against `expand_pairs` (the sorted
segment x tile pairs of `_raster_kernel`), the tile walk against the
per-cell overlap oracle `rasterize_ref` and against the port's whole-row
walk `deposit_segments_plain`, on random segments made with numpy plus
rows that stress the tile seams: through tile corners (ties between the x
and y walls), along tile walls, starting and ending on them, and leaving
the grid.  The CUDA kernel against these plain versions is checked on the
card (the `cuda` tests here and in test_torch_raster.py, and
chip_smoke.py); its wrapper raises on the CPU.
"""

import collections

import numpy as np
import pytest
import torch

from neutral_tpu_torch import raster
from neutral_tpu_torch.raster_kernel import (TILE, TILES, SegmentDeposit,
                                             deposit_segments_kernel,
                                             redeposit_segments)

NX, NY = 300, 260          # partial tiles on both axes at every tile size
# A small side, and the kernel's T in float32 and in float64.
TILE_SIDES = [16, TILE, TILES[torch.float64]]


def seam_rows(tile: int) -> np.ndarray:
    """Rows on the tile grid of side `tile`, inside [0, NX] x [0, NY]."""
    k = min(3, NY // tile) * tile
    t = tile
    return np.array([
        [0.0, 0.0, k, k, 1.0],              # through every tile corner
        [k, k, 0.0, 0.0, 1.25],             # the same, backwards
        [t, 0.0, 0.0, t, 0.5],              # corner to corner, anti-diagonal
        [0.5, 0.5, k + 0.5, k + 0.5, 0.75],  # a tie at every cell corner
        [1.0, 2.0, k + 1.0, k + 2.0, 1.5],  # ties off the tile corners
        [t, 1.5, t, k + 0.5, 1.0],          # along a tile wall, up
        [2 * t if 2 * t <= NX else t, k, 2 * t if 2 * t <= NX else t, 0.25,
         2.0],                              # along a tile wall, down
        [0.5, t, NX - 0.5, t, 1.0],         # along a tile wall, across
        [t, 17.25, k + 5.5, 40.0, 0.6],     # starts on a tile wall
        [t, t, 5.5, 9.75, 0.9],             # starts on a corner, backwards
        [5.5, 7.25, t, k, 1.1],             # ends on a tile wall
        [40.0, 3.0, k, k, 0.8],             # ends on a tile corner
        [0.0, NY, NX, 0.0, 1.0],            # the grid's outer corners
    ])


def make_segments(seed: int, tile: int) -> np.ndarray:
    """(n, 5) rows [gx0, gy0, gx1, gy1, kk] inside [0, NX] x [0, NY]:
    random ones (with starts on cell walls, axis-parallel ones and ones on
    the tile walls) and `seam_rows(tile)`."""
    rng = np.random.default_rng(seed)
    n = 60
    rows = np.column_stack([rng.uniform(0, NX, n), rng.uniform(0, NY, n),
                            rng.uniform(0, NX, n), rng.uniform(0, NY, n),
                            rng.uniform(0.5, 2.0, n)])
    # boundary-to-boundary starts, as the flight transport emits them
    rows[:10, 0] = np.floor(rows[:10, 0])
    rows[10:20, 1] = np.floor(rows[10:20, 1])
    # axis-parallel
    rows[20:24, 3] = rows[20:24, 1]
    rows[24:28, 2] = rows[24:28, 0]
    # every coordinate on a tile wall
    rows[28:36, :4] = np.floor(rows[28:36, :4] / tile) * tile
    return np.concatenate([rows, seam_rows(tile)])


# Rows that leave the grid: their start cell is clipped into it and the
# fractions off it are dropped (deposit_segments_plain's conventions).
OFF_GRID = np.array([[NX - 0.5, 2.0, NX + 3.0, 9.0, 1.0],
                     [4.0, NY - 0.25, 11.0, NY + 2.0, 1.0],
                     [-5.0, -3.0, 40.0, 50.0, 1.0],
                     [NX + 10.0, NY + 10.0, 200.0, 100.0, 1.0],
                     [-3.0, 50.0, 100.0, 50.0, 1.0],
                     [50.0, -7.0, 50.0, 90.0, 1.0]])


def tiled(segs: np.ndarray, dtype: torch.dtype, tile: int) -> np.ndarray:
    s = torch.tensor(segs, dtype=dtype)
    tally = torch.zeros(NX * NY, dtype=dtype)
    raster.deposit_pieces_plain(tally, s, raster.tile_pieces_plain(
        s, NX, NY, tile), NX, NY, tile)
    return tally.numpy().astype(np.float64).reshape(NY, NX)


def whole(segs: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    tally = torch.zeros(NX * NY, dtype=dtype)
    raster.deposit_segments_plain(tally, torch.tensor(segs, dtype=dtype), NX,
                                  NY)
    return tally.numpy().astype(np.float64).reshape(NY, NX)


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_bins_match_expand_pairs(seed):
    """At the TPU's 128-cell tiles the bins hold, tile by tile, the rows of
    `expand_pairs`' sorted pairs, except for rows that end exactly on a
    tile wall or corner, where the two tile sequences part:

    - expand_pairs takes the last tile from floor(gx1 / 128) and adds the
      tile beyond the wall; the walk stops at t = 1 before crossing it.
      Such a row deposits exactly 0 there (rasterize_ref over the tile).
    - Where a wall's t rounds to just below 1, the walk (as the whole-row
      walk and the oracle do) crosses into a tile that expand_pairs' merge
      skips.  Such a row deposits only that rounding there, under 1e-15
      of its kk in rasterize_ref.
    """
    import jax.numpy as jnp
    from neutral_tpu import raster as jraster

    tile = 128
    segs = make_segments(seed, tile)
    ntx, nty = jraster.grid_shape(NX, NY, tile)
    _, seg_idx, offs = jraster.expand_pairs(
        jnp.asarray(segs), segs.shape[0], tile=tile, ntx=ntx, nty=nty,
        pair_cap=8192)
    seg_idx, offs = np.asarray(seg_idx), np.asarray(offs)
    offsets, pieces = raster.tile_pieces_plain(torch.tensor(segs), NX, NY,
                                               tile)
    offsets, pieces = offsets.numpy(), pieces.numpy()
    assert offsets.shape == (ntx * nty + 1,) and offsets[-1] > 0
    theirs_only, ours_only = [], []
    for k in range(ntx * nty):
        theirs = collections.Counter(seg_idx[offs[k]:offs[k + 1]].tolist())
        ours = collections.Counter(pieces[offsets[k]:offsets[k + 1]].tolist())
        theirs_only += [(k, r) for r in theirs - ours]
        ours_only += [(k, r) for r in ours - theirs]
    for side, diff in (("expand_pairs", theirs_only), ("bins", ours_only)):
        for k, r in diff:
            x0, y0 = (k % ntx) * tile, (k // ntx) * tile
            gx1, gy1 = segs[r, 2], segs[r, 3]
            assert gx1 in (x0, x0 + tile) or gy1 in (y0, y0 + tile), (
                side, k, segs[r])
            cells = jraster.rasterize_ref(np.zeros((NY, NX)), segs[r:r + 1])
            left = cells[y0:y0 + tile, x0:x0 + tile].sum()
            if side == "expand_pairs":
                assert left == 0.0, (side, k, segs[r], left)
            else:
                assert 0.0 <= left < 1e-15 * segs[r, 4], (side, k, segs[r])
    # the rows ending on tile walls and corners (seam_rows) are in the set
    assert theirs_only


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tile", TILE_SIDES)
def test_tile_deposit_matches_oracle_f64(tile, seed):
    from neutral_tpu import raster as jraster

    segs = make_segments(seed, tile)
    got = tiled(segs, torch.float64, tile)
    want = jraster.rasterize_ref(np.zeros((NY, NX)), segs)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # every segment lies inside the grid, so all of kk is deposited
    np.testing.assert_allclose(got.sum(), segs[:, 4].sum(), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tile", TILE_SIDES)
def test_tile_deposit_matches_row_walk_f32(tile, seed):
    """float32, the kernel's type: per cell to 1e-5 of the largest cell and
    sums to 1e-5 against the whole-row walk (and the oracle)."""
    from neutral_tpu import raster as jraster

    segs = np.concatenate([make_segments(seed, tile),
                           OFF_GRID]).astype(np.float32)
    got = tiled(segs, torch.float32, tile)
    want = whole(segs, torch.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-5)
    inside = segs[:-OFF_GRID.shape[0]].astype(np.float64)
    ref = jraster.rasterize_ref(np.zeros((NY, NX)), inside)
    got_inside = tiled(segs[:-OFF_GRID.shape[0]], torch.float32, tile)
    np.testing.assert_allclose(got_inside, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("tile", [TILE, TILES[torch.float64]])
def test_tile_deposit_matches_rasterize_xla_f64(tile):
    """The two stages in float64 at the kernels' T against
    neutral_tpu.raster.rasterize_xla in float64 (the function JAX's float64
    flight engine deposits with): per cell to 1e-12."""
    import jax.numpy as jnp
    from neutral_tpu import raster as jraster

    segs = make_segments(4, tile)
    buf = np.zeros((segs.shape[0], 8))
    buf[:, :5] = segs
    want = jraster.rasterize_xla(jnp.zeros(NX * NY, jnp.float64),
                                 jnp.asarray(buf),
                                 jnp.int32(segs.shape[0]), nx=NX, ny=NY,
                                 max_steps=NX + NY + 2)
    np.testing.assert_allclose(tiled(segs, torch.float64, tile),
                               np.asarray(want).reshape(NY, NX), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tile", TILE_SIDES)
def test_tile_walk_equals_row_walk_per_row(tile, dtype):
    """Row by row the tiled walk gives every cell exactly the value of the
    whole-row walk: the pieces enter each tile at the cell and t where the
    row's own walk does, at seams, corners and ties too, and rows that
    leave the grid keep the clipped start and drop what falls off."""
    segs = np.concatenate([make_segments(3, tile)[-30:], OFF_GRID])
    for i in range(segs.shape[0]):
        row = segs[i:i + 1]
        np.testing.assert_array_equal(tiled(row, dtype, tile),
                                      whole(row, dtype), err_msg=str(row))


def test_tile_bins_skip_rows_without_energy():
    segs = make_segments(0, TILE)
    segs[::3, 4] = 0.0
    offsets, pieces = raster.tile_pieces_plain(torch.tensor(segs), NX, NY,
                                               TILE)
    assert int(offsets[-1]) == pieces.shape[0] > 0
    assert not set(pieces.tolist()) & set(range(0, segs.shape[0], 3))
    np.testing.assert_allclose(tiled(segs, torch.float64, TILE),
                               whole(segs, torch.float64), rtol=0,
                               atol=1e-12)


def test_segment_deposit_buffers_and_wrapper_checks():
    """The buffers are sized from the kernel's tile grid; growing the
    piece buffer leaves room past the need; the wrapper and its re-run
    after an overflow raise on CPU tensors, with buffers and counters
    passed too, and launch nothing and count no overflow."""
    dep = SegmentDeposit(NX, NY, "cpu")
    ntiles = -(-NX // TILE) * -(-NY // TILE)
    assert TILE == 128 and dep.ntiles == ntiles
    assert dep.work.shape == (4 * ntiles + 4,) and not dep.work.any()
    t64 = TILES[torch.float64]
    dep64 = SegmentDeposit(NX, NY, "cpu", dtype=torch.float64)
    assert (dep64.tile, dep64.ntiles) == (t64, -(-NX // t64) * -(-NY // t64))
    assert dep64.work.shape == (4 * dep64.ntiles + 4,)
    dep.grow(1000)
    assert dep.pieces.shape[0] >= 1250
    launches0 = deposit_segments_kernel.launches
    overflows0 = deposit_segments_kernel.overflows
    args = (torch.zeros(NX * NY), torch.zeros((4, 5)), torch.tensor([4]), NX,
            NY, dep, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        deposit_segments_kernel(*args)
    with pytest.raises(ValueError, match="CUDA"):
        redeposit_segments(*args, 3000)
    assert deposit_segments_kernel.launches == launches0
    assert deposit_segments_kernel.overflows == overflows0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_stages_match_plain_on_card(dtype):
    """The kernel's T on the card, in each working type: the bins equal
    tile_pieces_plain's (offsets exactly, each tile's rows as a multiset:
    atomics fill them in another order) and the tally equals
    deposit_pieces_plain's per cell to 1e-5 of the largest cell, with sums
    to 1e-5 (float32; 1e-12 in float64).  The piece buffer starts too
    small, so the first launch overflows, deposits nothing, and the re-run
    deposits everything."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tile = TILES[dtype]
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    segs = torch.tensor(np.concatenate([make_segments(5, tile), OFF_GRID]),
                        dtype=dtype, device="cuda")
    dep = SegmentDeposit(NX, NY, "cuda", pieces=16, dtype=dtype)
    kt = torch.zeros(NX * NY, dtype=dtype, device="cuda")
    launches0 = deposit_segments_kernel.launches
    overflows0 = deposit_segments_kernel.overflows
    deposit_segments_kernel(kt, segs, torch.tensor([segs.shape[0]],
                                                   device="cuda"), NX, NY,
                            dep)
    assert deposit_segments_kernel.launches == launches0 + 2
    assert deposit_segments_kernel.overflows == overflows0 + 1
    offsets, pieces = raster.tile_pieces_plain(segs.cpu(), NX, NY, tile)
    nt = dep.ntiles
    got_off = dep.work[nt:2 * nt + 1].cpu()
    assert torch.equal(got_off, offsets)
    got = dep.pieces[:int(offsets[-1])].cpu().long()
    for k in range(nt):
        a, b = int(offsets[k]), int(offsets[k + 1])
        assert torch.equal(torch.sort(got[a:b])[0], pieces[a:b])
    pt = torch.zeros(NX * NY, dtype=dtype)
    raster.deposit_pieces_plain(pt, segs.cpu(), (offsets, pieces), NX, NY,
                                tile)
    k, p = kt.double().cpu().numpy(), pt.double().numpy()
    np.testing.assert_allclose(k, p, rtol=0, atol=tol * np.abs(p).max())
    np.testing.assert_allclose(k.sum(), p.sum(), rtol=tol)
