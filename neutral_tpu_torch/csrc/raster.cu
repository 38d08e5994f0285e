// Segment deposit for NVIDIA Hopper (sm_90a): pieces binned by tally tile,
// each tile accumulated in shared memory and flushed once per work item.
//
// Replaces both TPU segment rasterizers, neutral_tpu/raster.py::
// _raster_kernel (:161, pl.pallas_call :278) and ::_walk_kernel (:331,
// pl.pallas_call :529).  They compute one function: every cell a segment
// [gx0, gy0, gx1, gy1, kk] (cell units) crosses receives kk times the
// clipped overlap of the segment with the cell, with the plain version's
// conventions (neutral_tpu_torch/raster.py deposit_segments_plain, the port
// of rasterize_xla): the start cell is clipped into the grid, fractions that
// fall off it are dropped, and axis-parallel extents are nudged to 1e-12.
// The TPU never scattered per cell: _raster_kernel sorted (segment x
// 128^2 tile) pairs and deposited each tile's pairs while the tile stayed
// in VMEM, and _walk_kernel kept the whole tally in VMEM.
//
// What bounds it on the H100.  A stream census crosses ~7e9 (segment,
// cell) pairs, 15 float operations each (~1.6 ms at 67 TFLOP/s).  The
// first port added each of them into the 64 MB tally with a global
// atomicAdd from one thread per segment: 7e9 uncoalesced read-modify-
// writes, mostly past the 50 MB L2, took ~180 ms.  Here the same walk adds
// into a tile of T x T floats held in shared memory, where an add never
// reaches L2, and global memory sees one coalesced add per nonzero cell
// per work item (at most 66M on stream, not 7e9).  What bounds it now, as
// measured on an H100 (PERF.md): the shared-memory float add, which sm_90
// compiles to a compare-and-swap loop (ATOMS.CAST.SPIN; about a third of
// the tile stage: plain or integer adds in its place ran the stage in two
// thirds of the time), and the latency of the walk's dependent steps, with
// 32 pieces of unequal length per warp; the bins take a fifth.
//
// Two entry points on the caller's stream, without a host wait:
//
// 1. Bin (nt_raster_bin): the count kernel walks each row over tile walls
//    -- the same wall times (w - gx0) * ivx and step rule (x on a tie,
//    only while t < 1) as the walk over cell walls, so a row visits exactly
//    the tiles whose cells its cell walk visits -- and counts its pieces
//    per tile (one atomic per group of lanes of a warp on the same tile).
//    One block picks C for the call (about 8 work items per resident block
//    of the tile kernel, so that a small round, such as a decomposed
//    shard's, still fills the card), scans the counts into offsets and
//    work items of at most C pieces, writes the piece total and the
//    overflow flag (total > the piece buffer's capacity) to `out`, and
//    clears the counts for the next call.  The fill kernel walks again and
//    writes each row's index into its tiles' ranges; it does nothing on
//    overflow.
// 2. Tile deposit (nt_raster_tiles): persistent blocks take work items
//    (tile, up to C pieces) from an atomic counter.  One thread per piece
//    finds where its row enters the tile -- at the entry wall's t, in the
//    cell the whole-row walk occupies then, found by comparing the other
//    axis's wall times with t -- and walks the row's cells in the tile as
//    deposit_segments_plain does, adding kk * frac into the shared tile.
//    The tile is then added into the tally with one atomicAdd per nonzero
//    cell, 32 consecutive floats per warp instruction.  On overflow the
//    kernel returns at once: the caller grows the piece buffer and runs
//    both stages again on the same rows.
//
// Every cell receives the same kk * frac values as from the whole-row
// walk (the plain versions tile_pieces_plain / deposit_pieces_plain
// check it bitwise per row); only the order of the adds differs.  Rows
// are finite cell coordinates, as the flight kernel writes them: with a
// finite start and extent every wall time is finite, so fminf/fmaxf give
// the plain version's NaN-propagating min/max values.  The row count is
// read on the device (the flight kernel's atomic counter).
//
// The working type is a template parameter: float32 rows into a float32
// tally, or float64 rows (what the flight kernel's float64 instantiations
// write) into a float64 tally, the plain version's arithmetic in that type
// (neutral_tpu's rasterize_xla in float64).  The tile side T is the
// type's (kTile): float32 T = 128 (a 64 KB tile; measured against T = 64
// in PERF.md), float64 T = 64 (32 KB of doubles: under the 48 KB that
// needs no opt-in, several blocks an SM; measured against T = 128 in
// PERF.md).  Each type's bins, work items and tile kernel follow its T, and
// its tile kernel has its own occupancy (tile_blocks), from which the scan
// picks its C.  The shared-memory double add compiles to a
// compare-and-swap loop as the float add does; the tile flush's global
// add is the native atomicAdd(double*).  The float32 instantiations keep
// the code they had before the working type was a template parameter:
// what differs by type goes through common.cuh's overloads (floor_int,
// nt_fabs, nt_fmin/nt_fmax) and tile_acc.
//
// The tally has a type of its own (Tally, a template parameter beside the
// rows' type, as SimConfig.tally_dtype is in neutral_tpu): the walk is in
// the rows' type, and each cell's added value is kk and frac each rounded
// to the tally's type, then multiplied in it (deposit_segments_plain's
// kk.to(tally) * frac.to(tally)), into a tile of the tally's type.  So T
// follows the tally: 128 for a float32 tally, 64 for a float64 one, whose
// 32 KB tile of doubles leaves room for several blocks an SM (kTile of the
// tally's type).  With Tally = Real the casts are no operations and the
// layout is the one the working type had before: those 8 instantiations
// keep their code.  The mixed pairs (float32 rows into a float64 tally, as
// a float32 state with a float64 tally writes them, and float64 rows into a
// float32 tally) add 8 more, with their own layouts and entry points
// (suffixed _f32t64 and _f64t32).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

// Layout shared with raster_kernel._RasterParams (ctypes; Real = float),
// _RasterParams64 (Real = double) and the mixed pairs' _RasterParams32t64
// and _RasterParams64t32 (all alike: the rows and tally are pointers).
template <typename Real, typename Tally = Real>
struct RasterParamsT {
  const Real* segs;                     // (cap, 5) rows
  const unsigned long long* nseg;       // rows written (may exceed cap)
  Tally* tally;                         // (ny * nx,) flat, row-major
  int* pieces;                          // (piece_cap,) row indices by tile
  unsigned long long* work;             // 4 * ntiles + 4 entries, see Work
  unsigned long long* out;              // [pieces, overflow], host-read
  long long cap;
  long long piece_cap;
  int nx;
  int ny;
};

using RasterParams = RasterParamsT<float>;
using RasterParams64 = RasterParamsT<double>;
using RasterParams32t64 = RasterParamsT<float, double>;
using RasterParams64t32 = RasterParamsT<double, float>;

namespace {

using namespace nt;

// The tally tile side in cells of each tally type.
template <typename Real>
constexpr int kTile = 128;
template <>
constexpr int kTile<double> = 64;

constexpr int kThreads = 256;           // bin kernels
constexpr int kBlocks = 132 * 16;       // 16 blocks per SM of an H100
constexpr int kScanThreads = 1024;
constexpr int kTileThreads = 512;
// Pieces per work item (C): a power of two in [kMinChunk, kMaxChunk], about
// pieces / (kItemsPerBlock x the tile kernel's resident blocks).
constexpr int kMinChunk = 1024;
constexpr int kMaxChunk = 16384;
constexpr int kItemsPerBlock = 8;
template <typename Real>
constexpr Real kTiny = static_cast<Real>(1.0e-12);
template <typename Real>
constexpr Real kBig = static_cast<Real>(1.0e30);

// The workspace (zeroed once by the caller): per-tile piece counts (zero
// between calls), piece offsets (ntiles + 1), fill cursors, work-item
// offsets (ntiles + 1), the next work item to take and the call's C.
struct Work {
  unsigned long long* count;
  unsigned long long* offset;
  unsigned long long* cursor;
  unsigned long long* item;
  unsigned long long* next;
  unsigned long long* chunk;
};

__device__ __forceinline__ Work views(unsigned long long* w, int ntiles) {
  return {w, w + ntiles, w + 2 * ntiles + 1, w + 3 * ntiles + 1,
          w + 4 * ntiles + 2, w + 4 * ntiles + 3};
}

template <typename Real>
struct Row {
  Real gx0, gy0, dgx, dgy, ivx, ivy, kk;
  int sx, sy, cx0, cy0;
};

// t of the cell wall at integer coordinate w: the walk's (ex - gx0) * ivx.
template <typename Real>
__device__ __forceinline__ Real wall_t(int w, Real g0, Real iv) {
  return (static_cast<Real>(w) - g0) * iv;
}

// The walk's per-row set-up (deposit_segments_plain); false for kk == 0.
template <typename Real>
__device__ __forceinline__ bool load_row(const Real* segs,
                                         unsigned long long s, int nx,
                                         int ny, Row<Real>& r) {
  const Real* row = segs + 5 * s;
  r.kk = row[4];
  if (r.kk == 0.0f) return false;
  r.gx0 = row[0];
  r.gy0 = row[1];
  r.dgx = row[2] - r.gx0;
  r.dgy = row[3] - r.gy0;
  r.ivx = 1.0f / (nt_fabs(r.dgx) < kTiny<Real>
                      ? (r.dgx < 0.0f ? -kTiny<Real> : kTiny<Real>)
                      : r.dgx);
  r.ivy = 1.0f / (nt_fabs(r.dgy) < kTiny<Real>
                      ? (r.dgy < 0.0f ? -kTiny<Real> : kTiny<Real>)
                      : r.dgy);
  r.sx = (r.dgx > 0.0f) - (r.dgx < 0.0f);
  r.sy = (r.dgy > 0.0f) - (r.dgy < 0.0f);
  r.cx0 = min(max(floor_int(r.gx0), 0), nx - 1);
  r.cy0 = min(max(floor_int(r.gy0), 0), ny - 1);
  return true;
}

// The tiles of side T a row visits, in order (tile_pieces_plain):
// visit(tile id).
template <int T, typename Real, typename Visit>
__device__ __forceinline__ void walk_tiles(const Row<Real>& r, int ntx,
                                           int nty, Visit visit) {
  int tx = r.cx0 / T;
  int ty = r.cy0 / T;
  for (int it = 0; it < ntx + nty + 2; ++it) {
    visit(ty * ntx + tx);
    const Real t_x = r.sx == 0 ? kBig<Real>
                               : wall_t((r.sx > 0 ? tx + 1 : tx) * T, r.gx0,
                                        r.ivx);
    const Real t_y = r.sy == 0 ? kBig<Real>
                               : wall_t((r.sy > 0 ? ty + 1 : ty) * T, r.gy0,
                                        r.ivy);
    const bool step_x = (t_x <= t_y) && (t_x < 1.0f);
    const bool step_y = !step_x && (t_y < 1.0f);
    tx += step_x ? r.sx : 0;
    ty += step_y ? r.sy : 0;
    if (!(step_x || step_y) || tx < 0 || tx >= ntx || ty < 0 || ty >= nty) {
      break;
    }
  }
}

// The cell along one axis that the walk occupies when it crosses the other
// axis's wall at t, inside tile index tidx of this axis: past every wall
// whose t is below t (raster._cross_cell), in tiles of side T.
template <int T, typename Real>
__device__ __forceinline__ int cross_cell(Real g0, Real iv, Real dg, int s,
                                          int c0, int tidx, Real t) {
  if (s == 0) return c0;
  int lo = tidx * T;
  int hi = lo + T - 1;
  if (s > 0) {
    lo = max(lo, c0);
  } else {
    hi = min(hi, c0);
  }
  int c = floor_int(nt_fmin(nt_fmax(g0 + t * dg, static_cast<Real>(lo)),
                            static_cast<Real>(hi)));
  if (s > 0) {
    while (c < hi && wall_t(c + 1, g0, iv) < t) ++c;
    while (c > lo && !(wall_t(c, g0, iv) < t)) --c;
  } else {
    while (c > lo && wall_t(c, g0, iv) < t) --c;
    while (c < hi && !(wall_t(c + 1, g0, iv) < t)) ++c;
  }
  return c;
}

// Where a row enters tile (tx, ty): its clipped start cell at t = 0 in its
// first tile; else the wall crossed last (x if the y wall's t is below the
// x wall's), at that wall's t, and along the other axis the cell that
// cross_cell finds (deposit_pieces_plain).  Sets the local cell and t;
// false if the cell is not in the tile (never, for the bins' pieces).
template <int T, typename Real>
__device__ __forceinline__ bool enter(const Row<Real>& r, int tx, int ty,
                                      int& lx, int& ly, Real& t_cur) {
  const int x_lo = tx * T;
  const int y_lo = ty * T;
  const bool cross_x = tx != r.cx0 / T;
  const bool cross_y = ty != r.cy0 / T;
  int cx = r.cx0;
  int cy = r.cy0;
  t_cur = 0.0f;
  if (cross_x || cross_y) {
    const Real t_x = wall_t(r.sx > 0 ? x_lo : x_lo + T, r.gx0, r.ivx);
    const Real t_y = wall_t(r.sy > 0 ? y_lo : y_lo + T, r.gy0, r.ivy);
    if (cross_x && (!cross_y || t_y < t_x)) {
      t_cur = t_x;
      cx = r.sx > 0 ? x_lo : x_lo + T - 1;
      cy = cross_cell<T>(r.gy0, r.ivy, r.dgy, r.sy, r.cy0, ty, t_x);
    } else {
      t_cur = t_y;
      cy = r.sy > 0 ? y_lo : y_lo + T - 1;
      cx = cross_cell<T>(r.gx0, r.ivx, r.dgx, r.sx, r.cx0, tx, t_y);
    }
  }
  lx = cx - x_lo;
  ly = cy - y_lo;
  return static_cast<unsigned>(lx) < static_cast<unsigned>(T) &&
         static_cast<unsigned>(ly) < static_cast<unsigned>(T);
}

// The walk of a row from local cell (lx, ly) of the tile at (x_lo, y_lo) at
// t_cur until it leaves the tile or t reaches 1: deposit_segments_plain's
// steps, with each axis's next wall time recomputed (by the same
// expression) only when that axis steps; each cell's kk * frac, both
// rounded to the tally's type first, goes into the tile `acc` of that type.
// kClip: the tile reaches past the grid, whose cells are dropped.
template <bool kClip, int T, typename Real, typename Tally>
__device__ __forceinline__ void walk_cells(const Row<Real>& r, int lx, int ly,
                                           Real t_cur, int x_lo, int y_lo,
                                           int nx, int ny, Tally* acc) {
  const int ox = x_lo + (r.sx > 0 ? 1 : 0);
  const int oy = y_lo + (r.sy > 0 ? 1 : 0);
  Real t_nx = r.sx == 0 ? kBig<Real> : wall_t(ox + lx, r.gx0, r.ivx);
  Real t_ny = r.sy == 0 ? kBig<Real> : wall_t(oy + ly, r.gy0, r.ivy);
  while (t_cur < 1.0f) {
    const Real tn = nt_fmin(nt_fmin(t_nx, t_ny), Real(1));
    const Real frac = nt_fmax(tn - t_cur, Real(0));
    if (!kClip || (x_lo + lx < nx && y_lo + ly < ny)) {
      const Tally v = static_cast<Tally>(r.kk) * static_cast<Tally>(frac);
      if (v != 0.0f) atomicAdd(&acc[ly * T + lx], v);
    }
    t_cur = tn;
    if ((t_nx <= t_ny) && (t_nx < 1.0f)) {
      lx += r.sx;
      if (static_cast<unsigned>(lx) >= static_cast<unsigned>(T)) break;
      t_nx = wall_t(ox + lx, r.gx0, r.ivx);
    } else if (t_ny < 1.0f) {
      ly += r.sy;
      if (static_cast<unsigned>(ly) >= static_cast<unsigned>(T)) break;
      t_ny = wall_t(oy + ly, r.gy0, r.ivy);
    }
  }
}

template <typename Real, typename Tally>
__global__ void __launch_bounds__(kThreads)
count_kernel(const RasterParamsT<Real, Tally> p) {
  constexpr int T = kTile<Tally>;
  const unsigned long long nseg =
      min(*p.nseg, static_cast<unsigned long long>(p.cap));
  const int ntx = (p.nx + T - 1) / T;
  const int nty = (p.ny + T - 1) / T;
  const Work w = views(p.work, ntx * nty);
  const int lane = threadIdx.x & 31;
  for (unsigned long long s =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
           threadIdx.x;
       s < nseg; s += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
    Row<Real> r;
    if (!load_row(p.segs, s, p.nx, p.ny, r)) continue;
    walk_tiles<T>(r, ntx, nty, [&](int tile) {
      const unsigned peers = __match_any_sync(__activemask(), tile);
      if (lane == __ffs(peers) - 1) {
        atomicAdd(&w.count[tile],
                  static_cast<unsigned long long>(__popc(peers)));
      }
    });
  }
}

// One block: picks C from the call's pieces and the tile kernel's resident
// `blocks`, then scans the piece counts (offsets, cursors) and their work
// items (ceil(count / C)) in passes of kScanThreads tiles.
template <typename Real, typename Tally>
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const RasterParamsT<Real, Tally> p, int ntiles, int blocks) {
  const Work w = views(p.work, ntiles);
  __shared__ unsigned long long warp_a[32];
  __shared__ unsigned long long warp_b[32];
  __shared__ unsigned long long carry[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long part = 0;
  for (int i = threadIdx.x; i < ntiles; i += kScanThreads) part += w.count[i];
  part = warp_sum_u64(part);
  if (lane == 0) warp_a[warp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int k = 0; k < kScanThreads / 32; ++k) total += warp_a[k];
    const unsigned long long want =
        total / (static_cast<unsigned long long>(kItemsPerBlock) * blocks);
    unsigned long long c = kMinChunk;
    while (c < kMaxChunk && 2 * c <= want) c *= 2;
    *w.chunk = c;
    carry[0] = carry[1] = 0;
  }
  __syncthreads();
  const unsigned long long chunk = *w.chunk;
  for (int base = 0; base < ntiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const unsigned long long a = i < ntiles ? w.count[i] : 0;
    const unsigned long long b = (a + chunk - 1) / chunk;
    unsigned long long ia = a;
    unsigned long long ib = b;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long ya = __shfl_up_sync(0xffffffffu, ia, off);
      const unsigned long long yb = __shfl_up_sync(0xffffffffu, ib, off);
      if (lane >= off) {
        ia += ya;
        ib += yb;
      }
    }
    if (lane == 31) {
      warp_a[warp] = ia;
      warp_b[warp] = ib;
    }
    __syncthreads();
    if (warp == 0) {
      unsigned long long xa = warp_a[lane];
      unsigned long long xb = warp_b[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long ya = __shfl_up_sync(0xffffffffu, xa, off);
        const unsigned long long yb = __shfl_up_sync(0xffffffffu, xb, off);
        if (lane >= off) {
          xa += ya;
          xb += yb;
        }
      }
      warp_a[lane] = xa;
      warp_b[lane] = xb;
    }
    __syncthreads();
    const unsigned long long pa =
        carry[0] + (warp ? warp_a[warp - 1] : 0) + ia - a;
    const unsigned long long pb =
        carry[1] + (warp ? warp_b[warp - 1] : 0) + ib - b;
    if (i < ntiles) {
      w.offset[i] = pa;
      w.cursor[i] = pa;
      w.item[i] = pb;
      w.count[i] = 0;
    }
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) {
      carry[0] = pa + a;
      carry[1] = pb + b;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    w.offset[ntiles] = carry[0];
    w.item[ntiles] = carry[1];
    *w.next = 0;
    p.out[0] = carry[0];
    p.out[1] =
        carry[0] > static_cast<unsigned long long>(p.piece_cap) ? 1ULL : 0ULL;
  }
}

template <typename Real, typename Tally>
__global__ void __launch_bounds__(kThreads)
fill_kernel(const RasterParamsT<Real, Tally> p) {
  constexpr int T = kTile<Tally>;
  if (p.out[1] != 0) return;            // overflow: the caller re-runs
  const unsigned long long nseg =
      min(*p.nseg, static_cast<unsigned long long>(p.cap));
  const int ntx = (p.nx + T - 1) / T;
  const int nty = (p.ny + T - 1) / T;
  const Work w = views(p.work, ntx * nty);
  const int lane = threadIdx.x & 31;
  for (unsigned long long s =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
           threadIdx.x;
       s < nseg; s += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
    Row<Real> r;
    if (!load_row(p.segs, s, p.nx, p.ny, r)) continue;
    walk_tiles<T>(r, ntx, nty, [&](int tile) {
      const unsigned peers = __match_any_sync(__activemask(), tile);
      const int leader = __ffs(peers) - 1;
      unsigned long long base = 0;
      if (lane == leader) {
        base = atomicAdd(&w.cursor[tile],
                         static_cast<unsigned long long>(__popc(peers)));
      }
      base = __shfl_sync(peers, base, leader);
      p.pieces[base + __popc(peers & ((1u << lane) - 1u))] =
          static_cast<int>(s);
    });
  }
}

// The tile in the block's dynamic shared memory (one extern float array,
// which starts aligned): as it is for a float32 tally, read as doubles for
// a float64 one.
__device__ __forceinline__ float* tile_acc(float* acc, float) { return acc; }
__device__ __forceinline__ double* tile_acc(float* acc, double) {
  return reinterpret_cast<double*>(acc);
}

template <typename Real, typename Tally>
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(const RasterParamsT<Real, Tally> p) {
  constexpr int T = kTile<Tally>;
  extern __shared__ float acc_smem[];   // T * T of the tally's type
  Tally* const acc = tile_acc(acc_smem, Tally(0));
  __shared__ unsigned long long item_sh;
  if (p.out[1] != 0) return;            // overflow: the caller re-runs
  const int ntx = (p.nx + T - 1) / T;
  const int ntiles = ntx * ((p.ny + T - 1) / T);
  const Work w = views(p.work, ntiles);
  const unsigned long long nitems = w.item[ntiles];
  const unsigned long long chunk = *w.chunk;
  for (int i = threadIdx.x; i < T * T; i += kTileThreads) acc[i] = 0.0f;
  for (;;) {
    if (threadIdx.x == 0) item_sh = atomicAdd(w.next, 1ULL);
    __syncthreads();
    const unsigned long long item = item_sh;
    if (item >= nitems) break;
    // The item's tile: the last k with item[k] <= item (it has items).
    int lo = 0;
    int hi = ntiles - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (w.item[mid] <= item) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const unsigned long long begin = w.offset[lo] + (item - w.item[lo]) * chunk;
    const int n = static_cast<int>(min(begin + chunk, w.offset[lo + 1]) - begin);
    const int tx = lo % ntx;
    const int ty = lo / ntx;
    const bool clip = (tx + 1) * T > p.nx || (ty + 1) * T > p.ny;
    for (int k = threadIdx.x; k < n; k += kTileThreads) {
      Row<Real> r;
      int lx, ly;
      Real t;
      if (!load_row(p.segs,
                    static_cast<unsigned long long>(p.pieces[begin + k]),
                    p.nx, p.ny, r) ||
          !enter<T>(r, tx, ty, lx, ly, t)) {
        continue;
      }
      const int x_lo = tx * T;
      const int y_lo = ty * T;
      if (clip) {
        walk_cells<true, T>(r, lx, ly, t, x_lo, y_lo, p.nx, p.ny, acc);
      } else {
        walk_cells<false, T>(r, lx, ly, t, x_lo, y_lo, p.nx, p.ny, acc);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < T * T; i += kTileThreads) {
      const Tally v = acc[i];
      if (v != 0.0f) {
        acc[i] = 0.0f;
        const int cx = tx * T + (i % T);
        const int cy = ty * T + (i / T);
        if (cx < p.nx && cy < p.ny) {
          atomicAdd(&p.tally[static_cast<long long>(cy) * p.nx + cx], v);
        }
      }
    }
    __syncthreads();
  }
}

constexpr int kMaxDevices = 64;

// Dynamic shared memory of a tile_kernel block of tally type Tally: its
// T x T tile.
template <typename Tally>
constexpr int kTileBytes = kTile<Tally> * kTile<Tally> *
                           static_cast<int>(sizeof(Tally));

// Persistent blocks of tile_kernel<Real, Tally> on the current device:
// every SM filled to its occupancy beside its tile (set up once per device,
// rows' type and tally type).
template <typename Real, typename Tally>
int tile_blocks() {
  static int blocks[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return 0;
  if (blocks[dev] == 0) {
    constexpr int bytes = kTileBytes<Tally>;
    cudaFuncSetAttribute(tile_kernel<Real, Tally>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    int sms = 0;
    int per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tile_kernel<Real, Tally>, kTileThreads, bytes);
    blocks[dev] = sms * (per_sm > 1 ? per_sm : 1);
  }
  return blocks[dev];
}

template <typename Real, typename Tally>
int launch_bin(const RasterParamsT<Real, Tally>& p, cudaStream_t s) {
  constexpr int T = kTile<Tally>;
  const int ntiles = ((p.nx + T - 1) / T) * ((p.ny + T - 1) / T);
  const int blocks = tile_blocks<Real, Tally>();
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidDevice);
  count_kernel<<<kBlocks, kThreads, 0, s>>>(p);
  scan_kernel<<<1, kScanThreads, 0, s>>>(p, ntiles, blocks);
  fill_kernel<<<kBlocks, kThreads, 0, s>>>(p);
  return 0;
}

template <typename Real, typename Tally>
int launch_tiles(const RasterParamsT<Real, Tally>& p, cudaStream_t s) {
  const int blocks = tile_blocks<Real, Tally>();
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidDevice);
  tile_kernel<<<blocks, kTileThreads, kTileBytes<Tally>, s>>>(p);
  return 0;
}

// Stage 1 on `stream`: count, scan and fill the bins of the first
// min(*p->nseg, p->cap) rows; writes p->out.  Returns cudaGetLastError().
template <typename Real, typename Tally>
int bin(const RasterParamsT<Real, Tally>* p, void* stream) {
  const int err = launch_bin(*p, static_cast<cudaStream_t>(stream));
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

// Stage 2 on `stream`: the tile deposit of the bins into p->tally (nothing
// when stage 1 flagged an overflow).  Returns cudaGetLastError().
template <typename Real, typename Tally>
int tiles(const RasterParamsT<Real, Tally>* p, void* stream) {
  const int err = launch_tiles(*p, static_cast<cudaStream_t>(stream));
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes by raster_kernel.py.

extern "C" int nt_raster_params_size() {
  return static_cast<int>(sizeof(RasterParams));
}

extern "C" int nt_raster_params_size_f64() {
  return static_cast<int>(sizeof(RasterParams64));
}

extern "C" int nt_raster_params_size_f32t64() {
  return static_cast<int>(sizeof(RasterParams32t64));
}

extern "C" int nt_raster_params_size_f64t32() {
  return static_cast<int>(sizeof(RasterParams64t32));
}

// The tile side T of the kernels into a float32 (f64 = 0) or float64
// (f64 = 1) tally, from rows of either type.
extern "C" int nt_raster_tile_side(int f64) {
  return f64 ? kTile<double> : kTile<float>;
}

// Persistent blocks of the tile kernel of float32 (rows_f64 = 0) or float64
// (rows_f64 = 1) rows into a float32 (tally_f64 = 0) or float64
// (tally_f64 = 1) tally on the current device (SMs x blocks an SM; 0 on an
// error).
extern "C" int nt_raster_tile_blocks(int rows_f64, int tally_f64) {
  if (rows_f64) {
    return tally_f64 ? tile_blocks<double, double>()
                     : tile_blocks<double, float>();
  }
  return tally_f64 ? tile_blocks<float, double>()
                   : tile_blocks<float, float>();
}

extern "C" int nt_raster_bin(const RasterParams* p, void* stream) {
  return bin(p, stream);
}

extern "C" int nt_raster_bin_f64(const RasterParams64* p, void* stream) {
  return bin(p, stream);
}

extern "C" int nt_raster_tiles(const RasterParams* p, void* stream) {
  return tiles(p, stream);
}

extern "C" int nt_raster_tiles_f64(const RasterParams64* p, void* stream) {
  return tiles(p, stream);
}

extern "C" int nt_raster_bin_f32t64(const RasterParams32t64* p,
                                    void* stream) {
  return bin(p, stream);
}

extern "C" int nt_raster_bin_f64t32(const RasterParams64t32* p,
                                    void* stream) {
  return bin(p, stream);
}

extern "C" int nt_raster_tiles_f32t64(const RasterParams32t64* p,
                                      void* stream) {
  return tiles(p, stream);
}

extern "C" int nt_raster_tiles_f64t32(const RasterParams64t32* p,
                                      void* stream) {
  return tiles(p, stream);
}
