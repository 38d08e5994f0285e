// Free-flight kernel for NVIDIA Hopper (sm_90a): one thread per working lane.
//
// Replaces the TPU kernel neutral_tpu/pallas_flight.py::_kernel and
// ::_kernel_body (:59, :129; its pl.pallas_call is at :322).  That kernel
// advanced a VMEM-resident block of lanes through k_pieces masked flight
// pieces (flight.flight_core) and pushed tally flushes into per-lane flush
// rings and segments into per-lane segment rings, which the host drained
// between calls, because the TPU has no fast scatter or atomics.  Here each
// thread owns one lane: it runs up to `max_pieces` pieces (stopping early
// when the particle dies or reaches census), with the plain version's
// (neutral_tpu_torch/flight.py flight_core) operations in the same order and
// the same constants (common.cuh Const).  Per piece:
//
//   * a piece that crosses at least 2 cell boundaries first reserves one
//     row of the global segment buffer with an atomic counter (counts[3]).
//     When the buffer is full the reservation fails and the lane stops
//     *before* the piece, with nothing of it done: no flush, no count, no
//     state change.  It is still working, so the next launch runs the piece
//     again; the counter, which goes on counting failed reservations, tells
//     the host how many rows the launch wanted (flight_kernel.py grows the
//     buffer).  No row is ever dropped, and the buffer's size bounds
//     nothing but the rows of one launch.  raster.cu deposits the first
//     min(counts[3], seg_cap) rows after the launch.
//   * the first cell's flush and the final cell's death/census flush go
//     straight into the tally with atomicAdd, skipping zero values
//     (a vacuum piece deposits exactly 0), as pallas_flight.py:156-161 does;
//   * the reserved row [gx0, gy0, gx1, gy1, kk] is written;
//   * facet and collision counts go into 64-bit totals (a piece can cross
//     nx + ny cells), reduced per warp.
//
// The spatial window of a decomposed run (pallas_flight.py's `windowed`
// mode, :61, :88-102, :314-318) is a runtime parameter: the launch names
// the window [x_off, x_off + nx) x [y_off, y_off + ny) of the global_nx x
// global_ny mesh (an unwindowed launch passes offsets 0 and the global
// extent).  Rect walls clamp to the window, so a piece ends at the shard's
// boundary as at a rect wall; the reflecting boundary stays global; flushes
// and segment rows are window-local; a lane outside the window is not
// touched, and one that leaves it stops after that piece for the host to
// migrate.
//
// Rings, pause gating, the segment-plane layout and ring extraction have no
// counterpart.  A uniform mesh with constant-density rects only (an (R, 4)
// int32 bounds array and an (R,) density array in the working type on the
// device, any R); the cross-section mode (analytic, or a stored table
// searched through its coarse index in shared memory), the RNG scheme
// (threefry or pcg64si) and the working type (float32, or float64: what
// neutral_tpu's XLA flight engine, flight.py flight_core and
// flight_chunk_impl, computes on a GPU or CPU) are template parameters
// (common.cuh), one instantiation per combination, chosen at launch.
// Positions are global in both working types, as in flight_core; the
// state and the segment rows are in the working type (the plain version
// writes float64 rows in float64, flight.py's p.kk.to(state.dtype)).
//
// The tally has a type of its own (Tally, a template parameter beside the
// working type, as SimConfig.tally_dtype is in neutral_tpu, whose TPU kernel
// takes it as its own parameter, pallas_flight.py:214): each flush is the
// accumulated deposit rounded to the tally's type times inv_ntotal in that
// type, skipped when 0, and a row's kk is (K * seg_len) rounded to the
// tally's type, times inv_ntotal in it, rounded to the working type
// (flight.py's (K * seg_len).to(tally) * inv, then .to(state.dtype)).
// With Tally = Real every cast is no operation and the layout is the one
// the working type had before: those 8 instantiations keep their code.
// The mixed pairs (a float32 state with a float64 tally, a float64 state
// with a float32 tally) add 8 more, with their own layouts and entry points
// (suffixed _f32t64 and _f64t32).  The wrapper (flight_kernel.py) rejects
// everything else.  The build passes -fmad=false (build.py), so no a*b+c
// is fused.
// The float32 instantiations keep the code they had before the working
// type was a template parameter: what differs by type goes through
// common.cuh's overloads (nt_sqrt, floor_int, tmin/tmax, the tables'
// float64 views of the shared array), not through locals of the kernel.
//
// The census tail.  A warp runs as long as its longest lane, and lanes sit
// in pid order, so one warp mixes histories of one piece (vacuum) with
// histories of a thousand (dense rects), and late launches found a few
// working lanes scattered over every warp of the state.  So a launch runs
// over a list of working lanes: thread t takes lane active[t] (lane t when
// the launch has no list, as the first of a census does), and each lane
// still working after its pieces appends its index to the next list, at a
// slot from one warp-aggregated atomicAdd on counts[2] (whose value is then
// the next list's length, which the host reads each round anyway).  Lanes
// are read and written at their own index; no field is permuted.  After
// the first launch every warp is full of working lanes, and the host sizes
// each grid from the list's length and picks the pieces of each launch
// from it (flight_kernel.pieces_for).
//
// What bounds it on the H100: in dense rects, the draws' integer work (two
// draws per collision), as in sweep.cu, and in table mode the latency of
// the table lookups (common.cuh: a gallop down a shared-memory coarse
// index, whose copy each block makes at its start, then two L2 round
// trips; the table entry point caps the registers at 64, 8 blocks an SM);
// in vacuum, nothing much — a piece crosses a whole rect in ~150 float
// operations.  Lanes of a list are gathered (their
// indices are increasing within a warp, not contiguous); a short list is
// latency-bound: its launch lasts as long as its longest history.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

// Layout shared with flight_kernel._FlightParams (ctypes; Real = float),
// _FlightParams64 (Real = double), _FlightParams32t64 (Real = float, Tally =
// double) and _FlightParams64t32 (Real = double, Tally = float);
// nt_flight_params_size() and its _f64, _f32t64 and _f64t32 twins let the
// wrapper check that they agree.  The tally and inv_ntotal are of the
// tally's type, the rest of the working type.
template <typename Real, typename Tally = Real>
struct FlightParamsT {
  Real* x;
  Real* y;
  Real* omega_x;
  Real* omega_y;
  Real* energy;
  Real* weight;
  Real* dt_to_census;
  Real* mfp_to_collision;
  Real* deposit;
  int32_t* cellx;
  int32_t* celly;
  uint8_t* dead;
  const int64_t* pid;
  int64_t* counter;
  Tally* tally;                 // (ny * nx,) flat, row-major, window-local
  Real* segs;                   // (seg_cap, 5) rows [gx0, gy0, gx1, gy1, kk]
                                // in window-local cell units
  // [facets, collisions, lanes still working (the next list's length),
  //  segment rows reserved (those past seg_cap were refused)]
  unsigned long long* counts;
  const int32_t* active;        // (n_active,) lanes to run; null: lane t
  int32_t* next;                // (n,) the lanes still working after it
  const Real* scatter_keys;     // table mode: (scatter_entries,) ascending
  const nt::Interval<Real>* scatter_intervals;  // table mode: (entries - 1,)
  const Real* scatter_coarse;   // table mode: its coarse index
  const Real* absorb_keys;      // table mode: (absorb_entries,)
  const nt::Interval<Real>* absorb_intervals;
  const Real* absorb_coarse;
  const nt::Pair<Real>* scatter_grid;  // analytic mode: (entries,) pairs
  const nt::Pair<Real>* absorb_grid;   // analytic mode: (entries,) pairs
  const int32_t* rect_bounds;   // (nrects, 4) ix0 ix1 iy0 iy1, disjoint
  const Real* rect_density;     // (nrects,)
  unsigned long long master_key;
  long long n;
  long long n_active;           // threads of the launch
  long long seg_cap;
  int max_pieces;
  int nx;                       // the window's extent (the whole mesh
  int ny;                       // when unwindowed)
  int scatter_entries;
  int absorb_entries;
  int scatter_shift;            // table mode: log2 of the coarse strides
  int absorb_shift;
  int same_xs;
  int nrects;
  int xs_mode;                  // nt::XsMode
  int rng;                      // nt::RngScheme
  int x_off;                    // the window's first global cell
  int y_off;
  int global_nx;                // the whole mesh
  int global_ny;
  Real dx;
  Real dy;
  Real inv_dx;
  Real inv_dy;
  Tally inv_ntotal;
};

using FlightParams = FlightParamsT<float>;
using FlightParams64 = FlightParamsT<double>;
using FlightParams32t64 = FlightParamsT<float, double>;
using FlightParams64t32 = FlightParamsT<double, float>;

namespace {

using namespace nt;

constexpr int kThreads = 128;

// The kernel's body in every mode and working type (the entry points below
// run it).  It takes the parameters by value, as a kernel does: the
// analytic entry then compiles to the code of the single kernel it
// replaces.
template <XsMode X, RngScheme R, typename Real, typename Tally>
__device__ __forceinline__ void flight_pieces(
    const FlightParamsT<Real, Tally> p) {
  using C = Const<Real>;
  // Table mode stages the coarse indexes at the block's start, with every
  // thread, before any lane is loaded.  The dynamic shared memory starts
  // aligned (no static shared memory), so it holds doubles as well: the
  // tables' float64 overloads (common.cuh) read it as such.
  extern __shared__ float coarse_smem[];
  stage_tables<X>(p, coarse_smem);
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i =
      t >= p.n_active ? -1 : (p.active ? static_cast<long long>(p.active[t])
                                       : t);
  unsigned long long n_facets = 0, n_colls = 0;
  bool working = false;

  if (i >= 0 && !p.dead[i] && p.dt_to_census[i] > 0.0f &&
      in_window(p.cellx[i], p.celly[i], p.x_off, p.y_off, p.nx, p.ny)) {
    Real x = p.x[i], y = p.y[i];
    Real omega_x = p.omega_x[i], omega_y = p.omega_y[i];
    Real energy = p.energy[i], weight = p.weight[i];
    Real dt = p.dt_to_census[i], mfp = p.mfp_to_collision[i];
    Real deposit = p.deposit[i];
    int cellx = p.cellx[i], celly = p.celly[i];
    const DrawKey key =
        draw_key<R>(static_cast<uint64_t>(p.pid[i]), p.master_key);
    uint64_t counter = static_cast<uint64_t>(p.counter[i]);
    bool dead = false;
    bool inwin = true;
    const XsTableT<Real> scatter = scatter_table(p, coarse_smem);
    const XsTableT<Real> absorb = absorb_table(p, coarse_smem);
    const int4* bounds = reinterpret_cast<const int4*>(p.rect_bounds);
    const Real xo = static_cast<Real>(p.x_off);
    const Real yo = static_cast<Real>(p.y_off);
    // The lane's rect clamped to the window, searched again only when the
    // cell has left it: the rects are disjoint and cover the domain
    // (flight.disjoint_rects), so while the cell stays inside, the search
    // would find the same rect.  The empty rect forces the first search.
    Real rho = 0.0f;
    int rix0 = 0, rix1 = 0, riy0 = 0, riy1 = 0;
    // The cross-sections and speed at the lane's energy, looked up here and
    // again only after a collision (collide's one lookup): the energy
    // changes nowhere else.
    int hint_s = kNoHint, hint_a = kNoHint;   // table mode: level-1 hints
    Real sig_s = xs_value<X>(energy, scatter, hint_s);
    Real sig_a = p.same_xs ? sig_s : xs_value<X>(energy, absorb, hint_a);
    Real speed = nt_sqrt(C::kSpeedCoef * energy);

    for (int piece = 0; piece < p.max_pieces && !dead && dt > 0.0f && inwin;
         ++piece) {
      // ---- current rect by cell membership, clamped to the window ----
      if (!(cellx >= rix0 && cellx < rix1 && celly >= riy0 &&
            celly < riy1)) {
        rho = 0.0f;
        rix0 = 0;
        rix1 = p.global_nx;
        riy0 = 0;
        riy1 = p.global_ny;
        for (int r = 0; r < p.nrects; ++r) {
          const int4 b = __ldg(bounds + r);
          if (cellx >= b.x && cellx < b.y && celly >= b.z && celly < b.w) {
            rho = __ldg(p.rect_density + r);
            rix0 = b.x;
            rix1 = b.y;
            riy0 = b.z;
            riy1 = b.w;
          }
        }
        rix0 = max(rix0, p.x_off);
        rix1 = min(rix1, p.x_off + p.nx);
        riy0 = max(riy0, p.y_off);
        riy1 = min(riy1, p.y_off + p.ny);
      }

      // ---- material state ----
      const Real sig_t = sig_s + sig_a;
      const Real number_density = rho * C::kInvMolar;
      const Real mac_s = number_density * sig_s * C::kBarns;
      const Real mac_a = number_density * sig_a * C::kBarns;
      const Real mac_t = mac_s + mac_a;
      const Real cell_mfp = 1.0f / mac_t;

      // ---- distances to the rect walls (the open left/bottom wall
      // overshoots by kObc) ----
      const Real u_x_inv = 1.0f / (omega_x * speed);
      const Real u_y_inv = 1.0f / (omega_y * speed);
      const Real wx_pos = static_cast<Real>(rix1) * p.dx;
      const Real wx_neg = static_cast<Real>(rix0) * p.dx - C::kObc;
      const Real wy_pos = static_cast<Real>(riy1) * p.dy;
      const Real wy_neg = static_cast<Real>(riy0) * p.dy - C::kObc;
      const Real dt_x = omega_x >= 0.0f ? (wx_pos - x) * u_x_inv
                                        : (wx_neg - x) * u_x_inv;
      const Real dt_y = omega_y >= 0.0f ? (wy_pos - y) * u_y_inv
                                        : (wy_neg - y) * u_y_inv;
      const bool x_wall = dt_x < dt_y;
      const Real d_exit = (x_wall ? dt_x : dt_y) * speed;
      const Real d_coll = mfp * cell_mfp;
      const Real d_census = speed * dt;

      const bool is_coll = (d_coll < d_exit) && (d_coll < d_census);
      const bool is_exit = !is_coll && (d_exit < d_census);
      const bool is_census = !is_coll && !is_exit;
      const Real d =
          tmax(is_coll ? d_coll : (is_exit ? d_exit : d_census), Real(0));

      // ---- endpoint and new cell ----
      const Real x1 = x + d * omega_x;
      const Real y1 = y + d * omega_y;
      const bool pos_x = omega_x > 0.0f;
      const bool pos_y = omega_y > 0.0f;
      const bool exit_x = is_exit && x_wall;
      const bool exit_y = is_exit && !x_wall;
      const bool refl_x =
          exit_x && ((pos_x && rix1 == p.global_nx) || (!pos_x && rix0 == 0));
      const bool refl_y =
          exit_y && ((pos_y && riy1 == p.global_ny) || (!pos_y && riy0 == 0));

      // floor, then int32 as XLA converts (NaN to 0, saturated)
      const int fcx = floor_int(x1 * p.inv_dx);
      const int fcy = floor_int(y1 * p.inv_dy);
      const int in_cx = min(max(fcx, rix0), rix1 - 1);
      const int in_cy = min(max(fcy, riy0), riy1 - 1);
      const int cx1 =
          exit_x ? (refl_x ? (pos_x ? rix1 - 1 : rix0)
                           : (pos_x ? rix1 : rix0 - 1))
                 : in_cx;
      const int cy1 =
          exit_y ? (refl_y ? (pos_y ? riy1 - 1 : riy0)
                           : (pos_y ? riy1 : riy0 - 1))
                 : in_cy;

      // ---- the interior segment's row, reserved before any side effect
      // of the piece; without one the lane stops here, still working ----
      const int ncross = abs(cx1 - cellx) + abs(cy1 - celly);
      const bool emit = ncross >= 2;
      unsigned long long row = 0;
      if (emit) {
        row = atomicAdd(&p.counts[3], 1ULL);
        if (row >= static_cast<unsigned long long>(p.seg_cap)) break;
      }

      // ---- facet events: boundary crossings (+1 for the reflection) ----
      n_facets += static_cast<unsigned long long>(ncross) +
                  ((refl_x || refl_y) ? 1ULL : 0ULL);

      // ---- deposit bookkeeping: K = deposit per unit path ----
      const Real heating =
          energy - (1.0f - sig_a / sig_t) * (energy * C::kAvgScatterFrac);
      const Real K = weight * (sig_t * C::kBarns) * heating * number_density;

      // Exit distance of the first cell.
      const Real ex_pos = static_cast<Real>(cellx + 1) * p.dx;
      const Real ex_neg = static_cast<Real>(cellx) * p.dx - C::kObc;
      const Real ey_pos = static_cast<Real>(celly + 1) * p.dy;
      const Real ey_neg = static_cast<Real>(celly) * p.dy - C::kObc;
      const Real cdt_x = omega_x >= 0.0f ? (ex_pos - x) * u_x_inv
                                         : (ex_neg - x) * u_x_inv;
      const Real cdt_y = omega_y >= 0.0f ? (ey_pos - y) * u_y_inv
                                         : (ey_neg - y) * u_y_inv;
      const Real d_head =
          tmin(tmax(tmin(cdt_x, cdt_y) * speed, Real(0)), d);

      // Entry distance of the final cell.
      const Real d_inx =
          cx1 > cellx ? (static_cast<Real>(cx1) * p.dx - x) * u_x_inv
          : cx1 < cellx
              ? (static_cast<Real>(cx1 + 1) * p.dx - x) * u_x_inv
              : Real(0);
      const Real d_iny =
          cy1 > celly ? (static_cast<Real>(cy1) * p.dy - y) * u_y_inv
          : cy1 < celly
              ? (static_cast<Real>(cy1 + 1) * p.dy - y) * u_y_inv
              : Real(0);
      const Real d_in =
          tmax(tmin(tmax(tmax(d_inx, d_iny) * speed, Real(0)), d), d_head);

      const bool crossed = ncross > 0;
      // One crossing: no interior cells; the head takes the gap.
      const Real d_head_eff = emit ? d_head : d_in;

      // First cell: accumulate, then flush on leaving it, in the tally's
      // type (atomicAdd on float* or the native atomicAdd on double*).
      const Real acc1 = deposit + K * (crossed ? d_head_eff : d);
      if (crossed) {
        const Tally v1 = static_cast<Tally>(acc1) * p.inv_ntotal;
        if (v1 != 0.0f) {
          atomicAdd(&p.tally[(celly - p.y_off) * p.nx + (cellx - p.x_off)],
                    v1);
        }
      }
      // Final cell: the tail accumulates.
      const Real acc2 = crossed ? K * (d - d_in) : acc1;

      // ---- interior segment, from the pre-piece position, in window-local
      // cell units (an exact shift; 0 when unwindowed) ----
      if (emit) {
        const Real seg_len = tmax(d_in - d_head_eff, Real(0));
        Real* out = p.segs + 5 * row;
        out[0] = (x + d_head_eff * omega_x) * p.inv_dx - xo;
        out[1] = (y + d_head_eff * omega_y) * p.inv_dy - yo;
        out[2] = (x + d_in * omega_x) * p.inv_dx - xo;
        out[3] = (y + d_in * omega_y) * p.inv_dy - yo;
        out[4] = static_cast<Real>(static_cast<Tally>(K * seg_len) *
                                   p.inv_ntotal);
      }

      // ---- collision (omega after the collision, then the reflection) ----
      bool died = false;
      if (is_coll) {
        died = collide<X, R>(key, counter, energy, weight, omega_x,
                             omega_y, mfp, sig_s, mac_a, mac_t,
                             number_density, scatter, hint_s);
        n_colls += 1;
      }
      if (refl_x) omega_x = -omega_x;
      if (refl_y) omega_y = -omega_y;

      // Death or census: flush the final cell.
      if (died || is_census) {
        const Tally v2 = static_cast<Tally>(acc2) * p.inv_ntotal;
        if (v2 != 0.0f) {
          atomicAdd(&p.tally[(cy1 - p.y_off) * p.nx + (cx1 - p.x_off)], v2);
        }
        deposit = 0.0f;
      } else {
        deposit = acc2;
      }

      // ---- mean free path and census clock ----
      if (is_exit || is_census) mfp = mfp - d / cell_mfp;
      dt = dt - d / speed;
      if (is_census) dt = 0.0f;
      if (is_coll) {
        sig_a = p.same_xs ? sig_s : xs_value<X>(energy, absorb, hint_a);
        speed = nt_sqrt(C::kSpeedCoef * energy);
      }

      x = x1;
      y = y1;
      cellx = cx1;
      celly = cy1;
      dead = died;
      inwin = in_window(cellx, celly, p.x_off, p.y_off, p.nx, p.ny);
    }

    working = !dead && dt > 0.0f && inwin;
    p.x[i] = x;
    p.y[i] = y;
    p.omega_x[i] = omega_x;
    p.omega_y[i] = omega_y;
    p.energy[i] = energy;
    p.weight[i] = weight;
    p.dt_to_census[i] = dt;
    p.mfp_to_collision[i] = mfp;
    p.deposit[i] = deposit;
    p.cellx[i] = cellx;
    p.celly[i] = celly;
    p.dead[i] = dead;
    p.counter[i] = static_cast<int64_t>(counter);
  }

  // The next list: one atomic per warp takes the slots of its working
  // lanes, which keep their order within the warp.
  const unsigned int lane = threadIdx.x & 31u;
  const unsigned int mask = __ballot_sync(0xffffffffu, working);
  if (mask) {
    const int leader = __ffs(mask) - 1;
    unsigned long long base = 0;
    if (lane == static_cast<unsigned int>(leader)) {
      base = atomicAdd(&p.counts[2],
                       static_cast<unsigned long long>(__popc(mask)));
    }
    base = __shfl_sync(0xffffffffu, base, leader);
    if (working) {
      p.next[base + __popc(mask & ((1u << lane) - 1u))] =
          static_cast<int32_t>(i);
    }
  }

  // Counts: reduce per warp, one atomic per warp and count.
  n_facets = warp_sum_u64(n_facets);
  n_colls = warp_sum_u64(n_colls);
  if (lane == 0) {
    if (n_facets) atomicAdd(&p.counts[0], n_facets);
    if (n_colls) atomicAdd(&p.counts[1], n_colls);
  }
}

// The entry points.  Table mode caps the registers at TableBlocks<Real>
// blocks an SM beside the blocks' coarse indexes in shared memory: for a
// float32 state 8 (64 registers), for a float64 state kTableBlocks64 (the
// doubles take two registers each; under float32's cap they would spill),
// whatever the tally's type; the analytic mode keeps the compiler's own
// allocation.
constexpr int kTableBlocks = 8;
constexpr int kTableBlocks64 = 5;

template <typename Real>
struct TableBlocks {
  static constexpr int value = kTableBlocks;
};
template <>
struct TableBlocks<double> {
  static constexpr int value = kTableBlocks64;
};

template <RngScheme R, typename Real, typename Tally>
__global__ void __launch_bounds__(kThreads)
flight_kernel_analytic(const FlightParamsT<Real, Tally> p) {
  flight_pieces<XsMode::kAnalytic, R>(p);
}

template <RngScheme R, typename Real, typename Tally>
__global__ void __launch_bounds__(kThreads, TableBlocks<Real>::value)
flight_kernel_table(const FlightParamsT<Real, Tally> p) {
  flight_pieces<XsMode::kTable, R>(p);
}

template <XsMode X, RngScheme R, typename Real, typename Tally>
void launch(const FlightParamsT<Real, Tally>& p, unsigned int blocks,
            size_t smem, cudaStream_t s) {
  if constexpr (X == XsMode::kAnalytic) {
    flight_kernel_analytic<R><<<blocks, kThreads, smem, s>>>(p);
  } else {
    flight_kernel_table<R><<<blocks, kThreads, smem, s>>>(p);
  }
}

// Launches one round of up to p->max_pieces pieces over the p->n_active
// lanes of p->active (lanes 0 .. n_active - 1 when it is null) on `stream`,
// with the instantiation of p's modes, working type and tally type, and
// returns cudaGetLastError() (0 when the launch was accepted;
// cudaErrorInvalidValue for an unknown mode).
template <typename Real, typename Tally>
int launch_round(const FlightParamsT<Real, Tally>* p, void* stream) {
  if (p->n_active <= 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((p->n_active + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = table_smem_bytes(*p);
  using X = XsMode;
  using R = RngScheme;
  switch ((p->xs_mode << 1) | p->rng) {
#define NT_FLIGHT_CASE(x, r)                                              \
  case ((static_cast<int>(x) << 1) | static_cast<int>(r)):               \
    launch<x, r>(*p, blocks, smem, s);                                    \
    break;
    NT_FLIGHT_CASE(X::kAnalytic, R::kThreefry)
    NT_FLIGHT_CASE(X::kAnalytic, R::kPcg64si)
    NT_FLIGHT_CASE(X::kTable, R::kThreefry)
    NT_FLIGHT_CASE(X::kTable, R::kPcg64si)
#undef NT_FLIGHT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes by flight_kernel.py.

extern "C" int nt_flight_params_size() {
  return static_cast<int>(sizeof(FlightParams));
}

extern "C" int nt_flight_params_size_f64() {
  return static_cast<int>(sizeof(FlightParams64));
}

extern "C" int nt_flight_launch(const FlightParams* p, void* stream) {
  return launch_round(p, stream);
}

extern "C" int nt_flight_launch_f64(const FlightParams64* p, void* stream) {
  return launch_round(p, stream);
}

extern "C" int nt_flight_params_size_f32t64() {
  return static_cast<int>(sizeof(FlightParams32t64));
}

extern "C" int nt_flight_params_size_f64t32() {
  return static_cast<int>(sizeof(FlightParams64t32));
}

extern "C" int nt_flight_launch_f32t64(const FlightParams32t64* p,
                                       void* stream) {
  return launch_round(p, stream);
}

extern "C" int nt_flight_launch_f64t32(const FlightParams64t32* p,
                                       void* stream) {
  return launch_round(p, stream);
}
