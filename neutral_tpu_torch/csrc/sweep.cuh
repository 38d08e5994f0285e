// The sweep kernel's template (sweep_kernel, below) and its launch, shared
// by the translation units that instantiate it: sweep.cu the working types
// whose tally is of the state's type (float32, float64), sweep_mixed.cu the
// pairs whose tally is of the other (a float32 state with a float64 tally,
// a float64 state with a float32 tally), so that nvcc compiles the two
// halves in parallel.  The design is sweep.cu's comment.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

// Layout shared with sweep_kernel._SweepParams (ctypes; Real = float),
// _SweepParams64 (Real = double) and the mixed pairs' _SweepParams32t64
// (Real = float, Tally = double) and _SweepParams64t32 (Real = double,
// Tally = float); nt_params_size(), nt_params_size_f64() and their _f32t64
// and _f64t32 twins let the wrapper check that they agree.  The tally and
// inv_ntotal are of the tally's type Tally, everything else of the state's
// working type Real: with Tally = Real (the default) the layout is the one
// the working type had before the tally had a type of its own.  It has
// external linkage, so the extern "C" entry points that take it are
// exported.
template <typename Real, typename Tally = Real>
struct SweepParamsT {
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
  // [facets, collisions, lanes still working (the next list's length),
  //  the list cursor, lane events run, warp event steps]
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
  const int32_t* region_bounds; // region mode: (nregions, 4) ix0 ix1 iy0 iy1
  const Real* region_density;   // region mode: (nregions,)
  const Real* density;          // grid mode: (ny * nx,) window-local
  unsigned long long master_key;
  long long n;
  long long n_active;           // the list's length
  int blocks;                   // the grid (sweep_kernel.grid_blocks)
  int max_events;
  int nx;                       // the window's extent (the whole mesh
  int ny;                       // when unwindowed)
  int scatter_entries;
  int absorb_entries;
  int scatter_shift;            // table mode: log2 of the coarse strides
  int absorb_shift;
  int same_xs;
  int nregions;
  int xs_mode;                  // nt::XsMode
  int density_mode;             // nt::DensityMode
  int rng;                      // nt::RngScheme
  int x_off;                    // the window's first global cell
  int y_off;
  int global_nx;                // the whole mesh
  int global_ny;
  Real dx;
  Real dy;
  Tally inv_ntotal;
  const Real* edgex;            // edge-array mode: (global_nx + 1,)
  const Real* edgey;            // edge-array mode: (global_ny + 1,)
  int edge_mode;                // nt::EdgeMode
};

using SweepParams = SweepParamsT<float>;
using SweepParams64 = SweepParamsT<double>;
using SweepParams32t64 = SweepParamsT<float, double>;
using SweepParams64t32 = SweepParamsT<double, float>;

namespace {

using namespace nt;

constexpr int kThreads = 128;
constexpr unsigned int kFull = 0xffffffffu;
constexpr unsigned int kNeed = 0xffffffffu;

__device__ __forceinline__ unsigned int lane_id() { return threadIdx.x & 31u; }

// Whether positions are in the cell-local frame (float32 with a pitch) or
// global (float64, and every working type without a pitch), as
// transport.use_local_coords decides.
template <typename Real, EdgeMode E>
constexpr bool kCellLocal =
    std::is_same_v<Real, float> && E == EdgeMode::kPitch;

// The facets of cell c of pitch d that bound a lane moving up (edge_hi)
// and down (edge_lo, the open left/bottom facet overshot by kObc), as
// transport._facet_edges gives them: in float32 those of the cell-local
// frame, d and -kObc; in float64 the global (c + 1) * d and c * d - kObc,
// computed per event from the lane's global cell.  Each is an expression,
// not a local of the kernel: a float32 instantiation keeps its code.
__device__ __forceinline__ float edge_hi(float d, int) { return d; }
__device__ __forceinline__ float edge_lo(float, int) {
  return -Const<float>::kObc;
}
__device__ __forceinline__ double edge_hi(double d, int c) {
  return (static_cast<double>(c) + 1.0) * d;
}
__device__ __forceinline__ double edge_lo(double d, int c) {
  return static_cast<double>(c) * d - Const<double>::kObc;
}

// The facet edge that bounds a lane moving up (edge_above) or down
// (edge_below) in its global cell c along one axis: in pitch mode
// edge_hi/edge_lo of the pitch d; in edge-array mode read from `edges`, the
// axis's (n + 1,) edge array, with transport._facet_edges' clamps, the
// lower one overshot by kObc.  Functions, not locals of the kernel: a
// pitch-mode instantiation reads neither argument it does not use.
template <EdgeMode E, typename Real>
__device__ __forceinline__ Real edge_above(Real d, const Real* edges, int c,
                                           int n) {
  if constexpr (E == EdgeMode::kArray) {
    return __ldg(edges + min(max(c + 1, 0), n));
  } else {
    return edge_hi(d, c);
  }
}

template <EdgeMode E, typename Real>
__device__ __forceinline__ Real edge_below(Real d, const Real* edges, int c,
                                           int n) {
  if constexpr (E == EdgeMode::kArray) {
    return __ldg(edges + min(max(c, 0), n - 1)) - Const<Real>::kObc;
  } else {
    return edge_lo(d, c);
  }
}

// The bits of the warp's lanes below this one.
__device__ __forceinline__ unsigned int lanes_below() {
  return (1u << lane_id()) - 1u;
}

template <XsMode X, DensityMode D, RngScheme R, typename Real, EdgeMode E,
          typename Tally>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const SweepParamsT<Real, Tally> p) {
  using C = Const<Real>;
  // Table mode stages the coarse indexes once per launch: the blocks are
  // persistent.  The dynamic shared memory starts aligned (the kernel has
  // no static shared memory), so it holds doubles as well as floats.
  extern __shared__ float coarse_smem[];
  stage_tables<X>(p, coarse_smem);
  const XsTableT<Real> scatter = scatter_table(p, coarse_smem);
  const XsTableT<Real> absorb = absorb_table(p, coarse_smem);

  // The list position this thread loads next: pending while below
  // n_active, kNeed when the thread needs a new one, n_active when the
  // list is used up for it (lists hold fewer than 2^31 lanes).
  unsigned int pos = blockIdx.x * blockDim.x + threadIdx.x;
  bool have = false;            // the thread holds a lane
  int i = 0;                    // that lane
  int ev = 0;                   // its events in this launch

  Real x = 0.0f, y = 0.0f, omega_x = 0.0f, omega_y = 0.0f;
  Real energy = 0.0f, weight = 0.0f, dt = 0.0f, mfp = 0.0f, deposit = 0.0f;
  int cellx = 0, celly = 0;
  uint64_t counter = 0;
  DrawKey key{0, 0, 0};
  // The density is a function of the cell alone, so it is looked up again
  // only when the lane has entered another cell (in a dense deck nearly
  // every event is a collision in the same cell).
  int density_cell = -1;
  Real density = 0.0f;
  // The cross-sections and speed at the lane's energy, looked up at load
  // and again only after a collision (collide's one lookup): the energy
  // changes nowhere else.
  Real sig_s = 0.0f, sig_a = 0.0f, speed = 0.0f;
  int hint_s = kNoHint, hint_a = kNoHint;   // table mode: level-1 hints

  // Counts of this thread's events (a thread runs about a launch's events
  // over its threads, far below 2^32) and of its warp's event steps.
  unsigned int n_facets = 0, n_colls = 0, n_events = 0, n_steps = 0;

  // Whether the warp refills before its next event: at the start, and
  // after any of its lanes finished (the same on every thread of the warp).
  bool refill = true;

  for (;;) {
    // ---- refill: a thread without a lane loads the one at `pos`, unless
    // it has no work, and the threads that need a position take the next
    // ones from the cursor, one atomic for the warp; until every thread
    // has a lane or the list is used up for it ----
    if (refill) {
      for (;;) {
        if (!have && pos < p.n_active) {
          i = p.active ? p.active[pos] : static_cast<int>(pos);
          pos = kNeed;
          if (!p.dead[i] && p.dt_to_census[i] > 0.0f &&
              in_window(p.cellx[i], p.celly[i], p.x_off, p.y_off, p.nx,
                        p.ny)) {
            x = p.x[i];
            y = p.y[i];
            omega_x = p.omega_x[i];
            omega_y = p.omega_y[i];
            energy = p.energy[i];
            weight = p.weight[i];
            dt = p.dt_to_census[i];
            mfp = p.mfp_to_collision[i];
            deposit = p.deposit[i];
            cellx = p.cellx[i];
            celly = p.celly[i];
            key = draw_key<R>(static_cast<uint64_t>(p.pid[i]),
                              p.master_key);
            counter = static_cast<uint64_t>(p.counter[i]);
            density_cell = -1;
            hint_s = hint_a = kNoHint;
            sig_s = xs_value<X>(energy, scatter, hint_s);
            sig_a = p.same_xs ? sig_s : xs_value<X>(energy, absorb, hint_a);
            speed = nt_sqrt(C::kSpeedCoef * energy);
            ev = 0;
            have = true;
          }
        }
        const bool need = !have && pos == kNeed;
        const unsigned int need_mask = __ballot_sync(kFull, need);
        if (!need_mask) break;
        const int leader = __ffs(need_mask) - 1;
        unsigned long long base = 0;
        if (lane_id() == static_cast<unsigned int>(leader)) {
          base = atomicAdd(&p.counts[3],
                           static_cast<unsigned long long>(__popc(need_mask)));
        }
        base = __shfl_sync(kFull, base, leader);
        if (need) {
          const long long next = static_cast<long long>(gridDim.x) *
                                     blockDim.x +
                                 static_cast<long long>(base) +
                                 __popc(need_mask & lanes_below());
          pos = static_cast<unsigned int>(min(next, p.n_active));
        }
      }
      if (!__any_sync(kFull, have)) break;   // the list is used up
      refill = false;
    }
    n_steps += 1;

    // ---- one event of the lane ----
    bool finish = false, working = false, dead = false;
    if (have) {
      // local material state: the grid's cell, or the regions (later
      // regions override earlier ones)
      const int flat_cell = min(
          max((celly - p.y_off) * p.nx + (cellx - p.x_off), 0),
          p.nx * p.ny - 1);
      if (flat_cell != density_cell) {
        density_cell = flat_cell;
        if constexpr (D == DensityMode::kGrid) {
          density = __ldg(p.density + flat_cell);
        } else {
          const int4* bounds =
              reinterpret_cast<const int4*>(p.region_bounds);
          density = 0.0f;
          for (int r = 0; r < p.nregions; ++r) {
            const int4 b = __ldg(bounds + r);
            if (cellx >= b.x && cellx < b.y && celly >= b.z && celly < b.w) {
              density = __ldg(p.region_density + r);
            }
          }
        }
      }
      const Real sig_t = sig_s + sig_a;
      const Real number_density = density * C::kInvMolar;
      const Real mac_s = number_density * sig_s * C::kBarns;
      const Real mac_a = number_density * sig_a * C::kBarns;
      const Real mac_t = mac_s + mac_a;
      const Real cell_mfp = 1.0f / mac_t;

      // three candidate distances, from the cell's facet edges
      // (edge_above, edge_below: of the pitch, cell-local in float32 and
      // global in float64, or read from the edge arrays, global)
      const Real u_x_inv = 1.0f / (omega_x * speed);
      const Real u_y_inv = 1.0f / (omega_y * speed);
      const Real dt_x =
          omega_x >= 0.0f
              ? (edge_above<E>(p.dx, p.edgex, cellx, p.global_nx) - x) *
                    u_x_inv
              : (edge_below<E>(p.dx, p.edgex, cellx, p.global_nx) - x) *
                    u_x_inv;
      const Real dt_y =
          omega_y >= 0.0f
              ? (edge_above<E>(p.dy, p.edgey, celly, p.global_ny) - y) *
                    u_y_inv
              : (edge_below<E>(p.dy, p.edgey, celly, p.global_ny) - y) *
                    u_y_inv;
      const bool x_facet = dt_x < dt_y;
      const Real d_facet = (x_facet ? dt_x : dt_y) * speed;
      const Real d_coll = mfp * cell_mfp;
      const Real d_census = speed * dt;

      const bool is_coll = (d_coll < d_facet) && (d_coll < d_census);
      const bool is_facet = !is_coll && (d_facet < d_census);
      const bool is_census = !is_coll && !is_facet;
      const Real dist = is_coll ? d_coll : (is_facet ? d_facet : d_census);

      // segment energy deposition (pre-event state)
      const Real heating =
          energy - (1.0f - sig_a / sig_t) * (energy * C::kAvgScatterFrac);
      const Real ed =
          weight * dist * (sig_t * C::kBarns) * heating * number_density;
      deposit = deposit + ed;

      // move to the event site
      x = x + dist * omega_x;
      y = y + dist * omega_y;

      // collision: counter c for the event, c+1 for a survivor's new mean
      // free path; the cross-sections and speed follow the new energy
      bool died = false;
      if (is_coll) {
        died = collide<X, R>(key, counter, energy, weight, omega_x,
                             omega_y, mfp, sig_s, mac_a, mac_t,
                             number_density, scatter, hint_s);
        dt = dt - d_coll / speed;
        sig_a = p.same_xs ? sig_s : xs_value<X>(energy, absorb, hint_a);
        speed = nt_sqrt(C::kSpeedCoef * energy);
      }
      if (is_facet) {
        mfp = mfp - d_facet / cell_mfp;
        dt = dt - d_facet / speed;
      }
      if (is_census) {
        mfp = mfp - d_census / cell_mfp;
        dt = 0.0f;
      }

      // tally flush: leaving a cell, dying, or reaching census; the
      // deposit in the tally's type times inv_ntotal in it (a cast to the
      // working type itself is no operation)
      if (is_facet || is_census || died) {
        const Tally contrib = static_cast<Tally>(deposit) * p.inv_ntotal;
        deposit = 0.0f;
        if (contrib != 0.0f) atomicAdd(&p.tally[flat_cell], contrib);
      }

      // facet: step into the next cell (re-basing a cell-local position)
      // or reflect at the domain boundary; a lane that steps out
      // of the window stops here
      bool inwin = true;
      if (is_facet) {
        if (x_facet) {
          if (omega_x > 0.0f) {
            if (cellx >= p.global_nx - 1) {
              omega_x = -omega_x;
            } else {
              cellx += 1;
              if constexpr (kCellLocal<Real, E>) x = x - p.dx;
            }
          } else if (omega_x < 0.0f) {
            if (cellx <= 0) {
              omega_x = -omega_x;
            } else {
              cellx -= 1;
              if constexpr (kCellLocal<Real, E>) x = x + p.dx;
            }
          }
        } else {
          if (omega_y > 0.0f) {
            if (celly >= p.global_ny - 1) {
              omega_y = -omega_y;
            } else {
              celly += 1;
              if constexpr (kCellLocal<Real, E>) y = y - p.dy;
            }
          } else if (omega_y < 0.0f) {
            if (celly <= 0) {
              omega_y = -omega_y;
            } else {
              celly -= 1;
              if constexpr (kCellLocal<Real, E>) y = y + p.dy;
            }
          }
        }
        inwin = in_window(cellx, celly, p.x_off, p.y_off, p.nx, p.ny);
      }

      n_facets += is_facet;
      n_colls += is_coll;
      n_events += 1;
      ev += 1;
      dead = died;
      working = !died && dt > 0.0f && inwin;
      finish = !working || ev >= p.max_events;
    }

    // ---- finished lanes: one still working joins the next list (one
    // atomic for the warp); each goes back to its own index, and the warp
    // refills ----
    if (__ballot_sync(kFull, finish)) {
      const bool append = finish && working;
      const unsigned int append_mask = __ballot_sync(kFull, append);
      if (append_mask) {
        const int leader = __ffs(append_mask) - 1;
        unsigned long long base = 0;
        if (lane_id() == static_cast<unsigned int>(leader)) {
          base = atomicAdd(&p.counts[2], static_cast<unsigned long long>(
                                             __popc(append_mask)));
        }
        base = __shfl_sync(kFull, base, leader);
        if (append) {
          p.next[base + __popc(append_mask & lanes_below())] = i;
        }
      }
      if (finish) {
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
        have = false;
      }
      refill = true;
    }
  }

  // Counts: reduce per warp, one atomic per warp and count.
  const unsigned long long facets = warp_sum_u64(n_facets);
  const unsigned long long colls = warp_sum_u64(n_colls);
  const unsigned long long events = warp_sum_u64(n_events);
  if (lane_id() == 0) {
    if (facets) atomicAdd(&p.counts[0], facets);
    if (colls) atomicAdd(&p.counts[1], colls);
    atomicAdd(&p.counts[4], events);
    atomicAdd(&p.counts[5], static_cast<unsigned long long>(n_steps));
  }
}

}  // namespace

#define NT_SWEEP_EDGE_MODES(CASE, e)                                      \
  CASE(XsMode::kAnalytic, DensityMode::kRegions, RngScheme::kThreefry, e) \
  CASE(XsMode::kAnalytic, DensityMode::kRegions, RngScheme::kPcg64si, e)  \
  CASE(XsMode::kAnalytic, DensityMode::kGrid, RngScheme::kThreefry, e)    \
  CASE(XsMode::kAnalytic, DensityMode::kGrid, RngScheme::kPcg64si, e)     \
  CASE(XsMode::kTable, DensityMode::kRegions, RngScheme::kThreefry, e)    \
  CASE(XsMode::kTable, DensityMode::kRegions, RngScheme::kPcg64si, e)     \
  CASE(XsMode::kTable, DensityMode::kGrid, RngScheme::kThreefry, e)       \
  CASE(XsMode::kTable, DensityMode::kGrid, RngScheme::kPcg64si, e)

#define NT_SWEEP_MODES(CASE)                                              \
  NT_SWEEP_EDGE_MODES(CASE, EdgeMode::kPitch)                             \
  NT_SWEEP_EDGE_MODES(CASE, EdgeMode::kArray)

#define NT_SWEEP_MODE(x, d, r, e)                                         \
  ((static_cast<int>(e) << 3) | (static_cast<int>(x) << 2) |              \
   (static_cast<int>(d) << 1) | static_cast<int>(r))

// The mode of a launch's parameters, as NT_SWEEP_MODE numbers it.
template <typename Real, typename Tally>
int mode_of(const SweepParamsT<Real, Tally>* p) {
  return (p->edge_mode << 3) | (p->xs_mode << 2) | (p->density_mode << 1) |
         p->rng;
}

namespace {

// Blocks of the instantiation that a launch with parameters *p runs (its
// edge_mode, xs_mode, density_mode and rng, in p's working type and tally
// type) that one SM holds at once beside the launch's dynamic shared memory (table_smem_bytes), into
// *blocks; returns the CUDA error code (0 on success,
// cudaErrorInvalidValue for an unknown mode).
template <typename Real, typename Tally>
int blocks_per_sm(const SweepParamsT<Real, Tally>* p, int* blocks) {
  const size_t smem = table_smem_bytes(*p);
  switch (mode_of(p)) {
#define NT_SWEEP_CASE(x, d, r, e)                                         \
  case NT_SWEEP_MODE(x, d, r, e):                                         \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor( \
        blocks, sweep_kernel<x, d, r, Real, e, Tally>, kThreads, smem));
    NT_SWEEP_MODES(NT_SWEEP_CASE)
#undef NT_SWEEP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches one sweep of p->blocks persistent blocks over the p->n_active
// lanes of p->active (lanes 0 .. n_active - 1 when it is null) on `stream`,
// with the instantiation of p's modes, working type and tally type, and
// returns cudaGetLastError() (0 when the launch was accepted;
// cudaErrorInvalidValue for an unknown mode or an empty grid).
template <typename Real, typename Tally>
int launch(const SweepParamsT<Real, Tally>* p, void* stream) {
  if (p->n_active <= 0) return 0;
  if (p->blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = table_smem_bytes(*p);
  switch (mode_of(p)) {
#define NT_SWEEP_CASE(x, d, r, e)                                         \
  case NT_SWEEP_MODE(x, d, r, e):                                         \
    sweep_kernel<x, d, r, Real, e, Tally>                                 \
        <<<p->blocks, kThreads, smem, s>>>(*p);                           \
    break;
    NT_SWEEP_MODES(NT_SWEEP_CASE)
#undef NT_SWEEP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
