// Fused event sweep for NVIDIA Hopper (sm_90a): one thread per particle lane.
//
// Replaces the TPU kernel neutral_tpu/pallas_sweep.py::_kernel (:59; its
// pl.pallas_call is at :293, launched by pallas_multi_sweep and looped by
// pallas_sweep_chunk).  That kernel advanced a VMEM-resident block of lanes
// through K masked events of transport.sweep_core and pushed tally flushes
// into per-lane rings, because the TPU has no fast scatter or atomics.  Here
// each thread owns one lane: it loads the lane's state into registers, runs
// events until the particle dies, reaches census (dt_to_census <= 0) or has
// run `max_events` events in this launch, and writes the state back.  Tally
// flushes (facet, census, death) go straight into the tally with
// atomicAdd(float*); zero contributions skip the atomic.  Rings, pause
// gating, ring drains and the all-dead block early-out have no counterpart.
//
// Each event is the plain version's (neutral_tpu_torch/transport.py
// sweep_core) operations in the same order, with the same float32 constants.
// The build passes -fmad=false: nvcc would otherwise contract a*b+c into
// fused multiply-adds, which PyTorch's one-operation-per-kernel arithmetic
// does not do, and branch decisions would drift from the plain version.
// float32 on a uniform mesh only; the deck's modes are template parameters
// (common.cuh), one instantiation per combination, chosen at launch:
//
//   * cross-sections: the analytic resonance formula, or a stored table
//     searched in global memory (table mode, for user .cs files);
//   * density: the region rectangles, an (R, 4) int32 bounds array and an
//     (R,) float32 density array on the device, scanned in order (later
//     regions override earlier ones; any R), or a per-cell grid (grid mode,
//     density_file decks).  Grid mode reads density[flat_cell] of the cell
//     the event starts in, so the whole event uses that cell's material, as
//     in the reference; neutral_tpu's carried density, stale freeze and
//     refresh gather (pallas_sweep.py:120-145) are TPU mechanisms with no
//     counterpart here;
//   * draws: threefry or pcg64si.
//
// The spatial window of a decomposed run (pallas_sweep.py's has_slab and
// has_col modes, :61 and :91-105) is a runtime parameter, not a template
// mode: the launch names the window [x_off, x_off + nx) x [y_off, y_off +
// ny) of the global_nx x global_ny mesh, and an unwindowed launch passes
// offsets 0 and the global extent.  The tally and a grid deck's density are
// window-local (row-major over nx columns); the regions and the reflecting
// boundary are global.  A lane outside the window is not touched; a lane
// that leaves the window stops after the facet event that took it out (its
// flush lands in the cell it left), and the host migrates it to its owner.
//
// The wrapper (sweep_kernel.py) rejects everything else.
//
// What bounds it on the H100: integer throughput of Threefry-2x64-20 (about
// 20 rounds of 64-bit add, rotate and xor per draw, two draws per
// collision; a pcg64si draw is two 64-bit multiply chains instead), the
// dependent L2 loads of a table search in table mode (about 15 per lookup,
// two or three lookups per collision), and warp divergence in the census
// tail, where a warp runs as long as its longest history.  This version
// does nothing about any of them yet.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

// Layout shared with sweep_kernel._SweepParams (ctypes); nt_params_size()
// lets the wrapper check that the two agree.  It has external linkage, so
// the extern "C" entry points that take it are exported.
struct SweepParams {
  float* x;
  float* y;
  float* omega_x;
  float* omega_y;
  float* energy;
  float* weight;
  float* dt_to_census;
  float* mfp_to_collision;
  float* deposit;
  int32_t* cellx;
  int32_t* celly;
  uint8_t* dead;
  const int64_t* pid;
  int64_t* counter;
  float* tally;                 // (ny * nx,) flat, row-major, window-local
  unsigned long long* counts;   // [facets, collisions, lanes still working]
  const float* scatter_keys;    // table mode: (scatter_entries,) ascending
  const float* scatter_values;
  const float* absorb_keys;     // table mode: (absorb_entries,)
  const float* absorb_values;
  const int32_t* region_bounds; // region mode: (nregions, 4) ix0 ix1 iy0 iy1
  const float* region_density;  // region mode: (nregions,)
  const float* density;         // grid mode: (ny * nx,) window-local
  unsigned long long master_key;
  long long n;
  int max_events;
  int nx;                       // the window's extent (the whole mesh
  int ny;                       // when unwindowed)
  int scatter_entries;
  int absorb_entries;
  int same_xs;
  int nregions;
  int xs_mode;                  // nt::XsMode
  int density_mode;             // nt::DensityMode
  int rng;                      // nt::RngScheme
  int x_off;                    // the window's first global cell
  int y_off;
  int global_nx;                // the whole mesh
  int global_ny;
  float dx;
  float dy;
  float inv_ntotal;
};

namespace {

using namespace nt;

constexpr int kThreads = 128;

template <XsMode X, DensityMode D, RngScheme R>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const SweepParams p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned int n_facets = 0, n_colls = 0, n_working = 0;

  if (i < p.n && !p.dead[i] && p.dt_to_census[i] > 0.0f &&
      in_window(p.cellx[i], p.celly[i], p.x_off, p.y_off, p.nx, p.ny)) {
    float x = p.x[i], y = p.y[i];
    float omega_x = p.omega_x[i], omega_y = p.omega_y[i];
    float energy = p.energy[i], weight = p.weight[i];
    float dt = p.dt_to_census[i], mfp = p.mfp_to_collision[i];
    float deposit = p.deposit[i];
    int cellx = p.cellx[i], celly = p.celly[i];
    const uint64_t pid = static_cast<uint64_t>(p.pid[i]);
    uint64_t counter = static_cast<uint64_t>(p.counter[i]);
    bool dead = false;
    bool inwin = true;
    const XsTable scatter{p.scatter_keys, p.scatter_values,
                          p.scatter_entries};
    const XsTable absorb{p.absorb_keys, p.absorb_values, p.absorb_entries};

    // The density is a function of the cell alone, so it is looked up
    // again only when the lane has entered another cell (in a dense deck
    // nearly every event is a collision in the same cell).
    int density_cell = -1;
    float density = 0.0f;

    for (int ev = 0; ev < p.max_events && !dead && dt > 0.0f && inwin;
         ++ev) {
      // ---- local material state: the grid's cell, or the regions (later
      // regions override earlier ones) ----
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
      const float sig_s = xs_value<X>(energy, scatter);
      const float sig_a = p.same_xs ? sig_s : xs_value<X>(energy, absorb);
      const float sig_t = sig_s + sig_a;
      const float number_density = density * kInvMolar;
      const float mac_s = number_density * sig_s * kBarns;
      const float mac_a = number_density * sig_a * kBarns;
      const float mac_t = mac_s + mac_a;
      const float cell_mfp = 1.0f / mac_t;
      const float speed = sqrtf(kSpeedCoef * energy);

      // ---- three candidate distances, in the cell-local frame (edges 0
      // and dx; the open left/bottom facet overshoots by kObc) ----
      const float u_x_inv = 1.0f / (omega_x * speed);
      const float u_y_inv = 1.0f / (omega_y * speed);
      const float dt_x = omega_x >= 0.0f ? (p.dx - x) * u_x_inv
                                         : (-kObc - x) * u_x_inv;
      const float dt_y = omega_y >= 0.0f ? (p.dy - y) * u_y_inv
                                         : (-kObc - y) * u_y_inv;
      const bool x_facet = dt_x < dt_y;
      const float d_facet = (x_facet ? dt_x : dt_y) * speed;
      const float d_coll = mfp * cell_mfp;
      const float d_census = speed * dt;

      const bool is_coll = (d_coll < d_facet) && (d_coll < d_census);
      const bool is_facet = !is_coll && (d_facet < d_census);
      const bool is_census = !is_coll && !is_facet;
      const float dist = is_coll ? d_coll : (is_facet ? d_facet : d_census);

      // ---- segment energy deposition (pre-event state) ----
      const float heating =
          energy - (1.0f - sig_a / sig_t) * (energy * kAvgScatterFrac);
      const float ed =
          weight * dist * (sig_t * kBarns) * heating * number_density;
      deposit = deposit + ed;

      // ---- move to the event site ----
      x = x + dist * omega_x;
      y = y + dist * omega_y;

      // ---- collision: counter c for the event, c+1 for a survivor's new
      // mean free path ----
      bool died = false;
      if (is_coll) {
        died = collide<X, R>(pid, p.master_key, counter, energy, weight,
                             omega_x, omega_y, mfp, mac_a, mac_t,
                             number_density, scatter);
        dt = dt - d_coll / speed;
      }
      if (is_facet) {
        mfp = mfp - d_facet / cell_mfp;
        dt = dt - d_facet / speed;
      }
      if (is_census) {
        mfp = mfp - d_census / cell_mfp;
        dt = 0.0f;
      }

      // ---- tally flush: leaving a cell, dying, or reaching census ----
      if (is_facet || is_census || died) {
        const float contrib = deposit * p.inv_ntotal;
        deposit = 0.0f;
        if (contrib != 0.0f) atomicAdd(&p.tally[flat_cell], contrib);
      }

      // ---- facet: step into the next cell (re-basing the local
      // position) or reflect at the domain boundary; a lane that steps
      // out of the window stops here ----
      if (is_facet) {
        if (x_facet) {
          if (omega_x > 0.0f) {
            if (cellx >= p.global_nx - 1) {
              omega_x = -omega_x;
            } else {
              cellx += 1;
              x = x - p.dx;
            }
          } else if (omega_x < 0.0f) {
            if (cellx <= 0) {
              omega_x = -omega_x;
            } else {
              cellx -= 1;
              x = x + p.dx;
            }
          }
        } else {
          if (omega_y > 0.0f) {
            if (celly >= p.global_ny - 1) {
              omega_y = -omega_y;
            } else {
              celly += 1;
              y = y - p.dy;
            }
          } else if (omega_y < 0.0f) {
            if (celly <= 0) {
              omega_y = -omega_y;
            } else {
              celly -= 1;
              y = y + p.dy;
            }
          }
        }
        inwin = in_window(cellx, celly, p.x_off, p.y_off, p.nx, p.ny);
      }

      dead = died;
      n_facets += is_facet;
      n_colls += is_coll;
    }

    n_working = !dead && dt > 0.0f && inwin;
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

  // Event and working-lane counts: reduce per warp, one atomic per warp.
  n_facets = __reduce_add_sync(0xffffffffu, n_facets);
  n_colls = __reduce_add_sync(0xffffffffu, n_colls);
  n_working = __reduce_add_sync(0xffffffffu, n_working);
  if ((threadIdx.x & 31u) == 0) {
    if (n_facets) atomicAdd(&p.counts[0], static_cast<unsigned long long>(n_facets));
    if (n_colls) atomicAdd(&p.counts[1], static_cast<unsigned long long>(n_colls));
    if (n_working) atomicAdd(&p.counts[2], static_cast<unsigned long long>(n_working));
  }
}

}  // namespace

// Plain C interface, loaded with ctypes by sweep_kernel.py.

extern "C" int nt_params_size() { return static_cast<int>(sizeof(SweepParams)); }

// Launches one sweep over all p->n lanes on `stream`, with the
// instantiation of p's modes, and returns cudaGetLastError() (0 when the
// launch was accepted; cudaErrorInvalidValue for an unknown mode).
extern "C" int nt_sweep_launch(const SweepParams* p, void* stream) {
  if (p->n <= 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((p->n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = (p->xs_mode << 2) | (p->density_mode << 1) | p->rng;
  using X = XsMode;
  using D = DensityMode;
  using R = RngScheme;
  switch (mode) {
#define NT_SWEEP_CASE(x, d, r)                                            \
  case ((static_cast<int>(x) << 2) | (static_cast<int>(d) << 1) |       \
        static_cast<int>(r)):                                             \
    sweep_kernel<x, d, r><<<blocks, kThreads, 0, s>>>(*p);                \
    break;
    NT_SWEEP_CASE(X::kAnalytic, D::kRegions, R::kThreefry)
    NT_SWEEP_CASE(X::kAnalytic, D::kRegions, R::kPcg64si)
    NT_SWEEP_CASE(X::kAnalytic, D::kGrid, R::kThreefry)
    NT_SWEEP_CASE(X::kAnalytic, D::kGrid, R::kPcg64si)
    NT_SWEEP_CASE(X::kTable, D::kRegions, R::kThreefry)
    NT_SWEEP_CASE(X::kTable, D::kRegions, R::kPcg64si)
    NT_SWEEP_CASE(X::kTable, D::kGrid, R::kThreefry)
    NT_SWEEP_CASE(X::kTable, D::kGrid, R::kPcg64si)
#undef NT_SWEEP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
