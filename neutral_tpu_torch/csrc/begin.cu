// The start of a census for NVIDIA Hopper (sm_90a): transport.begin_timestep
// in one pass over the lanes.
//
// Replaces neutral_tpu/transport.py::begin_timestep (:221), which is not a
// Pallas kernel but a jax.jit function: XLA fuses its region tests, its
// cross-section lookup, its draw and its selects into one program a census.
// The plain PyTorch version (neutral_tpu_torch/transport.py begin_timestep)
// runs the same work as a chain of eager operations, each one a launch and
// a full pass over the lanes, a few hundred a census under threefry on
// int64 words.  Here one thread takes one lane at a time (a grid-stride
// loop over a grid that fills the card once, so that table mode stages its
// coarse index once a block):
//
//   * a dead lane keeps its mean free path, takes dt_to_census 0 and
//     counter 1, and skips the lookup and the draw, whose results the plain
//     version throws away;
//   * a live lane finds its density (the region rectangles over its global
//     cell, the last that holds it winning; or the grid at its window-local
//     cell, the flat index clamped into the grid as transport._flat_cell
//     clamps it), looks its scatter cross-section up (common.cuh xs_value:
//     the analytic grid, or the stored table's two-level search), draws
//     the pair at counter 0 of its (pid, master_key) key (uniform2),
//     and takes mfp = -log(r0) / mac_s with mac_s = ((density * kInvMolar)
//     * sig_s) * kBarns, the plain version's order, libdevice's logarithm
//     and IEEE division (-fmad=false, build.py), dt_to_census = dt (in the
//     working type, as the host passed it) and counter 1;
//   * the live lanes are counted, one warp sum and one atomic a warp.
//
// The three fields that change go to fresh arrays (out_*); the other eleven
// are the caller's, unchanged, as the plain version shares them.  The modes
// are the sweep kernel's template parameters (cross-sections, density,
// draws), and so is the working type (float32, or float64 for float64
// decks: 16 instantiations); the window is a runtime parameter.  It reads
// no facet edge, so a geometry without a uniform pitch (a non-uniform mesh,
// a fast_math 0 deck) runs on the same instantiations.
//
// What bounds it: bytes.  A live lane reads 21 bytes (dead, cells, energy,
// pid) and writes 16 (dt_to_census, mean free path, counter): 37 bytes,
// 0.11 ms at 10M lanes over 3.35 TB/s; in float64 the energy and both
// written floats take 4 bytes more each (49).  A dead lane reads its old
// mean free path (4, or 8) and not its cells, energy or pid.  One
// threefry-2x64/20 draw a live lane is about 160 integer operations, 0.10
// ms at 10M over the card's int32 issue rate; the lookup reads the
// analytic grid (240 KB, 480 KB in float64, in L1 and L2) or the table's
// coarse index from shared memory.  Each
// thread keeps to coalesced loads and stores of its own lane; nothing is
// staged but the coarse index.
//
// The wrapper (begin_kernel.py) rejects every other configuration.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

// Layout shared with begin_kernel._BeginParams (ctypes; Real = float) and
// _BeginParams64 (Real = double); nt_begin_params_size() and
// nt_begin_params_size_f64() let the wrapper check that they agree.
template <typename Real>
struct BeginParamsT {
  // the caller's state (sweep_kernel.state_pointers), read only
  const Real* x;
  const Real* y;
  const Real* omega_x;
  const Real* omega_y;
  const Real* energy;
  const Real* weight;
  const Real* dt_to_census;
  const Real* mfp_to_collision;
  const Real* deposit;
  const int32_t* cellx;
  const int32_t* celly;
  const uint8_t* dead;
  const int64_t* pid;
  const int64_t* counter;
  // the three fields that change, each a fresh (n,) array
  Real* out_dt_to_census;
  Real* out_mfp_to_collision;
  int64_t* out_counter;
  unsigned long long* live;     // (1,), zero before the launch
  const Real* scatter_keys;     // table mode (sweep_kernel.table_fields)
  const nt::Interval<Real>* scatter_intervals;
  const Real* scatter_coarse;
  const Real* absorb_keys;      // set by table_fields; not read here
  const nt::Interval<Real>* absorb_intervals;
  const Real* absorb_coarse;
  const nt::Pair<Real>* scatter_grid;   // analytic mode
  const nt::Pair<Real>* absorb_grid;    // not read here
  const int32_t* region_bounds; // region mode: (nregions, 4) ix0 ix1 iy0 iy1
  const Real* region_density;   // region mode: (nregions,)
  const Real* density;          // grid mode: (ny * nx,) window-local
  unsigned long long master_key;
  long long n;
  int blocks;
  int nx;                       // the window's extent (the whole mesh
  int ny;                       // when unwindowed)
  int scatter_entries;
  int absorb_entries;
  int scatter_shift;
  int absorb_shift;
  int same_xs;
  int nregions;
  int xs_mode;                  // nt::XsMode
  int density_mode;             // nt::DensityMode
  int rng;                      // nt::RngScheme
  int x_off;                    // the window's first global cell
  int y_off;
  int global_nx;
  int global_ny;
  Real dt;                      // the census clock in the working type
};

using BeginParams = BeginParamsT<float>;
using BeginParams64 = BeginParamsT<double>;

namespace {

using namespace nt;

constexpr int kThreads = 256;

// Dynamic shared memory of a launch: the scatter table's coarse index in
// table mode (in the working type), none in analytic mode.
template <typename Real>
size_t begin_smem_bytes(const BeginParamsT<Real>& p) {
  if (p.xs_mode != static_cast<int>(XsMode::kTable)) return 0;
  return sizeof(Real) *
         static_cast<size_t>(coarse_count(p.scatter_entries, p.scatter_shift));
}

template <XsMode X, DensityMode D, RngScheme R, typename Real>
__global__ void __launch_bounds__(kThreads)
begin_kernel(const BeginParamsT<Real> p) {
  using C = Const<Real>;
  Real* coarse_smem = dynamic_smem<Real>();
  if constexpr (X == XsMode::kTable) {
    stage_coarse(p.scatter_coarse, p.scatter_entries, p.scatter_shift,
                 coarse_smem);
    __syncthreads();
  }
  const XsTableT<Real> scatter = scatter_table(p, coarse_smem);

  unsigned int nlive = 0;       // a thread's lanes are far below 2^32
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < p.n; i += stride) {
    Real dt = 0;
    Real mfp;
    if (p.dead[i]) {
      mfp = p.mfp_to_collision[i];
    } else {
      const int cellx = p.cellx[i];
      const int celly = p.celly[i];
      Real density;
      if constexpr (D == DensityMode::kGrid) {
        const int flat_cell = min(
            max((celly - p.y_off) * p.nx + (cellx - p.x_off), 0),
            p.nx * p.ny - 1);
        density = __ldg(p.density + flat_cell);
      } else {
        const int4* bounds = reinterpret_cast<const int4*>(p.region_bounds);
        density = 0;
        for (int r = 0; r < p.nregions; ++r) {
          const int4 b = __ldg(bounds + r);
          if (cellx >= b.x && cellx < b.y && celly >= b.z && celly < b.w) {
            density = __ldg(p.region_density + r);
          }
        }
      }
      int hint = kNoHint;
      const Real sig_s = xs_value<X>(p.energy[i], scatter, hint);
      const Real mac_s = density * C::kInvMolar * sig_s * C::kBarns;
      Real r0, r1;
      uniform2<R>(draw_key<R>(static_cast<uint64_t>(p.pid[i]),
                              p.master_key),
                  0, r0, r1);
      mfp = -nt_log(r0) / mac_s;
      dt = p.dt;
      nlive += 1;
    }
    p.out_dt_to_census[i] = dt;
    p.out_mfp_to_collision[i] = mfp;
    p.out_counter[i] = 1;
  }

  const unsigned long long warp_live = warp_sum_u64(nlive);
  if ((threadIdx.x & 31u) == 0 && warp_live) atomicAdd(p.live, warp_live);
}

}  // namespace

// Plain C interface, loaded with ctypes by begin_kernel.py.

extern "C" int nt_begin_params_size() {
  return static_cast<int>(sizeof(BeginParams));
}

extern "C" int nt_begin_params_size_f64() {
  return static_cast<int>(sizeof(BeginParams64));
}

extern "C" int nt_begin_threads() { return kThreads; }

#define NT_BEGIN_MODES(CASE)                                              \
  CASE(XsMode::kAnalytic, DensityMode::kRegions, RngScheme::kThreefry)    \
  CASE(XsMode::kAnalytic, DensityMode::kRegions, RngScheme::kPcg64si)     \
  CASE(XsMode::kAnalytic, DensityMode::kGrid, RngScheme::kThreefry)       \
  CASE(XsMode::kAnalytic, DensityMode::kGrid, RngScheme::kPcg64si)        \
  CASE(XsMode::kTable, DensityMode::kRegions, RngScheme::kThreefry)       \
  CASE(XsMode::kTable, DensityMode::kRegions, RngScheme::kPcg64si)        \
  CASE(XsMode::kTable, DensityMode::kGrid, RngScheme::kThreefry)          \
  CASE(XsMode::kTable, DensityMode::kGrid, RngScheme::kPcg64si)

#define NT_BEGIN_MODE(x, d, r)                                            \
  ((static_cast<int>(x) << 2) | (static_cast<int>(d) << 1) |              \
   static_cast<int>(r))

namespace {

// Blocks of the instantiation that a launch with parameters *p runs (in
// p's working type) that one SM holds at once beside the launch's dynamic
// shared memory, into *blocks; returns the CUDA error code
// (cudaErrorInvalidValue for an unknown mode).
template <typename Real>
int begin_blocks_per_sm(const BeginParamsT<Real>* p, int* blocks) {
  const size_t smem = begin_smem_bytes(*p);
  switch ((p->xs_mode << 2) | (p->density_mode << 1) | p->rng) {
#define NT_BEGIN_CASE(x, d, r)                                            \
  case NT_BEGIN_MODE(x, d, r):                                            \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor( \
        blocks, begin_kernel<x, d, r, Real>, kThreads, smem));
    NT_BEGIN_MODES(NT_BEGIN_CASE)
#undef NT_BEGIN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches the census start of p->n lanes over p->blocks blocks on
// `stream` (at least one block: a launch over no lane still runs, and
// leaves the live count at 0), with the instantiation of p's modes and
// working type, and returns cudaGetLastError() (0 when the launch was
// accepted; cudaErrorInvalidValue for an unknown mode or an empty grid).
template <typename Real>
int begin_launch(const BeginParamsT<Real>* p, void* stream) {
  if (p->blocks <= 0 || p->n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = begin_smem_bytes(*p);
  switch ((p->xs_mode << 2) | (p->density_mode << 1) | p->rng) {
#define NT_BEGIN_CASE(x, d, r)                                            \
  case NT_BEGIN_MODE(x, d, r):                                            \
    begin_kernel<x, d, r, Real><<<p->blocks, kThreads, smem, s>>>(*p);    \
    break;
    NT_BEGIN_MODES(NT_BEGIN_CASE)
#undef NT_BEGIN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nt_begin_blocks_per_sm(const BeginParams* p, int* blocks) {
  return begin_blocks_per_sm(p, blocks);
}

extern "C" int nt_begin_blocks_per_sm_f64(const BeginParams64* p,
                                          int* blocks) {
  return begin_blocks_per_sm(p, blocks);
}

extern "C" int nt_begin_launch(const BeginParams* p, void* stream) {
  return begin_launch(p, stream);
}

extern "C" int nt_begin_launch_f64(const BeginParams64* p, void* stream) {
  return begin_launch(p, stream);
}
