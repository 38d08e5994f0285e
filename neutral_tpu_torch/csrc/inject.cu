// Source injection for NVIDIA Hopper (sm_90a): particles.inject_particles
// in one pass over the lanes.
//
// Replaces neutral_tpu/particles.py::inject_particles, which is not a
// Pallas kernel but a jax.jit function: XLA fuses its two draws, its edge
// searches, its angle and its fills into one program.  The plain PyTorch
// version (neutral_tpu_torch/particles.py inject_particles) runs the same
// work as a chain of eager operations: each threefry draw on int64 words
// of 32-bit halves is several hundred launches, each a full pass over the
// lanes.  Here one thread takes one lane at a time (a grid-stride loop,
// 64-bit lane indices) and writes its 14 fields once:
//
//   * pid = the lane's entry of the pid vector, or the lane index when
//     there is none (a decomposition's shard holds the pids born in its
//     block; a single device's state every pid in order), counter 0,
//     dead false;
//   * the position from the pair draw at counter 0 of the key (pid, 0)
//     (common.cuh uniform2, threefry or pcg64si, mapped to the working
//     type as every kernel maps it): x = x0 + r0a * width and y = y0 + r0b
//     * height, each a product and then a sum (-fmad=false, build.py);
//   * the cell as particles._find_cell finds it: on a uniform mesh the
//     floor of pos * (cells / extent) converted as xs.to_int converts
//     (floor_int), clamped, then moved once by the stored edges around it
//     and clamped again; on any other mesh an upper-bound binary search
//     over the edges (torch.searchsorted(right=True)'s !(edge > pos)) less
//     one, clamped;
//   * in the cell-local frame (the sweep transport in float32 with a
//     pitch) x - cellx * dx clamped into [0, dx], and the same for y;
//   * the angle from the pair draw at counter 1: theta = 2 pi * r1a,
//     omega = (cos theta, sin theta), libdevice's cosine and sine, which
//     torch.cos and torch.sin call;
//   * energy E0, weight 1, dt_to_census dt, mean free path and deposit 0.
//
// Every constant arrives from the host already rounded to the working type
// (xs.const), so each lane's fields are the plain version's bits.  The
// working type and the draw scheme are template parameters (4
// instantiations); the mesh's search and the frame are runtime flags.
//
// What bounds it: bytes and draws.  A lane writes 61 bytes in float32
// (nine floats, two int32 cells, a bool, two int64) and 97 in float64, and
// reads nothing but the edges around its cell (L1 and L2): 0.18 ms at 10M
// lanes over 3.35 TB/s.  Two threefry-2x64/20 draws a lane are about 300
// integer operations, 0.18 ms at 10M over the card's int32 issue rate.
//
// The wrapper (inject_kernel.py) rejects every other configuration.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

// Layout shared with inject_kernel._InjectParams (ctypes; Real = float) and
// _InjectParams64 (Real = double); nt_inject_params_size() and
// nt_inject_params_size_f64() let the wrapper check that they agree.
template <typename Real>
struct InjectParamsT {
  // the 14 fields of the new state, each a fresh (n,) array
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
  int64_t* pid;
  int64_t* counter;
  const Real* edgex;            // the mesh's (nx + 1,) and (ny + 1,) edges
  const Real* edgey;
  const int64_t* pid_in;        // the lanes' pids; null: the lane index
  long long n;
  int blocks;
  int nx;
  int ny;
  int uniform;                  // 1: floor and correct; 0: edge search
  int local;                    // 1: cell-local frame
  int rng;                      // nt::RngScheme
  Real x0;                      // the source box
  Real y0;
  Real width;
  Real height;
  Real inv_x;                   // nx / the mesh's width (uniform search)
  Real inv_y;
  Real dx;                      // the cell-local frame's pitch
  Real dy;
  Real two_pi;
  Real energy0;
  Real dt;
};

using InjectParams = InjectParamsT<float>;
using InjectParams64 = InjectParamsT<double>;

namespace {

using namespace nt;

constexpr int kThreads = 256;

__device__ __forceinline__ float nt_cos(float v) { return cosf(v); }
__device__ __forceinline__ double nt_cos(double v) { return cos(v); }
__device__ __forceinline__ float nt_sin(float v) { return sinf(v); }
__device__ __forceinline__ double nt_sin(double v) { return sin(v); }

// particles._find_cell: the index i with edges[i] <= pos < edges[i + 1],
// clamped to [0, ncells - 1].
template <typename Real>
__device__ __forceinline__ int find_cell(const Real* edges, Real pos,
                                         int ncells, Real inv, bool uniform) {
  if (!uniform) {
    int lo = 0, hi = ncells + 1;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(__ldg(edges + mid) > pos)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    return min(max(lo - 1, 0), ncells - 1);
  }
  int cand = min(max(floor_int(pos * inv), 0), ncells - 1);
  const Real lo = __ldg(edges + cand);
  const Real hi = __ldg(edges + cand + 1);
  cand = cand + (pos >= hi ? 1 : 0) - (pos < lo ? 1 : 0);
  return min(max(cand, 0), ncells - 1);
}

// torch.clamp(v, 0, hi) of a value that is not NaN.
template <typename Real>
__device__ __forceinline__ Real clamp_pitch(Real v, Real hi) {
  return nt_fmin(nt_fmax(v, Real(0)), hi);
}

template <RngScheme R, typename Real>
__global__ void __launch_bounds__(kThreads)
inject_kernel(const InjectParamsT<Real> p) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < p.n; i += stride) {
    const long long pid = p.pid_in != nullptr ? __ldg(p.pid_in + i) : i;
    const DrawKey key = draw_key<R>(static_cast<uint64_t>(pid), 0);
    Real r0a, r0b, r1a, r1b;
    uniform2<R>(key, 0, r0a, r0b);
    uniform2<R>(key, 1, r1a, r1b);
    Real x = p.x0 + r0a * p.width;
    Real y = p.y0 + r0b * p.height;
    const int cellx = find_cell(p.edgex, x, p.nx, p.inv_x, p.uniform);
    const int celly = find_cell(p.edgey, y, p.ny, p.inv_y, p.uniform);
    if (p.local) {
      x = clamp_pitch(x - static_cast<Real>(cellx) * p.dx, p.dx);
      y = clamp_pitch(y - static_cast<Real>(celly) * p.dy, p.dy);
    }
    const Real theta = p.two_pi * r1a;
    p.x[i] = x;
    p.y[i] = y;
    p.omega_x[i] = nt_cos(theta);
    p.omega_y[i] = nt_sin(theta);
    p.energy[i] = p.energy0;
    p.weight[i] = 1;
    p.dt_to_census[i] = p.dt;
    p.mfp_to_collision[i] = 0;
    p.deposit[i] = 0;
    p.cellx[i] = cellx;
    p.celly[i] = celly;
    p.dead[i] = 0;
    p.pid[i] = pid;
    p.counter[i] = 0;
  }
}

// Launches the injection of p->n lanes over p->blocks blocks on `stream`
// (at least one block), with the instantiation of p's draw scheme and
// working type, and returns cudaGetLastError() (0 when the launch was
// accepted; cudaErrorInvalidValue for an unknown scheme or an empty grid).
template <typename Real>
int inject_launch(const InjectParamsT<Real>* p, void* stream) {
  if (p->blocks <= 0 || p->n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->rng) {
    case static_cast<int>(RngScheme::kThreefry):
      inject_kernel<RngScheme::kThreefry, Real>
          <<<p->blocks, kThreads, 0, s>>>(*p);
      break;
    case static_cast<int>(RngScheme::kPcg64si):
      inject_kernel<RngScheme::kPcg64si, Real>
          <<<p->blocks, kThreads, 0, s>>>(*p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes by inject_kernel.py.

extern "C" int nt_inject_params_size() {
  return static_cast<int>(sizeof(InjectParams));
}

extern "C" int nt_inject_params_size_f64() {
  return static_cast<int>(sizeof(InjectParams64));
}

extern "C" int nt_inject_threads() { return kThreads; }

extern "C" int nt_inject_launch(const InjectParams* p, void* stream) {
  return inject_launch(p, stream);
}

extern "C" int nt_inject_launch_f64(const InjectParams64* p, void* stream) {
  return inject_launch(p, stream);
}
