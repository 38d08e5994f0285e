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
// Only the float32, analytic cross-section, region density, uniform mesh,
// threefry configuration is implemented (the scatter deck); the wrapper
// (sweep_kernel.py) rejects everything else.
//
// What bounds it on the H100: integer throughput of Threefry-2x64-20 (about
// 20 rounds of 64-bit add, rotate and xor per draw, two draws per
// collision), and warp divergence in the census tail, where a warp runs as
// long as its longest history.  This first version does nothing about
// either yet.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMaxRegions = 16;

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
  float* tally;                 // (ny * nx,) flat, row-major
  unsigned long long* counts;   // [facets, collisions, lanes still working]
  unsigned long long master_key;
  long long n;
  int max_events;
  int nx;
  int ny;
  int scatter_entries;
  int absorb_entries;
  int same_xs;
  float dx;
  float dy;
  float inv_ntotal;
  int nregions;
  int region_bounds[kMaxRegions * 4];   // (ix0, ix1, iy0, iy1) per region
  float region_density[kMaxRegions];
};

namespace {

constexpr int kThreads = 128;

// Constants as the plain version rounds them: the float64 value, then one
// rounding to float32 (neutral_tpu's np.float32(v)).
constexpr double kAvogadros = 6.02214085774e23;
constexpr double kMolarMass = 1.0e-2;
constexpr double kEvToJ = 1.60217646e-19;
constexpr double kParticleMass = 1.674927471213e-27;
constexpr double kMassNo = 1.0e2;

constexpr float kInvMolar = static_cast<float>(kAvogadros / kMolarMass);
constexpr float kBarns = static_cast<float>(1.0e-28);
constexpr float kAvgScatterFrac = static_cast<float>(
    (kMassNo * kMassNo + kMassNo + 1.0) / ((kMassNo + 1.0) * (kMassNo + 1.0)));
constexpr float kSpeedCoef = static_cast<float>(2.0 * kEvToJ / kParticleMass);
constexpr float kMinEnergy = static_cast<float>(1.0);
constexpr float kObc = static_cast<float>(1.0e-13);
constexpr float kA = static_cast<float>(kMassNo);
constexpr float kE8 = static_cast<float>(1.0e8);
constexpr float kEm2 = static_cast<float>(1.0e-2);
constexpr float kEm8 = static_cast<float>(1.0e-8);
constexpr float kE3 = static_cast<float>(1.0e3);
constexpr float kTwoM32 = 0x1p-32f;
constexpr float kTwoM33 = 0x1p-33f;

__device__ __forceinline__ uint64_t rotl64(uint64_t v, int r) {
  return (v << r) | (v >> (64 - r));
}

// Threefry-2x64, 20 rounds (Salmon et al., SC'11), with the key schedule of
// Random123's threefry2x64 as the reference uses it.
__device__ __forceinline__ void threefry2x64(uint64_t c0, uint64_t c1,
                                             uint64_t k0, uint64_t k1,
                                             uint64_t& o0, uint64_t& o1) {
  const uint64_t ks[3] = {k0, k1, 0x1BD11BDAA9FC1A22ULL ^ k0 ^ k1};
  constexpr int kRot[8] = {16, 42, 12, 31, 16, 32, 24, 21};
  uint64_t x0 = c0 + k0;
  uint64_t x1 = c1 + k1;
#pragma unroll
  for (int r = 0; r < 20; ++r) {
    x0 += x1;
    x1 = rotl64(x1, kRot[r % 8]);
    x1 ^= x0;
    if ((r + 1) % 4 == 0) {
      const int j = (r + 1) / 4;
      x0 += ks[j % 3];
      x1 += ks[(j + 1) % 3] + static_cast<uint64_t>(j);
    }
  }
  o0 = x0;
  o1 = x1;
}

// Pair draw (ctr = (counter, 0), key = (pid, master_key)) mapped to float32
// from the high words: u = hi * 2^-32 + 2^-33, strictly inside (0, 1).
__device__ __forceinline__ void uniform2_f32(uint64_t pid, uint64_t master_key,
                                             uint64_t counter, float& u0,
                                             float& u1) {
  uint64_t v0, v1;
  threefry2x64(counter, 0, pid, master_key, v0, v1);
  u0 = __uint2float_rn(static_cast<uint32_t>(v0 >> 32)) * kTwoM32 + kTwoM33;
  u1 = __uint2float_rn(static_cast<uint32_t>(v1 >> 32)) * kTwoM32 + kTwoM33;
}

// Analytic resonance table (xs.CrossSection analytic mode): keys and
// values of the generated grid in closed form.
__device__ __forceinline__ float key_at(int i, float m) {
  const float t = (static_cast<float>(i) + 1.0f) / m;
  const float t2 = t * t;
  return kE8 * (t2 * t2) + kEm2;
}

__device__ __forceinline__ float val_at(int i, float m) {
  return kE3 * ((m - static_cast<float>(i)) / m) + 1.0f;
}

__device__ __forceinline__ float xs_lookup(float e, int n) {
  const float m = static_cast<float>(n);
  const float u = sqrtf(sqrtf((e - kEm2) * kEm8));
  int idx = static_cast<int>(floorf(u * m)) - 1;
  idx = min(max(idx, 0), n - 2);
  if (e < key_at(idx, m)) idx -= 1;
  if (e >= key_at(min(max(idx + 1, 0), n - 1), m)) idx += 1;
  idx = min(max(idx, 0), n - 2);
  const float k0 = key_at(idx, m);
  const float k1 = key_at(idx + 1, m);
  const float v0 = val_at(idx, m);
  const float v1 = val_at(idx + 1, m);
  return v0 + ((e - k0) / (k1 - k0)) * (v1 - v0);
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const SweepParams p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned int n_facets = 0, n_colls = 0, n_working = 0;

  if (i < p.n && !p.dead[i] && p.dt_to_census[i] > 0.0f) {
    float x = p.x[i], y = p.y[i];
    float omega_x = p.omega_x[i], omega_y = p.omega_y[i];
    float energy = p.energy[i], weight = p.weight[i];
    float dt = p.dt_to_census[i], mfp = p.mfp_to_collision[i];
    float deposit = p.deposit[i];
    int cellx = p.cellx[i], celly = p.celly[i];
    const uint64_t pid = static_cast<uint64_t>(p.pid[i]);
    uint64_t counter = static_cast<uint64_t>(p.counter[i]);
    bool dead = false;

    for (int ev = 0; ev < p.max_events && !dead && dt > 0.0f; ++ev) {
      // ---- local material state (later regions override earlier) ----
      const int flat_cell =
          min(max(celly * p.nx + cellx, 0), p.nx * p.ny - 1);
      float density = 0.0f;
#pragma unroll
      for (int r = 0; r < kMaxRegions; ++r) {
        if (r >= p.nregions) break;
        if (cellx >= p.region_bounds[4 * r] &&
            cellx < p.region_bounds[4 * r + 1] &&
            celly >= p.region_bounds[4 * r + 2] &&
            celly < p.region_bounds[4 * r + 3]) {
          density = p.region_density[r];
        }
      }
      const float sig_s = xs_lookup(energy, p.scatter_entries);
      const float sig_a =
          p.same_xs ? sig_s : xs_lookup(energy, p.absorb_entries);
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
        const float p_absorb = mac_a / mac_t;
        float rn1a, rn1b;
        uniform2_f32(pid, p.master_key, counter, rn1a, rn1b);
        if (rn1a < p_absorb) {
          weight = weight * (1.0f - p_absorb);
          died = energy < kMinEnergy;
        } else {
          const float mu_cm = 1.0f - 2.0f * rn1b;
          const float e_new =
              energy * ((kA * kA + (2.0f * kA) * mu_cm) + 1.0f) /
              ((kA + 1.0f) * (kA + 1.0f));
          const float cos_t = 0.5f * ((kA + 1.0f) * sqrtf(e_new / energy) -
                                      (kA - 1.0f) * sqrtf(energy / e_new));
          const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
          const float ox = omega_x * cos_t - omega_y * sin_t;
          const float oy = omega_x * sin_t + omega_y * cos_t;
          omega_x = ox;
          omega_y = oy;
          energy = e_new;
        }
        counter += 1;
        if (!died) {
          const float mac_s2 =
              number_density * xs_lookup(energy, p.scatter_entries) * kBarns;
          float rn2a, rn2b;
          uniform2_f32(pid, p.master_key, counter, rn2a, rn2b);
          counter += 1;
          mfp = -logf(rn2a) / mac_s2;
        }
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
      // position) or reflect at the domain boundary ----
      if (is_facet) {
        if (x_facet) {
          if (omega_x > 0.0f) {
            if (cellx >= p.nx - 1) {
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
            if (celly >= p.ny - 1) {
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
      }

      dead = died;
      n_facets += is_facet;
      n_colls += is_coll;
    }

    n_working = !dead && dt > 0.0f;
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

extern "C" int nt_max_regions() { return kMaxRegions; }

// Launches one sweep over all p->n lanes on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int nt_sweep_launch(const SweepParams* p, void* stream) {
  if (p->n <= 0) return 0;
  const long long blocks = (p->n + kThreads - 1) / kThreads;
  sweep_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
