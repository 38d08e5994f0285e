// Device code shared by the sweep kernel (sweep.cu) and the flight kernel
// (flight.cu): constants, Threefry-2x64 and PCG64si draws, the analytic and
// table cross-section lookups and the collision event.  Every function here
// follows the plain PyTorch version (neutral_tpu_torch/transport.py, xs.py,
// rng.py) operation by operation, with the same float32 constants; the
// build passes -fmad=false so that no a*b+c is fused (see build.py).
//
// The deck's modes are template parameters, so that each combination is
// its own instantiation and the analytic/threefry one is the code without
// the others: XsMode (analytic resonance formula read from its grid, or a
// stored table searched through a coarse index in shared memory), RngScheme (threefry or pcg64si)
// and, in the sweep kernel, DensityMode (region rectangles, or a per-cell
// grid).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nt {

enum class XsMode : int { kAnalytic = 0, kTable = 1 };
enum class RngScheme : int { kThreefry = 0, kPcg64si = 1 };
enum class DensityMode : int { kRegions = 0, kGrid = 1 };

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

// Whether global cell (cx, cy) lies in the window [x_off, x_off + nx) x
// [y_off, y_off + ny) of a decomposed run's shard (always, unwindowed).
__device__ __forceinline__ bool in_window(int cx, int cy, int x_off,
                                          int y_off, int nx, int ny) {
  return cx >= x_off && cx < x_off + nx && cy >= y_off && cy < y_off + ny;
}

__device__ __forceinline__ uint64_t rotl64(uint64_t v, int r) {
  return (v << r) | (v >> (64 - r));
}

// A lane's draw key: the words of its draws that do not change with the
// counter, computed once when the lane is loaded.  threefry: the key words
// (pid, master_key) and their parity word 0x1BD11BDAA9FC1A22 ^ pid ^
// master_key (Random123's ks[2]); pcg64si: k0 = 1e15*master_key + 1e4*pid
// (mod 2^64), the part of the seed that is not 2*counter.
struct DrawKey {
  uint64_t k0, k1, k2;
};

// Threefry-2x64, 20 rounds (Salmon et al., SC'11), with the key schedule of
// Random123's threefry2x64 as the reference uses it, of the counter
// (c0, 0): its word 1 is 0, so the first x1 is the key word k1.
__device__ __forceinline__ void threefry2x64(uint64_t c0, const DrawKey& k,
                                             uint64_t& o0, uint64_t& o1) {
  const uint64_t ks[3] = {k.k0, k.k1, k.k2};
  constexpr int kRot[8] = {16, 42, 12, 31, 16, 32, 24, 21};
  uint64_t x0 = c0 + ks[0];
  uint64_t x1 = ks[1];
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

// PCG64si (pcg_oneseq_64_rxs_m_xs_64): first output of a generator freshly
// seeded with `seed`, state = (INC + seed) * MULT + INC (rng.pcg64si_first).
__device__ __forceinline__ uint64_t pcg64si_first(uint64_t seed) {
  constexpr uint64_t kMult = 6364136223846793005ULL;
  constexpr uint64_t kInc = 1442695040888963407ULL;
  constexpr uint64_t kOutMult = 12605985483714917081ULL;
  const uint64_t state = (kInc + seed) * kMult + kInc;
  const uint64_t word =
      ((state >> ((state >> 59u) + 5u)) ^ state) * kOutMult;
  return (word >> 43u) ^ word;
}

// u = hi * 2^-32 + 2^-33 from a word's high half, strictly inside (0, 1).
__device__ __forceinline__ float hi_to_f32(uint64_t v) {
  return __uint2float_rn(static_cast<uint32_t>(v >> 32)) * kTwoM32 + kTwoM33;
}

template <RngScheme R>
__device__ __forceinline__ DrawKey draw_key(uint64_t pid,
                                            uint64_t master_key) {
  if constexpr (R == RngScheme::kThreefry) {
    return {pid, master_key, 0x1BD11BDAA9FC1A22ULL ^ pid ^ master_key};
  } else {
    return {1000000000000000ULL * master_key + 10000ULL * pid, 0, 0};
  }
}

// Pair draw mapped to float32 from the high words (rng.uniform2_scheme).
// threefry: ctr = (counter, 0), key = (pid, master_key).  pcg64si: the
// generators seeded seed and seed + 1, seed = 1e15*master_key + 1e4*pid +
// 2*counter (mod 2^64).
template <RngScheme R>
__device__ __forceinline__ void uniform2_f32(const DrawKey& key,
                                             uint64_t counter, float& u0,
                                             float& u1) {
  uint64_t v0, v1;
  if constexpr (R == RngScheme::kThreefry) {
    threefry2x64(counter, key, v0, v1);
  } else {
    const uint64_t seed = key.k0 + 2ULL * counter;
    v0 = pcg64si_first(seed);
    v1 = pcg64si_first(seed + 1ULL);
  }
  u0 = hi_to_f32(v0);
  u1 = hi_to_f32(v1);
}

// Analytic resonance table (xs.CrossSection analytic mode).  Its keys and
// values depend only on the index i and the entry count n: key(i) =
// 1e8 * ((i + 1) / n)^4 + 1e-2, value(i) = 1e3 * ((n - i) / n) + 1, each
// with one IEEE division.  The wrapper builds them once per run, for every
// index, with the plain version's own arithmetic (CrossSection.analytic_grid
// on the card) into `grid`, (key, value) pairs; the lookup reads them
// instead of dividing.  The closed-form index lands at most one bin off,
// which the two nudges correct, so the keys and values it can read are
// those at i0 - 1 .. i0 + 2 of its first guess i0: all four are loaded at
// once (the grid, 240 KB for 29,999 entries, stays in L1 and L2), and the
// nudges and the interpolation pick from them, as the plain version's
// gathers do.
__device__ __forceinline__ float xs_lookup(float e, const float2* grid,
                                           int n) {
  const float m = static_cast<float>(n);
  const float u = sqrtf(sqrtf((e - kEm2) * kEm8));
  // Below 1e-2 eV u is NaN: cvt.rmi sends it to 0 (and saturates), as
  // XLA's conversion and xs.to_int do.
  const int i0 = min(max(__float2int_rd(u * m) - 1, 0), n - 2);
  const float2 gm = __ldg(grid + max(i0 - 1, 0));
  const float2 g0 = __ldg(grid + i0);
  const float2 g1 = __ldg(grid + i0 + 1);
  const float2 g2 = __ldg(grid + min(i0 + 2, n - 1));
  // idx -= e < key(i0); idx += e >= key(clip(idx + 1)); clip to [0, n-2]
  const bool down = e < g0.x;
  const int up = e >= (down ? g0.x : g1.x) ? 1 : 0;
  const int idx = min(max(i0 - (down ? 1 : 0) + up, 0), n - 2);
  const int d = idx - i0;       // -1, 0 or 1
  const float2 lo = d < 0 ? gm : (d == 0 ? g0 : g1);
  const float2 hi = d < 0 ? g0 : (d == 0 ? g1 : g2);
  return lo.y + ((e - lo.x) / (hi.x - lo.x)) * (hi.y - lo.y);
}

// Stored table (xs.CrossSection searchsorted mode, xs.TableLayout).  The
// lookup is the bracketing index max{i : keys[i] <= e}, clipped to
// [0, n-2], then the interpolation of the interval (k0, k1, v0, v1) =
// (keys[i], keys[i+1], values[i], values[i+1]): the same floats as
// CrossSection.lookup's four gathers, so the same bits (-fmad=false).
//
// What bounds it: latency, not bytes.  A plain binary search over the keys
// in global memory makes ceil(log2 n) dependent loads (15 for 30,000
// entries), of which the lower levels each wait a full L2 round trip, and
// the interpolation four more from two arrays.  So the search runs at two
// levels.  The coarse index coarse[j] = keys[j * S] (S = 2^shift, the
// smallest power of two that keeps it within xs.COARSE_KEYS entries: S =
// 16 and 1,875 entries, 7.3 KiB, for 30,000) is copied once per block into
// shared memory (stage_coarse), where the first level bisects it; that
// leaves the S keys of one group, 64 contiguous bytes at S = 16, which the
// second level bisects in global memory (one L2 round trip, then L1 hits);
// and the interval is one aligned 16-byte load.  Every table size takes
// this one path: S grows with n.  The test !(key > e) is
// torch.searchsorted(right=True)'s at both levels, so a NaN energy (a
// masked lane) lands at n and clips in bounds, and runs of equal keys, also
// across a group's first key, resolve as searchsorted resolves them.
//
// A collision never raises the energy (a scatter keeps at least
// ((A-1)/(A+1))^2 of it), so a lane's next first-level count is at most
// its last.  The kernels keep that count in a register per table (`hint`,
// within one launch: no state field) and gallop down from it, a few steps
// instead of ceil(log2(coarse_count + 1)): the card's form of
// neutral_tpu's live energy band (pallas_table.py energy_band).
struct XsTable {
  const float* keys;         // table mode: (n,) ascending, global memory
  const float4* intervals;   // table mode: (n - 1,) (k0, k1, v0, v1)
  const float* coarse;       // table mode: (coarse_count,), shared memory
  const float2* grid;        // analytic mode: (n,) (key, value) pairs
  int n;
  int shift;                 // table mode: log2 of the coarse stride S
};

// Entries of a table's coarse index: ceil(n / 2^shift).
__host__ __device__ __forceinline__ int coarse_count(int n, int shift) {
  return ((n - 1) >> shift) + 1;
}

// Copies a table's coarse index from global memory into `smem` with every
// thread of the block; the caller synchronises the block before a lookup.
__device__ __forceinline__ const float* stage_coarse(const float* coarse,
                                                     int n, int shift,
                                                     float* smem) {
  const int m = coarse_count(n, shift);
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    smem[j] = __ldg(coarse + j);
  }
  return smem;
}

// No level-1 hint: the whole coarse index is searched.
constexpr int kNoHint = 0x7fffffff;

// The bracketing index of energy e in stored table t (xs.TableLayout.index).
// `hint` is the level-1 count of the lane's previous lookup in t (kNoHint
// for none), and becomes this one's: an energy that has not risen since
// then has a count of at most that, which a gallop down from it brackets
// in a few steps; if coarse[hint] <= e the hint tells nothing and the
// whole index is searched, so the result never depends on it.
__device__ __forceinline__ int table_index(float e, const XsTable& t,
                                           int& hint) {
  // Level 1, shared memory: c = #{j : coarse[j] <= e}.  The count of all
  // keys <= e then lies in [(c - 1) S + 1, min(c S, n)] (0 when c = 0).
  int lo = 0, hi = coarse_count(t.n, t.shift);
  if (hint < hi && t.coarse[hint] > e) {
    hi = hint;
    for (int step = 1; hi > 0; step <<= 1) {
      const int probe = max(hi - step, 0);
      if (!(t.coarse[probe] > e)) {
        lo = probe + 1;
        break;
      }
      hi = probe;
    }
  }
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!(t.coarse[mid] > e)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  hint = lo;
  // Level 2, global memory: the keys of that one group.  c S is at most
  // 2,048 x 2^20 = 2^31 (n < 2^31 keeps the shift at or below 20), which
  // overflows an int: the group's end is taken in unsigned arithmetic.
  hi = static_cast<int>(min(static_cast<unsigned int>(lo) << t.shift,
                            static_cast<unsigned int>(t.n)));
  lo = max((lo - 1) * (1 << t.shift) + 1, 0);
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);   // lo + hi may pass 2^31 - 1
    if (!(__ldg(t.keys + mid) > e)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return min(max(lo - 1, 0), t.n - 2);
}

// The interpolation at e over interval idx of stored table t: one aligned
// 16-byte load.
__device__ __forceinline__ float table_interpolate(float e, const XsTable& t,
                                                   int idx) {
  const float4 iv = __ldg(t.intervals + idx);
  return iv.z + ((e - iv.x) / (iv.y - iv.x)) * (iv.w - iv.z);
}

__device__ __forceinline__ float table_lookup(float e, const XsTable& t,
                                              int& hint) {
  return table_interpolate(e, t, table_index(e, t, hint));
}

template <XsMode X>
__device__ __forceinline__ float xs_value(float e, const XsTable& t,
                                          int& hint) {
  if constexpr (X == XsMode::kAnalytic) {
    return xs_lookup(e, t.grid, t.n);
  } else {
    return table_lookup(e, t, hint);
  }
}

// Table mode: copies the coarse indexes of a launch's tables into the
// block's dynamic shared memory, scatter's and then, unless same_xs,
// absorb's (the launch sized it with table_smem_bytes), and synchronises
// the block; nothing in analytic mode.  Every thread of the block calls it
// before any lookup.
template <XsMode X, typename Params>
__device__ __forceinline__ void stage_tables(const Params& p, float* smem) {
  if constexpr (X == XsMode::kTable) {
    stage_coarse(p.scatter_coarse, p.scatter_entries, p.scatter_shift, smem);
    if (!p.same_xs) {
      stage_coarse(p.absorb_coarse, p.absorb_entries, p.absorb_shift,
                   smem + coarse_count(p.scatter_entries, p.scatter_shift));
    }
    __syncthreads();
  }
}

// The scatter and absorb tables of a launch, their coarse indexes where
// stage_tables put them (absorb reads scatter's when same_xs).
template <typename Params>
__device__ __forceinline__ XsTable scatter_table(const Params& p,
                                                 const float* smem) {
  return {p.scatter_keys, p.scatter_intervals, smem, p.scatter_grid,
          p.scatter_entries, p.scatter_shift};
}

template <typename Params>
__device__ __forceinline__ XsTable absorb_table(const Params& p,
                                                const float* smem) {
  return {p.absorb_keys, p.absorb_intervals,
          p.same_xs ? smem
                    : smem + coarse_count(p.scatter_entries, p.scatter_shift),
          p.absorb_grid, p.absorb_entries, p.absorb_shift};
}

// Dynamic shared memory of a launch with these parameters: the coarse
// indexes of its tables in table mode, none in analytic mode.
template <typename Params>
inline size_t table_smem_bytes(const Params& p) {
  if (p.xs_mode != static_cast<int>(XsMode::kTable)) return 0;
  int m = coarse_count(p.scatter_entries, p.scatter_shift);
  if (!p.same_xs) m += coarse_count(p.absorb_entries, p.absorb_shift);
  return sizeof(float) * static_cast<size_t>(m);
}

// torch.minimum / torch.maximum / clamp_min on float32: NaN propagates,
// otherwise fminf / fmaxf.
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// Collision event (transport.collision_physics, omp3/neutral.c:209-300):
// absorption (weight reduction, death below kMinEnergy) or elastic
// scatter, then a fresh mean free path at the new energy for a survivor.
// Counter c is consumed by the collision, c+1 by the new mean free path.
// Both draws are computed up front, before the event knows whether the
// particle dies: they are independent chains, which the compiler can
// interleave; a particle that dies discards the second, and its counter
// advances as before (by 1, not 2).  `sig_s` becomes the scatter
// cross-section at the energy the collision leaves, looked up whether or
// not the particle died: it is the one lookup of the collision, which
// serves the new mean free path here and the caller's next event, since
// the energy changes only in a collision (the same function of the same
// float gives the same bits); `hint` is the lane's first-level hint in the
// scatter table (table mode).  Returns whether the particle died.
template <XsMode X, RngScheme R>
__device__ __forceinline__ bool collide(const DrawKey& key,
                                        uint64_t& counter, float& energy,
                                        float& weight, float& omega_x,
                                        float& omega_y, float& mfp,
                                        float& sig_s, float mac_a,
                                        float mac_t, float number_density,
                                        const XsTable& scatter,
                                        int& hint) {
  bool died = false;
  const float p_absorb = mac_a / mac_t;
  float rn1a, rn1b, rn2a, rn2b;
  uniform2_f32<R>(key, counter, rn1a, rn1b);
  uniform2_f32<R>(key, counter + 1, rn2a, rn2b);
  if (rn1a < p_absorb) {
    weight = weight * (1.0f - p_absorb);
    died = energy < kMinEnergy;
  } else {
    const float mu_cm = 1.0f - 2.0f * rn1b;
    const float e_new = energy * ((kA * kA + (2.0f * kA) * mu_cm) + 1.0f) /
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
  sig_s = xs_value<X>(energy, scatter, hint);
  if (!died) {
    const float mac_s2 = number_density * sig_s * kBarns;
    counter += 1;
    mfp = -logf(rn2a) / mac_s2;
  }
  return died;
}

// Sum over the warp of a 64-bit count; every lane of the warp must call it.
__device__ __forceinline__ unsigned long long warp_sum_u64(
    unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

}  // namespace nt
