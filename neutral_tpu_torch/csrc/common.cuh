// Device code shared by the sweep kernel (sweep.cu), the flight kernel
// (flight.cu), the begin kernel (begin.cu) and the lookup alone (table.cu):
// constants, Threefry-2x64 and PCG64si draws, the analytic and table
// cross-section lookups and the collision event.  Every function here
// follows the plain PyTorch version (neutral_tpu_torch/transport.py, xs.py,
// rng.py) operation by operation, with the same constants; the build passes
// -fmad=false so that no a*b+c is fused (see build.py).
//
// The working type is a template parameter `Real`: float (every kernel) or
// double (the float64 instantiations of every kernel).  In
// float32 a constant enters the arithmetic as the plain version rounds it
// (np.float32 of the float64 value), in float64 unrounded (xs.const).
//
// The deck's modes are template parameters, so that each combination is
// its own instantiation and the analytic/threefry one is the code without
// the others: XsMode (analytic resonance formula read from its grid, or a
// stored table searched through a coarse index in shared memory), RngScheme (threefry or pcg64si)
// and, in the sweep kernel, DensityMode (region rectangles, or a per-cell
// grid) and EdgeMode (a cell's facet edges from the uniform pitch, or read
// from the mesh's edge arrays).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace nt {

enum class XsMode : int { kAnalytic = 0, kTable = 1 };
enum class RngScheme : int { kThreefry = 0, kPcg64si = 1 };
enum class DensityMode : int { kRegions = 0, kGrid = 1 };
enum class EdgeMode : int { kPitch = 0, kArray = 1 };

// Constants as the plain version rounds them: the float64 value, then one
// rounding to the working type (neutral_tpu's np.dtype(dtype).type(v)):
// none in float64.
constexpr double kAvogadros = 6.02214085774e23;
constexpr double kMolarMass = 1.0e-2;
constexpr double kEvToJ = 1.60217646e-19;
constexpr double kParticleMass = 1.674927471213e-27;
constexpr double kMassNo = 1.0e2;

template <typename Real>
struct Const {
  static constexpr Real kInvMolar = static_cast<Real>(kAvogadros / kMolarMass);
  static constexpr Real kBarns = static_cast<Real>(1.0e-28);
  static constexpr Real kAvgScatterFrac = static_cast<Real>(
      (kMassNo * kMassNo + kMassNo + 1.0) /
      ((kMassNo + 1.0) * (kMassNo + 1.0)));
  static constexpr Real kSpeedCoef =
      static_cast<Real>(2.0 * kEvToJ / kParticleMass);
  static constexpr Real kMinEnergy = static_cast<Real>(1.0);
  static constexpr Real kObc = static_cast<Real>(1.0e-13);
  static constexpr Real kA = static_cast<Real>(kMassNo);
  static constexpr Real kE8 = static_cast<Real>(1.0e8);
  static constexpr Real kEm2 = static_cast<Real>(1.0e-2);
  static constexpr Real kEm8 = static_cast<Real>(1.0e-8);
  static constexpr Real kE3 = static_cast<Real>(1.0e3);
};

constexpr float kTwoM32 = 0x1p-32f;
constexpr float kTwoM33 = 0x1p-33f;

// The math of the working type: IEEE square root (whatever -prec-sqrt
// says for double), libdevice's logarithm (the one PyTorch's torch.log
// calls), fmax, fmin, fabs, and the floor to int32 as XLA and xs.to_int convert: NaN
// to 0, out of range saturated (cvt.rmi does so from float32; from
// float64 both are explicit).
__device__ __forceinline__ float nt_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double nt_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float nt_log(float v) { return logf(v); }
__device__ __forceinline__ double nt_log(double v) { return log(v); }
__device__ __forceinline__ float nt_fmax(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double nt_fmax(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float nt_fmin(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double nt_fmin(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float nt_fabs(float v) { return fabsf(v); }
__device__ __forceinline__ double nt_fabs(double v) { return fabs(v); }
__device__ __forceinline__ int floor_int(float v) {
  return __float2int_rd(v);
}
__device__ __forceinline__ int floor_int(double v) {
  if (!(v >= -2147483648.0)) return isnan(v) ? 0 : INT32_MIN;
  return v >= 2147483648.0 ? INT32_MAX : __double2int_rd(v);
}

// A stored table's packed interval (keys[i], keys[i+1], values[i],
// values[i+1]) as (x, y, z, w): one aligned 16-byte load in float32 (a
// float4), two in float64.
struct alignas(16) Interval64 {
  double x, y, z, w;
};

template <typename Real>
struct Vec;
template <>
struct Vec<float> {
  using Pair = float2;          // an analytic grid's (key, value)
  using Interval = float4;
};
template <>
struct Vec<double> {
  using Pair = double2;
  using Interval = Interval64;
};
template <typename Real>
using Pair = typename Vec<Real>::Pair;
template <typename Real>
using Interval = typename Vec<Real>::Interval;

__device__ __forceinline__ float4 load_interval(const float4* p) {
  return __ldg(p);
}
__device__ __forceinline__ Interval64 load_interval(const Interval64* p) {
  const double2* q = reinterpret_cast<const double2*>(p);
  const double2 a = __ldg(q);
  const double2 b = __ldg(q + 1);
  return {a.x, a.y, b.x, b.y};
}

// The block's dynamic shared memory as an array of the working type (one
// extern array per type: extern __shared__ arrays of one name must agree),
// for the begin and lookup kernels.  The sweep kernel declares one float
// array and hands it to stage_tables/scatter_table/absorb_table, whose
// float64 overloads below read it as doubles: its float32 instantiations
// then compile to the instructions they had before the working type was a
// template parameter (a pointer held in a local of the kernel, or cast in
// it, changed their register allocation).
template <typename Real>
__device__ __forceinline__ Real* dynamic_smem();
template <>
__device__ __forceinline__ float* dynamic_smem<float>() {
  extern __shared__ float nt_smem_f32[];
  return nt_smem_f32;
}
template <>
__device__ __forceinline__ double* dynamic_smem<double>() {
  extern __shared__ double nt_smem_f64[];
  return nt_smem_f64;
}

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

// The reference's (double)u64 * 2^-64 + 2^-65, strictly inside (0, 1):
// one round-to-nearest conversion of the whole word (rng._to_f64's
// hi * 2^32 + lo), an exact scaling and one rounded add.
__device__ __forceinline__ double word_to_f64(uint64_t v) {
  return __ull2double_rn(v) * 0x1p-64 + 0x1p-65;
}

__device__ __forceinline__ void word_to_real(uint64_t v, float& u) {
  u = hi_to_f32(v);
}
__device__ __forceinline__ void word_to_real(uint64_t v, double& u) {
  u = word_to_f64(v);
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

// Pair draw mapped to the working type (rng.uniform2_scheme): float32 from
// the high words, float64 from the whole words.  threefry: ctr = (counter,
// 0), key = (pid, master_key).  pcg64si: the generators seeded seed and
// seed + 1, seed = 1e15*master_key + 1e4*pid + 2*counter (mod 2^64).
template <RngScheme R, typename Real>
__device__ __forceinline__ void uniform2(const DrawKey& key,
                                         uint64_t counter, Real& u0,
                                         Real& u1) {
  uint64_t v0, v1;
  if constexpr (R == RngScheme::kThreefry) {
    threefry2x64(counter, key, v0, v1);
  } else {
    const uint64_t seed = key.k0 + 2ULL * counter;
    v0 = pcg64si_first(seed);
    v1 = pcg64si_first(seed + 1ULL);
  }
  word_to_real(v0, u0);
  word_to_real(v1, u1);
}

// Analytic resonance table (xs.CrossSection analytic mode).  Its keys and
// values depend only on the index i and the entry count n: key(i) =
// 1e8 * ((i + 1) / n)^4 + 1e-2, value(i) = 1e3 * ((n - i) / n) + 1, each
// with one IEEE division.  The wrapper builds them once per run and working
// type, for every index, with the plain version's own arithmetic
// (CrossSection.analytic_grid_in on the card) into `grid`, (key, value)
// pairs; the lookup reads them instead of dividing.  The closed-form index lands
// at most one bin off, which the two nudges correct, so the keys and values
// it can read are those at i0 - 1 .. i0 + 2 of its first guess i0: all four
// are loaded at once (the grid, 240 KB for 29,999 entries in float32, 480
// KB in float64, stays in L1 and L2), and the nudges and the interpolation
// pick from them, as the plain version's gathers do.
template <typename Real>
__device__ __forceinline__ Real xs_lookup(Real e, const Pair<Real>* grid,
                                          int n) {
  using C = Const<Real>;
  const Real m = static_cast<Real>(n);
  const Real u = nt_sqrt(nt_sqrt((e - C::kEm2) * C::kEm8));
  // Below 1e-2 eV u is NaN: cvt.rmi sends it to 0 (and saturates), as
  // XLA's conversion and xs.to_int do.
  const int i0 = min(max(floor_int(u * m) - 1, 0), n - 2);
  const Pair<Real> gm = __ldg(grid + max(i0 - 1, 0));
  const Pair<Real> g0 = __ldg(grid + i0);
  const Pair<Real> g1 = __ldg(grid + i0 + 1);
  const Pair<Real> g2 = __ldg(grid + min(i0 + 2, n - 1));
  // idx -= e < key(i0); idx += e >= key(clip(idx + 1)); clip to [0, n-2]
  const bool down = e < g0.x;
  const int up = e >= (down ? g0.x : g1.x) ? 1 : 0;
  const int idx = min(max(i0 - (down ? 1 : 0) + up, 0), n - 2);
  const int d = idx - i0;       // -1, 0 or 1
  const Pair<Real> lo = d < 0 ? gm : (d == 0 ? g0 : g1);
  const Pair<Real> hi = d < 0 ? g0 : (d == 0 ? g1 : g2);
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
// 16 and 1,875 entries, 7.3 KiB in float32 and 14.6 KiB in float64, for
// 30,000) is copied once per block into shared memory (stage_coarse),
// where the first level bisects it; that leaves the S keys of one group,
// 64 contiguous bytes at S = 16 in float32 (128 in float64), which the
// second level bisects in global memory (one L2 round trip, then L1 hits);
// and the interval is one aligned 16-byte load in float32, two in float64
// (32 bytes on one line).  Every table size takes this one path: S grows
// with n.  The test !(key > e) is torch.searchsorted(right=True)'s at both
// levels, so a NaN energy (a masked lane) lands at n and clips in bounds,
// and runs of equal keys, also across a group's first key, resolve as
// searchsorted resolves them.
//
// A collision never raises the energy (a scatter keeps at least
// ((A-1)/(A+1))^2 of it), so a lane's next first-level count is at most
// its last.  The kernels keep that count in a register per table (`hint`,
// within one launch: no state field) and gallop down from it, a few steps
// instead of ceil(log2(coarse_count + 1)): the card's form of
// neutral_tpu's live energy band (pallas_table.py energy_band).
template <typename Real>
struct XsTableT {
  const Real* keys;                 // table mode: (n,) ascending, global
  const Interval<Real>* intervals;  // table mode: (n - 1,) (k0, k1, v0, v1)
  const Real* coarse;               // table mode: (coarse_count,), shared
  const Pair<Real>* grid;           // analytic mode: (n,) (key, value) pairs
  int n;
  int shift;                        // table mode: log2 of the coarse stride
};

// Entries of a table's coarse index: ceil(n / 2^shift).
__host__ __device__ __forceinline__ int coarse_count(int n, int shift) {
  return ((n - 1) >> shift) + 1;
}

// Copies a table's coarse index from global memory into `smem` with every
// thread of the block; the caller synchronises the block before a lookup.
template <typename Real>
__device__ __forceinline__ const Real* stage_coarse(const Real* coarse,
                                                    int n, int shift,
                                                    Real* smem) {
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
template <typename Real>
__device__ __forceinline__ int table_index(Real e, const XsTableT<Real>& t,
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
// 16-byte load in float32, two in float64.
template <typename Real>
__device__ __forceinline__ Real table_interpolate(Real e,
                                                  const XsTableT<Real>& t,
                                                  int idx) {
  const Interval<Real> iv = load_interval(t.intervals + idx);
  return iv.z + ((e - iv.x) / (iv.y - iv.x)) * (iv.w - iv.z);
}

template <typename Real>
__device__ __forceinline__ Real table_lookup(Real e, const XsTableT<Real>& t,
                                             int& hint) {
  return table_interpolate(e, t, table_index(e, t, hint));
}

template <XsMode X, typename Real>
__device__ __forceinline__ Real xs_value(Real e, const XsTableT<Real>& t,
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
template <XsMode X, typename Params, typename Real>
__device__ __forceinline__ void stage_tables(const Params& p, Real* smem) {
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
template <typename Params, typename Real>
__device__ __forceinline__ XsTableT<Real> scatter_table(const Params& p,
                                                        const Real* smem) {
  return {p.scatter_keys, p.scatter_intervals, smem, p.scatter_grid,
          p.scatter_entries, p.scatter_shift};
}

template <typename Params, typename Real>
__device__ __forceinline__ XsTableT<Real> absorb_table(const Params& p,
                                                       const Real* smem) {
  return {p.absorb_keys, p.absorb_intervals,
          p.same_xs ? smem
                    : smem + coarse_count(p.scatter_entries, p.scatter_shift),
          p.absorb_grid, p.absorb_entries, p.absorb_shift};
}

// A float64 launch's tables with the block's dynamic shared memory given
// as floats (a kernel's one extern array): the same, read as doubles.
template <typename Params>
using Float64Params = std::enable_if_t<
    std::is_same_v<decltype(Params::scatter_coarse), const double*>, int>;

template <XsMode X, typename Params, Float64Params<Params> = 0>
__device__ __forceinline__ void stage_tables(const Params& p, float* smem) {
  stage_tables<X>(p, reinterpret_cast<double*>(smem));
}

template <typename Params, Float64Params<Params> = 0>
__device__ __forceinline__ XsTableT<double> scatter_table(const Params& p,
                                                          const float* smem) {
  return scatter_table(p, reinterpret_cast<const double*>(smem));
}

template <typename Params, Float64Params<Params> = 0>
__device__ __forceinline__ XsTableT<double> absorb_table(const Params& p,
                                                         const float* smem) {
  return absorb_table(p, reinterpret_cast<const double*>(smem));
}

// Dynamic shared memory of a launch with these parameters: the coarse
// indexes of its tables in table mode (in the working type), none in
// analytic mode.
template <typename Params>
inline size_t table_smem_bytes(const Params& p) {
  if (p.xs_mode != static_cast<int>(XsMode::kTable)) return 0;
  int m = coarse_count(p.scatter_entries, p.scatter_shift);
  if (!p.same_xs) m += coarse_count(p.absorb_entries, p.absorb_shift);
  return sizeof(*p.scatter_coarse) * static_cast<size_t>(m);
}

// torch.minimum / torch.maximum / clamp_min on float32: NaN propagates,
// otherwise fminf / fmaxf.
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// The same on float64 (the flight kernel's float64 instantiations).
__device__ __forceinline__ double tmin(double a, double b) {
  return isnan(a) ? a : (isnan(b) ? b : fmin(a, b));
}

__device__ __forceinline__ double tmax(double a, double b) {
  return isnan(a) ? a : (isnan(b) ? b : fmax(a, b));
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
template <XsMode X, RngScheme R, typename Real>
__device__ __forceinline__ bool collide(const DrawKey& key,
                                        uint64_t& counter, Real& energy,
                                        Real& weight, Real& omega_x,
                                        Real& omega_y, Real& mfp,
                                        Real& sig_s, Real mac_a,
                                        Real mac_t, Real number_density,
                                        const XsTableT<Real>& scatter,
                                        int& hint) {
  using C = Const<Real>;
  constexpr Real kOne = 1, kTwo = 2, kHalf = 0.5;
  bool died = false;
  const Real p_absorb = mac_a / mac_t;
  Real rn1a, rn1b, rn2a, rn2b;
  uniform2<R>(key, counter, rn1a, rn1b);
  uniform2<R>(key, counter + 1, rn2a, rn2b);
  if (rn1a < p_absorb) {
    weight = weight * (kOne - p_absorb);
    died = energy < C::kMinEnergy;
  } else {
    const Real mu_cm = kOne - kTwo * rn1b;
    const Real e_new = energy * ((C::kA * C::kA + (kTwo * C::kA) * mu_cm) +
                                 kOne) /
                       ((C::kA + kOne) * (C::kA + kOne));
    const Real cos_t = kHalf * ((C::kA + kOne) * nt_sqrt(e_new / energy) -
                                (C::kA - kOne) * nt_sqrt(energy / e_new));
    const Real sin_t = nt_sqrt(nt_fmax(kOne - cos_t * cos_t, Real(0)));
    const Real ox = omega_x * cos_t - omega_y * sin_t;
    const Real oy = omega_x * sin_t + omega_y * cos_t;
    omega_x = ox;
    omega_y = oy;
    energy = e_new;
  }
  counter += 1;
  sig_s = xs_value<X>(energy, scatter, hint);
  if (!died) {
    const Real mac_s2 = number_density * sig_s * C::kBarns;
    counter += 1;
    mfp = -nt_log(rn2a) / mac_s2;
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
