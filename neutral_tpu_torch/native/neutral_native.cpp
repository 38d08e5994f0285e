// neutral_tpu native engine: history-based Monte Carlo neutral-particle
// transport on the host CPU (C++17 + OpenMP), exposed through a C ABI for
// ctypes.
//
// Role in the framework (the TPU path is JAX/XLA — this is the runtime-side
// native component):
//   * independent cross-check oracle for the vectorized TPU engine — same
//     physics and the same counter-based RNG stream contract, so results
//     must agree bitwise with the Python oracle and statistically with the
//     event-based engine;
//   * fast golden-tally generation for arbitrary decks (hundreds of times
//     faster than the pure-Python oracle);
//   * a self-contained CPU fallback backend for hosts without accelerators.
//
// Physics semantics follow the reference mini-app's canonical backend
// (the reference's omp3/neutral.c:43-420: the until-census history loop with
// facet/collision/census events); this file is an independent
// implementation written from that behavioral spec, not a translation.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Threefry-2x64 (20 rounds) — public algorithm (Salmon et al., SC'11).
// ---------------------------------------------------------------------------

constexpr int kRot[8] = {16, 42, 12, 31, 16, 32, 24, 21};
constexpr uint64_t kParity = 0x1BD11BDAA9FC1A22ULL;

inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

inline void threefry2x64(uint64_t c0, uint64_t c1, uint64_t k0, uint64_t k1,
                         uint64_t* out0, uint64_t* out1) {
  const uint64_t ks[3] = {k0, k1, kParity ^ k0 ^ k1};
  uint64_t x0 = c0 + ks[0];
  uint64_t x1 = c1 + ks[1];
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
  *out0 = x0;
  *out1 = x1;
}

// Reference uniform mapping: u = v * 2^-64 + 2^-65, strictly inside (0,1).
constexpr double kF64 = 5.421010862427522e-20;   // 2^-64
constexpr double kHalfF64 = 2.710505431213761e-20;  // 2^-65

// ---------------------------------------------------------------------------
// PCG64si (pcg_oneseq_64_rxs_m_xs_64) — the RNG scheme of the reference's
// oacc/raja backends, which seed a FRESH generator per draw with
// seed = counter + 1e15*master_key + 1e4*pid (oacc/neutral.c:710-719).
// Public algorithm (M.E. O'Neill); independent implementation.
// ---------------------------------------------------------------------------

constexpr uint64_t kPcgMult = 6364136223846793005ULL;
constexpr uint64_t kPcgInc = 1442695040888963407ULL;
constexpr uint64_t kPcgOutMult = 12605985483714917081ULL;

inline uint64_t pcg64si_first(uint64_t seed) {
  const uint64_t state = (kPcgInc + seed) * kPcgMult + kPcgInc;
  const uint64_t word =
      ((state >> ((state >> 59) + 5)) ^ state) * kPcgOutMult;
  return (word >> 43) ^ word;
}

// scheme: 0 = threefry (omp3/omp4/cuda backends), 1 = pcg64si (oacc/raja).
// The pcg pair at counter c uses per-draw seeds 2c and 2c+1 — the same
// pair-based bookkeeping as the JAX engine (rng.uniform2_pcg_*).
inline void draw2(int scheme, uint64_t pid, uint64_t master_key,
                  uint64_t counter, double* r0, double* r1) {
  if (scheme == 1) {
    const uint64_t base =
        1000000000000000ULL * master_key + 10000ULL * pid + 2ULL * counter;
    *r0 = static_cast<double>(pcg64si_first(base)) * kF64 + kHalfF64;
    *r1 = static_cast<double>(pcg64si_first(base + 1)) * kF64 + kHalfF64;
    return;
  }
  uint64_t v0, v1;
  threefry2x64(counter, 0, pid, master_key, &v0, &v1);
  *r0 = static_cast<double>(v0) * kF64 + kHalfF64;
  *r1 = static_cast<double>(v1) * kF64 + kHalfF64;
}

// ---------------------------------------------------------------------------
// Physics constants (shared with neutral_tpu.constants).
// ---------------------------------------------------------------------------

constexpr double kEvToJ = 1.60217646e-19;
constexpr double kAvogadros = 6.02214085774e23;
constexpr double kBarns = 1.0e-28;
constexpr double kParticleMass = 1.674927471213e-27;
constexpr double kMassNo = 1.0e2;
constexpr double kMolarMass = 1.0e-2;
constexpr double kMinEnergy = 1.0e0;
constexpr double kOpenBoundCorrection = 1.0e-13;

struct Table {
  const double* keys;
  const double* values;
  int n;

  double lookup(double energy) const {
    // binary search for the bracketing interval + linear interpolation
    int lo = 0, hi = n - 1;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (keys[mid] <= energy) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    const int i = lo > n - 2 ? n - 2 : lo;
    return values[i] +
           ((energy - keys[i]) / (keys[i + 1] - keys[i])) *
               (values[i + 1] - values[i]);
  }
};

struct Particles {
  double* x;
  double* y;
  double* omega_x;
  double* omega_y;
  double* energy;
  double* weight;
  double* dt_to_census;
  double* mfp_to_collision;
  int32_t* cellx;
  int32_t* celly;
  int32_t* dead;
};

inline double speed_of(double energy) {
  return std::sqrt(2.0 * energy * kEvToJ / kParticleMass);
}

}  // namespace

extern "C" {

// Injects particles exactly per the framework's stream contract
// (draws (pid, 0, 0) for position, (pid, 0, 1) for angle).
void nt_inject(int64_t nparticles, const double* edgex, const double* edgey,
               int nx, int ny, double source_x0, double source_y0,
               double source_w, double source_h, double initial_energy,
               double dt, Particles* p, int rng_scheme) {
#pragma omp parallel for schedule(static)
  for (int64_t k = 0; k < nparticles; ++k) {
    double r0, r1, t0, t1;
    draw2(rng_scheme, static_cast<uint64_t>(k), 0, 0, &r0, &r1);
    const double x = source_x0 + r0 * source_w;
    const double y = source_y0 + r1 * source_h;
    // cell via binary search on the (possibly non-uniform) edges
    auto locate = [](const double* e, int ncells, double v) {
      int lo = 0, hi = ncells + 1;
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (e[mid] <= v) {
          lo = mid;
        } else {
          hi = mid;
        }
      }
      return lo < ncells ? lo : ncells - 1;
    };
    p->x[k] = x;
    p->y[k] = y;
    p->cellx[k] = locate(edgex, nx, x);
    p->celly[k] = locate(edgey, ny, y);
    draw2(rng_scheme, static_cast<uint64_t>(k), 0, 1, &t0, &t1);
    const double theta = 2.0 * M_PI * t0;
    p->omega_x[k] = std::cos(theta);
    p->omega_y[k] = std::sin(theta);
    p->energy[k] = initial_energy;
    p->weight[k] = 1.0;
    p->dt_to_census[k] = dt;
    p->mfp_to_collision[k] = 0.0;
    p->dead[k] = 0;
  }
}

// One census timestep over all particles (history-based, OpenMP).
// Returns events through nfacets/ncollisions/nprocessed.
void nt_timestep(int64_t nparticles, Particles* p, const double* density,
                 const double* edgex, const double* edgey, int nx, int ny,
                 const double* s_keys, const double* s_vals, int s_n,
                 const double* a_keys, const double* a_vals, int a_n,
                 double dt, uint64_t master_key, int64_t ntotal_particles,
                 double* tally, uint64_t* nfacets, uint64_t* ncollisions,
                 uint64_t* nprocessed, int rng_scheme) {
  const Table cs_scatter{s_keys, s_vals, s_n};
  const Table cs_absorb{a_keys, a_vals, a_n};
  const double inv_ntotal = 1.0 / static_cast<double>(ntotal_particles);
  uint64_t facets = 0, collisions = 0, processed = 0;

#pragma omp parallel for schedule(guided) \
    reduction(+ : facets, collisions, processed)
  for (int64_t pp = 0; pp < nparticles; ++pp) {
    if (p->dead[pp]) {
      continue;
    }
    ++processed;
    uint64_t counter = 0;

    double x = p->x[pp], y = p->y[pp];
    double ox = p->omega_x[pp], oy = p->omega_y[pp];
    double energy = p->energy[pp], weight = p->weight[pp];
    int cellx = p->cellx[pp], celly = p->celly[pp];
    bool dead = false;

    double local_density = density[celly * nx + cellx];
    double sig_s = cs_scatter.lookup(energy);
    double sig_a = cs_absorb.lookup(energy);
    double number_density = local_density * (kAvogadros / kMolarMass);
    double mac_s = number_density * sig_s * kBarns;
    double mac_a = number_density * sig_a * kBarns;
    double speed = speed_of(energy);
    double deposit = 0.0;

    // fresh census clock + mean free path (draw counter 0)
    double dt_to_census = dt;
    double r0, r1;
    draw2(rng_scheme, static_cast<uint64_t>(pp), master_key, counter++,
          &r0, &r1);
    double mfp = -std::log(r0) / mac_s;

    auto seg_deposit = [&](double dist) {
      const double sig_t = sig_s + sig_a;
      const double absorb_frac = sig_a / sig_t;
      const double avg_exit =
          energy * ((kMassNo * kMassNo + kMassNo + 1.0) /
                    ((kMassNo + 1.0) * (kMassNo + 1.0)));
      const double heating = energy - (1.0 - absorb_frac) * avg_exit;
      return weight * dist * (sig_t * kBarns) * heating * number_density;
    };
    auto flush = [&]() {
#pragma omp atomic
      tally[celly * nx + cellx] += deposit * inv_ntotal;
      deposit = 0.0;
    };

    while (dt_to_census > 0.0) {
      const double cell_mfp = 1.0 / (mac_s + mac_a);

      const double ux_inv = 1.0 / (ox * speed);
      const double uy_inv = 1.0 / (oy * speed);
      const double dt_x = (ox >= 0.0)
          ? (edgex[cellx + 1] - x) * ux_inv
          : (edgex[cellx] - kOpenBoundCorrection - x) * ux_inv;
      const double dt_y = (oy >= 0.0)
          ? (edgey[celly + 1] - y) * uy_inv
          : (edgey[celly] - kOpenBoundCorrection - y) * uy_inv;
      const bool x_facet = dt_x < dt_y;
      const double d_facet = (x_facet ? dt_x : dt_y) * speed;
      const double d_coll = mfp * cell_mfp;
      const double d_census = speed * dt_to_census;

      if (d_coll < d_facet && d_coll < d_census) {
        // -------- collision --------
        ++collisions;
        deposit += seg_deposit(d_coll);
        x += d_coll * ox;
        y += d_coll * oy;
        const double p_absorb = mac_a / (mac_s + mac_a);
        draw2(rng_scheme, static_cast<uint64_t>(pp), master_key, counter++,
              &r0, &r1);
        if (r0 < p_absorb) {
          weight *= (1.0 - p_absorb);
          if (energy < kMinEnergy) {
            dead = true;
            flush();
            break;
          }
        } else {
          const double mu_cm = 1.0 - 2.0 * r1;
          const double A = kMassNo;
          const double e_new =
              energy * (A * A + 2.0 * A * mu_cm + 1.0) / ((A + 1.0) * (A + 1.0));
          const double cos_t = 0.5 * ((A + 1.0) * std::sqrt(e_new / energy) -
                                      (A - 1.0) * std::sqrt(energy / e_new));
          const double sin_t = std::sqrt(1.0 - cos_t * cos_t);
          const double nox = ox * cos_t - oy * sin_t;
          const double noy = ox * sin_t + oy * cos_t;
          ox = nox;
          oy = noy;
          energy = e_new;
        }
        sig_s = cs_scatter.lookup(energy);
        sig_a = cs_absorb.lookup(energy);
        mac_s = number_density * sig_s * kBarns;
        mac_a = number_density * sig_a * kBarns;
        draw2(rng_scheme, static_cast<uint64_t>(pp), master_key, counter++,
              &r0, &r1);
        mfp = -std::log(r0) / mac_s;
        dt_to_census -= d_coll / speed;
        speed = speed_of(energy);
      } else if (d_facet < d_census) {
        // -------- facet crossing --------
        ++facets;
        mfp -= d_facet / cell_mfp;
        dt_to_census -= d_facet / speed;
        deposit += seg_deposit(d_facet);
        flush();
        x += d_facet * ox;
        y += d_facet * oy;
        if (x_facet) {
          if (ox > 0.0) {
            if (cellx >= nx - 1) {
              ox = -ox;
            } else {
              ++cellx;
            }
          } else if (ox < 0.0) {
            if (cellx <= 0) {
              ox = -ox;
            } else {
              --cellx;
            }
          }
        } else {
          if (oy > 0.0) {
            if (celly >= ny - 1) {
              oy = -oy;
            } else {
              ++celly;
            }
          } else if (oy < 0.0) {
            if (celly <= 0) {
              oy = -oy;
            } else {
              --celly;
            }
          }
        }
        local_density = density[celly * nx + cellx];
        number_density = local_density * (kAvogadros / kMolarMass);
        mac_s = number_density * sig_s * kBarns;
        mac_a = number_density * sig_a * kBarns;
      } else {
        // -------- census --------
        x += d_census * ox;
        y += d_census * oy;
        mfp -= d_census / cell_mfp;
        deposit += seg_deposit(d_census);
        flush();
        dt_to_census = 0.0;
        break;
      }
    }

    p->x[pp] = x;
    p->y[pp] = y;
    p->omega_x[pp] = ox;
    p->omega_y[pp] = oy;
    p->energy[pp] = energy;
    p->weight[pp] = weight;
    p->dt_to_census[pp] = dt_to_census;
    p->mfp_to_collision[pp] = mfp;
    p->cellx[pp] = cellx;
    p->celly[pp] = celly;
    p->dead[pp] = dead ? 1 : 0;
  }

  *nfacets = facets;
  *ncollisions = collisions;
  *nprocessed = processed;
}

int nt_num_threads() {
#ifdef _OPENMP
  int n = 0;
#pragma omp parallel
  {
#pragma omp single
    n = omp_get_num_threads();
  }
  return n;
#else
  return 1;
#endif
}

// RNG self-test hooks (used by unit tests to pin the stream contract).
void nt_threefry2x64(uint64_t c0, uint64_t c1, uint64_t k0, uint64_t k1,
                     uint64_t* out0, uint64_t* out1) {
  threefry2x64(c0, c1, k0, k1, out0, out1);
}

void nt_draw2(uint64_t pid, uint64_t master_key, uint64_t counter, double* r0,
              double* r1) {
  draw2(0, pid, master_key, counter, r0, r1);
}

uint64_t nt_pcg64si_first(uint64_t seed) { return pcg64si_first(seed); }

}  // extern "C"
