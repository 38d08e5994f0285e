// The stored-table cross-section lookup on its own (NVIDIA Hopper, sm_90a):
// the device function that the sweep and flight kernels run in table mode
// (common.cuh table_lookup), over a tensor of energies.
//
// Replaces, as the lookup inside those kernels does, the TPU lookup
// neutral_tpu/pallas_table.py::lookup_banded (:151).  That kernel kept the
// table in VMEM as (R, 128) tiles of k0/k1/v0/v1 and found a lane's row by
// scalar comparisons over the live energy band, then its column by a
// 7-step bisection with the TPU's one lane gather, because the TPU has no
// vector gather from memory.  The card gathers freely, and what bounds a
// search there is the latency of dependent loads, so the card's form of
// the same idea is a coarse index in shared memory and one packed 16-byte
// interval per interpolation (common.cuh, xs.TableLayout); the result is
// the same: the bracketing index max{i : keys[i] <= e} clipped to [0, n-2]
// and the same interpolation.  The live band has no counterpart: the
// coarse index covers the whole table in a few KiB.
//
// table_kernel.py binds it (table_lookup_kernel), to hold the lookup alone
// to its plain versions and to time it against torch.searchsorted, in
// float32 and float64 (the working type is a template parameter, as in the
// sweep kernel).  Each block stages the coarse index once and runs a
// grid-stride loop; the grid fills the card once (nt_table_lookup_blocks,
// which the wrapper asks once per device, type and table size, so that a
// launch makes no query).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace nt;

constexpr int kThreads = 256;

template <typename Real>
__global__ void __launch_bounds__(kThreads)
table_lookup_kernel(const Real* energy, Real* value, int32_t* index,
                    long long count, const Real* keys,
                    const Interval<Real>* intervals, const Real* coarse,
                    int n, int shift) {
  const XsTableT<Real> t{
      keys, intervals,
      stage_coarse(coarse, n, shift, dynamic_smem<Real>()), nullptr, n,
      shift};
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < count; i += stride) {
    const Real e = energy[i];
    int hint = kNoHint;
    const int idx = table_index(e, t, hint);
    value[i] = table_interpolate(e, t, idx);
    if (index) index[i] = idx;
  }
}

// Blocks of the lookup kernel in the working type that the current device
// holds at once for an n-entry table of coarse shift `shift` (its coarse
// index in shared memory), into *blocks; returns the CUDA error code.
template <typename Real>
int lookup_blocks(int n, int shift, int* blocks) {
  const size_t smem = sizeof(Real) * coarse_count(n, shift);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, table_lookup_kernel<Real>, kThreads, smem);
  }
  *blocks = sms * per_sm;
  return static_cast<int>(err);
}

// Looks up `count` energies in the table (keys, intervals, coarse, n,
// shift) of xs.TableLayout on `stream`: value[i] as table_lookup gives it
// and, unless `index` is null, index[i] its bracketing index.  The grid
// is `max_blocks` (lookup_blocks), or one block per 256 energies when that
// is fewer.  Returns cudaGetLastError() (0 when the launch was accepted).
template <typename Real>
int lookup_launch(const Real* energy, Real* value, int32_t* index,
                  long long count, const Real* keys,
                  const Interval<Real>* intervals, const Real* coarse, int n,
                  int shift, int max_blocks, void* stream) {
  if (count <= 0) return 0;
  if (max_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(Real) * coarse_count(n, shift);
  const long long need = (count + kThreads - 1) / kThreads;
  const unsigned int blocks = static_cast<unsigned int>(
      std::min(need, static_cast<long long>(max_blocks)));
  table_lookup_kernel<Real><<<blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      energy, value, index, count, keys, intervals, coarse, n, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entry points of table_kernel.py: lookup_blocks and lookup_launch in
// float32 and in float64 (_f64).
extern "C" int nt_table_lookup_blocks(int n, int shift, int* blocks) {
  return lookup_blocks<float>(n, shift, blocks);
}

extern "C" int nt_table_lookup_blocks_f64(int n, int shift, int* blocks) {
  return lookup_blocks<double>(n, shift, blocks);
}

extern "C" int nt_table_lookup_launch(const float* energy, float* value,
                                      int32_t* index, long long count,
                                      const float* keys,
                                      const float4* intervals,
                                      const float* coarse, int n, int shift,
                                      int max_blocks, void* stream) {
  return lookup_launch(energy, value, index, count, keys, intervals, coarse,
                       n, shift, max_blocks, stream);
}

extern "C" int nt_table_lookup_launch_f64(const double* energy,
                                          double* value, int32_t* index,
                                          long long count,
                                          const double* keys,
                                          const Interval64* intervals,
                                          const double* coarse, int n,
                                          int shift, int max_blocks,
                                          void* stream) {
  return lookup_launch(energy, value, index, count, keys, intervals, coarse,
                       n, shift, max_blocks, stream);
}
