// Segment deposit for NVIDIA Hopper (sm_90a): one thread per segment.
//
// Replaces both TPU segment rasterizers, neutral_tpu/raster.py::
// _raster_kernel (:161, pl.pallas_call :278) and ::_walk_kernel (:331,
// pl.pallas_call :529).  They compute one function: every cell a segment
// [gx0, gy0, gx1, gy1, kk] (cell units) crosses receives kk times the
// clipped overlap of the segment with the cell.  The TPU had no fast
// scatter, so _raster_kernel sorted (segment x tile) pairs and swept each
// 128x128 tally tile resident in VMEM, and _walk_kernel kept the whole
// padded tally in VMEM and walked tiles with a scalar DDA.  Here each thread
// walks its segment's cells in DDA order, exactly as the plain version
// (neutral_tpu_torch/raster.py deposit_segments_plain, the port of
// rasterize_xla) does, and adds kk * fraction into the flat tally with
// atomicAdd(float*), skipping zeros.  The start cell is clipped into the
// grid, fractions that fall off it are dropped, and axis-parallel extents
// are nudged to 1e-12.  No sort, tiles or buffer residency.
//
// The segment count is read from device memory (the flight kernel's atomic
// counter), so the host never waits for it: a grid-stride loop over a
// fixed grid covers however many rows there are.
//
// What bounds it on the H100: one atomic add per (segment, cell) visit
// into a 64 MB tally that mostly lives in HBM (the 50 MB L2 holds part of
// it), and warps whose segments differ in length.  This first version does
// nothing about either yet.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

// Layout shared with raster_kernel._RasterParams (ctypes).
struct RasterParams {
  const float* segs;                    // (cap, 5) rows
  const unsigned long long* nseg;       // rows written (may exceed cap)
  float* tally;                         // (ny * nx,) flat, row-major
  long long cap;
  int nx;
  int ny;
};

namespace {

using namespace nt;

constexpr int kThreads = 256;
constexpr int kBlocks = 132 * 16;       // 16 blocks per SM of an H100
constexpr float kTiny = static_cast<float>(1.0e-12);
constexpr float kBig = static_cast<float>(1.0e30);

__global__ void __launch_bounds__(kThreads)
raster_kernel(const RasterParams p) {
  const unsigned long long nseg =
      min(*p.nseg, static_cast<unsigned long long>(p.cap));
  const int max_steps = p.nx + p.ny + 2;
  for (unsigned long long s =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
           threadIdx.x;
       s < nseg; s += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
    const float* row = p.segs + 5 * s;
    const float gx0 = row[0];
    const float gy0 = row[1];
    const float kk = row[4];
    if (kk == 0.0f) continue;
    const float dgx = row[2] - gx0;
    const float dgy = row[3] - gy0;
    const float ivx =
        1.0f / (fabsf(dgx) < kTiny ? (dgx < 0.0f ? -kTiny : kTiny) : dgx);
    const float ivy =
        1.0f / (fabsf(dgy) < kTiny ? (dgy < 0.0f ? -kTiny : kTiny) : dgy);
    const int sx = (dgx > 0.0f) - (dgx < 0.0f);
    const int sy = (dgy > 0.0f) - (dgy < 0.0f);
    int cx = min(max(static_cast<int>(floorf(gx0)), 0), p.nx - 1);
    int cy = min(max(static_cast<int>(floorf(gy0)), 0), p.ny - 1);
    float t_cur = 0.0f;
    for (int it = 0; it < max_steps && t_cur < 1.0f; ++it) {
      const float ex = static_cast<float>(sx > 0 ? cx + 1 : cx);
      const float ey = static_cast<float>(sy > 0 ? cy + 1 : cy);
      const float tx = sx == 0 ? kBig : (ex - gx0) * ivx;
      const float ty = sy == 0 ? kBig : (ey - gy0) * ivy;
      const float tn = tmin(tmin(tx, ty), 1.0f);
      const float frac = tmax(tn - t_cur, 0.0f);
      if (cx >= 0 && cx < p.nx && cy >= 0 && cy < p.ny) {
        const float v = kk * frac;
        if (v != 0.0f) atomicAdd(&p.tally[cy * p.nx + cx], v);
      }
      const bool step_x = (tx <= ty) && (tx < 1.0f);
      const bool step_y = !step_x && (ty < 1.0f);
      cx += step_x ? sx : 0;
      cy += step_y ? sy : 0;
      t_cur = tn;
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes by raster_kernel.py.

extern "C" int nt_raster_params_size() {
  return static_cast<int>(sizeof(RasterParams));
}

// Launches the deposit of the first min(*p->nseg, p->cap) rows on `stream`
// and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int nt_raster_launch(const RasterParams* p, void* stream) {
  if (p->cap <= 0) return 0;
  raster_kernel<<<kBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *p);
  return static_cast<int>(cudaGetLastError());
}
