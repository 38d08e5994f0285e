// The sweep kernel (sweep.cuh; its design is sweep.cu's comment) for a
// state and a tally of different types: a float32 state with a float64
// tally, and a float64 state with a float32 tally, in all 8 (cross-section,
// density, draw) modes x {pitch, edge-array}, the window a runtime
// parameter as in every instantiation.  neutral_tpu keeps the two types
// apart (SimConfig.dtype and tally_dtype) and its TPU kernels take the
// tally's type as their own parameter (pallas_sweep.py's tally_dtype_arr).
//
// The physics reads no tally: every event is the working type's, and only
// the flush differs.  It is the plain version's (transport.sweep_core):
// the lane's deposit rounded to the tally's type, times inv_ntotal rounded
// to that type once (the parameters carry it so), then one atomicAdd into
// the tally, skipped when that product is 0.  A float32 state's flush into
// a float64 tally is a float64 product of a float32 value cast up; a
// float64 state's into a float32 tally a float32 product of the rounded
// deposit and a float32 atomicAdd.
//
// These 32 instantiations have their own translation unit, so that nvcc
// compiles them beside sweep.cu's 32 instead of after them (on an H100
// host the library's build from nothing takes 24-27 s with both in
// sweep.cu, 14-16 s split; `measure.py build --merge`), and their own
// parameter layouts (SweepParamsT<Real, Tally>, Tally != Real) and entry
// points (suffixed _f32t64 and _f64t32).

#include "sweep.cuh"

// Plain C interface, loaded with ctypes by sweep_kernel.py.

extern "C" int nt_params_size_f32t64() {
  return static_cast<int>(sizeof(SweepParams32t64));
}

extern "C" int nt_params_size_f64t32() {
  return static_cast<int>(sizeof(SweepParams64t32));
}

extern "C" int nt_sweep_blocks_per_sm_f32t64(const SweepParams32t64* p,
                                             int* blocks) {
  return blocks_per_sm(p, blocks);
}

extern "C" int nt_sweep_blocks_per_sm_f64t32(const SweepParams64t32* p,
                                             int* blocks) {
  return blocks_per_sm(p, blocks);
}

extern "C" int nt_sweep_launch_f32t64(const SweepParams32t64* p,
                                      void* stream) {
  return launch(p, stream);
}

extern "C" int nt_sweep_launch_f64t32(const SweepParams64t32* p,
                                      void* stream) {
  return launch(p, stream);
}
