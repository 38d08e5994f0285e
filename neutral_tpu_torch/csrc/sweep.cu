// Fused event sweep for NVIDIA Hopper (sm_90a): persistent threads that
// run one particle lane at a time and refill from a work list.
//
// Replaces the TPU kernel neutral_tpu/pallas_sweep.py::_kernel (:59; its
// pl.pallas_call is at :293, launched by pallas_multi_sweep and looped by
// pallas_sweep_chunk).  That kernel advanced a VMEM-resident block of lanes
// through K masked events of transport.sweep_core and pushed tally flushes
// into per-lane rings, because the TPU has no fast scatter or atomics.  Here
// a thread owns one lane at a time: it loads the lane's state into
// registers, runs events until the particle dies, reaches census
// (dt_to_census <= 0), leaves the window or has run `max_events` events in
// this launch, writes the state back and takes the next lane.  Tally
// flushes (facet, census, death) go straight into the tally with
// atomicAdd(float*) or atomicAdd(double*); zero contributions skip the
// atomic.  Rings, pause gating, ring drains and the all-dead block
// early-out have no counterpart.
//
// Each event is the plain version's (neutral_tpu_torch/transport.py
// sweep_core) operations in the same order, with the same constants.
// The build passes -fmad=false: nvcc would otherwise contract a*b+c into
// fused multiply-adds, which PyTorch's one-operation-per-kernel arithmetic
// does not do, and branch decisions would drift from the plain version.
// The working type is a template parameter: float32, where positions on a
// uniform mesh are cell-local (transport.use_local_coords: a facet crossing
// re-bases them onto the new cell), or float64, where they are global, as
// in neutral_tpu's XLA float64 engine (transport.py sweep_chunk, :506): a
// cell's facet edges are cx * dx and (cx + 1) * dx, computed per event from
// its global cell, and a crossing changes only the cell.  The deck's modes
// are template parameters too (common.cuh), one instantiation per
// combination and working type, chosen at launch:
//
//   * facet edges (EdgeMode): from the uniform pitch as above, or, for a
//     geometry without one (a non-uniform mesh, a fast_math 0 deck), read
//     from the whole mesh's edge arrays edgex (global_nx + 1,) and edgey
//     (global_ny + 1,) in the working type by global cell, with the plain
//     version's clamps (transport._facet_edges, neutral_tpu's gather
//     branch, transport.py:187-205): edgex[clamp(cx + 1, 0, gnx)] above,
//     edgex[clamp(cx, 0, gnx - 1)] - kObc below.  Positions are then global
//     in both working types, as transport.use_local_coords keeps them
//     without a pitch.  Each event reads the two bounds its direction
//     needs (edge_above/edge_below) with __ldg: a 4000^2 mesh's arrays are
//     16 KiB each in float32 and 32 KiB in float64, resident in L1 and
//     L2, and no register carries them between events (the float64
//     instantiations already take 80-96);
//   * cross-sections: the analytic resonance formula, or a stored table
//     (table mode, for user .cs files) searched through its coarse index,
//     which each persistent block copies into shared memory once per
//     launch (common.cuh table_lookup);
//   * density: the region rectangles, an (R, 4) int32 bounds array and an
//     (R,) density array in the working type on the device, scanned in
//     order (later regions override earlier ones; any R), or a per-cell
//     grid (grid mode, density_file decks).  Grid mode reads
//     density[flat_cell] of the cell the event starts in, so the whole
//     event uses that cell's material, as in the reference; neutral_tpu's
//     carried density, stale freeze and refresh gather
//     (pallas_sweep.py:120-145) are TPU mechanisms with no counterpart
//     here;
//   * draws: threefry or pcg64si.
//
// Every combination is instantiated: 32 in all, {analytic, table} x
// {regions, grid} x {threefry, pcg64si} x {pitch, array} x {float32,
// float64}, each with a tally of the state's type, and as many with a
// tally of the other type (sweep_mixed.cu).  Each array-mode combination
// is one a deck reaches: a non-uniform mesh under fast_math takes either
// cross-section mode over regions, and with a density_file either over a
// grid; a fast_math 0 deck, on any mesh, takes the table mode over a grid.
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
// The work list.  Histories differ in length, and a warp runs as long as
// its longest lane, so one thread per lane in pid order idles the slots of
// the lanes that end early (and, under a window, of every lane outside
// it).  So the grid is persistent: the host sizes it to fill the card once
// (nt_sweep_blocks_per_sm x SMs, capped by the list), thread t starts at
// list position t, and a thread whose lane is done takes the next position
// from a cursor (counts[3]) by one warp-aggregated atomicAdd for the
// threads of its warp that need work.  A fetched lane that is dead, at
// census or outside the window is skipped at load.  The list is `active`
// (lane t itself when it is null, as in a census's first launch); a lane
// that used up `max_events` and still works appends its index to `next`
// (one warp-aggregated atomicAdd on counts[2], whose value is then the next
// list's length, which the host reads each launch anyway).  Lanes are read
// and written at their own index; no field is permuted.  An event costs the
// warp one ballot (did a lane finish?); the refill runs only after one did.
// counts[4] and counts[5] count the lanes' events and the warps' event
// steps, so that counts[4] / (32 counts[5]) is the share of the thread
// slots that ran events.
//
// Per collision, the lane's cross-sections and speed are looked up once, at
// the energy the collision leaves (collide, common.cuh), and kept in
// registers; the analytic lookup reads its keys and values from a grid
// instead of dividing; and the two draws of a collision are computed side
// by side from key words hoisted out of the event loop.
//
// The wrapper (sweep_kernel.py) rejects everything else.
//
// The float64 instantiations are the float32 design with doubles: the
// carried state, cross-sections and speed take 80-96 registers against
// float32's 56-64 (ptxas's report is in the build log; 5 or 6 blocks an
// SM), and the wrapper sizes their grid by the occupancy the library
// reports for them (nt_sweep_blocks_per_sm_f64).  Their tables' coarse
// indexes take 8 bytes an entry in shared memory.  The kernel's text keeps
// the float32 instantiations' code as it was: what differs by type goes
// through functions (edge_hi/edge_lo, the tables' float64 overloads in
// common.cuh) and `if constexpr`, not through locals of the kernel, which
// changed ptxas's register allocation (`measure.py kernels` compares the
// SASS of two checkouts).
//
// The tally has a type of its own, a template parameter (Tally) beside the
// working type, as in neutral_tpu (SimConfig.tally_dtype): the flush
// rounds the lane's deposit to it and multiplies by inv_ntotal in it
// (transport.sweep_core's form), and nothing else reads it.  This file
// instantiates the kernel template (sweep.cuh) with the tally of the state's
// type, which compiles to the code it had before the tally had a type of its
// own (the casts are no operations, the layouts unchanged); sweep_mixed.cu
// instantiates the other 32, a float32 state with a float64 tally and a
// float64 state with a float32 tally.
//
// What bounds it on the H100 (an NVIDIA H100 80GB HBM3 at 700 W; PERF.md
// §6, measure.py census): ptxas gives the main instantiation (analytic,
// regions, threefry) 56 registers and 8 bytes of spill, so an SM holds 9
// blocks of 128 threads and the grid is 1,188 blocks.  At 10M lanes its
// threads ran events in 99.3% of their slots (one thread per lane in pid
// order: 90.5%), at 1M in 93-94% (the last lanes start when the list is
// used up and end one history later), in the window mode 88% (pid order:
// 23%).  The 10M census takes ~177 ms against the 133.7 ms that
// Threefry-2x64-20's integer work alone needs (two draws a collision):
// what is left is each collision's float work (about ten IEEE divisions,
// six square roots and a logarithm under -fmad=false) and its lookup.  In
// table mode a lookup's latency chain is a gallop down the coarse index in
// shared memory from the lane's last position, one L2 round trip for the
// keys of its group and one for its packed interval (common.cuh); the
// table instantiations take up to 64 registers, 8 blocks an SM (capped at
// the analytic mode's 56 they spill and run slower).  Under pcg64si the
// float work is the larger part.

#include "sweep.cuh"

// Plain C interface, loaded with ctypes by sweep_kernel.py.

extern "C" int nt_params_size() { return static_cast<int>(sizeof(SweepParams)); }

extern "C" int nt_params_size_f64() {
  return static_cast<int>(sizeof(SweepParams64));
}

extern "C" int nt_sweep_threads() { return kThreads; }


extern "C" int nt_sweep_blocks_per_sm(const SweepParams* p, int* blocks) {
  return blocks_per_sm(p, blocks);
}

extern "C" int nt_sweep_blocks_per_sm_f64(const SweepParams64* p,
                                          int* blocks) {
  return blocks_per_sm(p, blocks);
}

extern "C" int nt_sweep_launch(const SweepParams* p, void* stream) {
  return launch(p, stream);
}

extern "C" int nt_sweep_launch_f64(const SweepParams64* p, void* stream) {
  return launch(p, stream);
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
