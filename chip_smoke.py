#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (neutral_tpu_torch) on one GPU, and
on several where the machine has them.

    python3 chip_smoke.py            # every phase; 30 where there are 2+ cards
    python3 chip_smoke.py --cards    # phases 1-2 and 30 alone (four cards)
    python3 chip_smoke.py --inject   # phases 1-2 and 31 alone

(`python3 chip_smoke.py --process <CLI arguments> [--then <CLI
arguments> ...]` is one process of phases 23 and 30: `python -m
neutral_tpu_torch <CLI arguments>` for each run in turn, its kernels'
launch counts, its launches by card and its cards' peak memory printed
after each.)

Every run of one card through the CLI passes `--device cuda:0`, and the
runs of phases 14 and 23 too: on a machine with several cards they
measure what they measure on one (shards sharing one card, one device),
since the CLI's `--shards` otherwise defaults to one shard per visible
card.

Phases, each printing its own lines; any failure raises and exits non-zero:

1. Device: needs `torch.cuda.is_available()` (no CPU run); prints the
   card's name and `nvidia-smi`'s name and power limit.
2. Build: compiles csrc/*.cu with nvcc (neutral_tpu_torch/build.py), one
   process per source, timed.
3. Sweep kernel against its plain version on the card: the scatter deck's
   geometry and physics (4000^2 mesh, float32) at 65,536, at 1,000,000 and
   at the deck's own 10,000,000 particles (the main path's step-1 state);
   one begin_timestep state goes through the CUDA sweep kernel and through
   the plain PyTorch engine.  Facet and collision totals and all 14
   per-lane state fields must be exactly equal; the tally sums agree to a
   relative 1e-5 (atomics add in another order).  Both times are printed.
   A third kernel run with 64 events per launch must match too (many
   launches per census).  Each size prints the kernel's persistent grid
   and the share of its thread slots that ran events (its counters),
   beside the share that one thread per lane in pid order would fill (the
   kernel's layout before its work list; from each lane's draws, its
   counter's delta); phase 3 prints the main instantiation's registers.
4. Main path, scatter: `driver.main(["problems/scatter.params"])` in-process
   at full size (10M particles, 4000^2, 2 steps).  It must print `PASSED
   validation.`, the sweep kernel must have launched, and no plain version
   may have run.
5. Flight kernel against its plain version (flight_chunk_plain) on the
   card, at the full 1,000,000 particles of stream, split and csp, from one
   begin_timestep state of step 1: facet and collision totals and all 14
   per-lane fields exactly equal, the segment rows equal as multisets
   (bitwise, after sorting: atomics append them in another order), tally
   sums to a relative 1e-5.  Again with one piece per launch (many launches
   per census), and again under a forced-small segment buffer (SMALL_ROWS
   rows, grown up to SMALL_MAX), which refuses rows in many rounds: both
   equal to the plain version in the same way, printing their rounds and
   refusals; the small buffer's tally also per cell to 1e-5 of the
   largest cell.  Both times are printed.
6. Segment-deposit kernel against its plain version (per-cell largest
   difference to 1e-5 of the largest cell, sums to 1e-5) on the segment
   rows of the step-1 censuses of phase 5 (stream, split, csp; 4000^2
   tally) and, after phase 13, on its window-local rows (split and stream
   in the 2000^2 block tally).  Each prints the kernel's stage times (bins,
   tile deposit) from CUDA events, its pieces, the pieces per tile (largest
   and mean over the tiles with any), T and C.
7. Main path, flight decks: `driver.main` on the full stream and split
   decks (each must print `PASSED validation.`) and csp (10 steps; its
   shipped golden is a known outlier that the reference's own omp3 misses,
   so it prints FAILED against it and is held here to omp3's converged
   tally, 1.1201464e7, within 1e-3).  The flight and segment-deposit
   kernels must have launched in every run, and no plain version may have
   run.  Events/s per step, the flight launches per step with the lanes
   each launch covered (first, median, last: the census tail), peak device
   memory and the deposit's overflow re-runs (its piece buffer grows in a
   run's first round) are printed.
8. pcg64si: copies of the decks with `rng pcg64si` in a temporary
   directory (each keeps its basename, so that the golden is found in
   problems/neutral_pcg.tests).  The sweep kernel against its plain
   version on scatter, and the flight kernel on stream and split, at
   1,000,000 particles, exactly as in phases 3 and 5; then all four decks
   at full size through `driver.main`, each printing `PASSED validation.`
   against its pcg64si golden (made by the native engine, so csp has no
   outlier exception here).
9. Table mode: copies of scatter and split beside `elastic_scatter.cs` and
   `capture.cs`, the resonance formula resampled at 30,000 log-spaced
   energies (xs.resonance_log_table: not on the quartic grid, 4.3e-8 from
   the generated table over 1 eV - 1 MeV).  Sweep kernel on scatter and
   flight kernel on split against their plain versions at 1M; both decks
   at full size through `driver.main`, `PASSED validation.`, with their
   sweep and flight launches (which run the table lookup inside) and
   lookups counted.  The same two comparisons with a second, 3,001-entry
   capture table (same_xs false: the absorb lookup and both coarse
   indexes).  Then the lookup kernel alone (csrc/table.cu, the device
   function of both kernels' table mode): on the 30,000-entry table at
   the 1M end-state energies of the scatter comparison (and those ten
   times over, 10M) and at 1M and 10M log-uniform ones, and on
   table_kernel's probe tables (the 30,000-entry one; 2, 3, 2,047-2,049,
   4,097, 32,768 and 131,069 entries; runs of equal keys across the
   coarse index's entries) at every key, one ulp either side, both ends,
   0, +-inf and NaN besides 1M log-uniform ones: its indices bitwise the
   plain two-level search's (xs.TableLayout.index) and
   torch.searchsorted's, its values bitwise TableLayout.lookup's and
   CrossSection.lookup's; its device time (LOOKUP_REPS calls in one CUDA
   graph) beside the plain version's, the library's (CrossSection.lookup:
   torch.searchsorted, the gathers and the interpolation, timed alike)
   and its bound.
10. Grid mode: the sweep kernel against its plain version at 1M on the
   scatter deck with a random 4000^2 density grid with 25% vacuum cells;
   then the scatter deck with its own density as `density_file` at full
   size through `driver.main`: `PASSED validation.`, and per-step facet
   and collision counts equal to phase 4's region run.
   Every main path of phases 8-10 must show kernel launches and no plain
   run, as phases 4 and 7 do.
11. (Phase numbers 12-15 follow the slice that added them.)
12. Window mode of the sweep kernel: the sweep kernel against its windowed
   plain version at 1,000,000 scatter particles in the 2x2 block
   [2000, 4000)^2 that the source box straddles (window-local tally):
   counts and all 14 fields equal, lanes outside the window bitwise
   untouched, tally sums to 1e-5; again with 64 events per launch.
13. Window mode of the flight kernel: the same on split and stream at
   1,000,000 particles, with the sorted window-local segment rows bitwise
   equal.
14. Decomposed main paths, four shards on the one card through
   `driver.main --shards 4 --decomposition ...`: the full scatter deck
   under replicated, spatial (4 y-slabs) and spatial2d (2x2 blocks), each
   `PASSED validation.` with per-step counts equal to phase 4's; stream,
   split and csp under spatial2d (stream and split `PASSED`, csp within
   1e-3 of omp3's tally) with per-step counts equal to single-device
   kernel runs over `flight.split_rects(rects, [2000], [2000])`; the
   pcg64si split deck and the grid scatter deck under spatial, `PASSED`.
   Each with its launch counts (kernels launched, no plain version),
   events/s and lanes migrated per step and peak device memory.
15. The unwindowed scatter census at 10,000,000 particles timed 5 times
   (`neutral_tpu_torch/measure.py census` compares two checkouts in one
   run, in every mode).
16. Split at BIG_N = 64,000,000 particles, one step through `Simulation`
   (an n x 64-row segment buffer would have needed ~82 GB): its first
   1,000,000 lanes must equal a 1,000,000-particle run's end state bitwise
   in all 14 fields (injection and draws are keyed by pid), and its tally
   sum lie within 1e-2 of split's golden (a sanity bound); prints events/s
   and peak device memory.
17. The analytic grid: the (key, value) pairs that the kernels' analytic
   lookup reads (CrossSection.analytic_grid_in of the scatter deck's table,
   made on the card) must equal CrossSection._key_at/_val_at evaluated on
   the CPU at every index, bitwise: the CPU tests prove the lookup through
   that grid bitwise equal to the plain lookup.
18. Decks without a pitch on the kernels: the sweep kernel's edge-array
   mode (facet edges read from the mesh's edge arrays by global cell,
   positions global) and the begin kernel.  Copies of the scatter deck
   (4000^2) in every edge-array instantiation, in float32 and float64:
   with `mesh_stretch_x 1.0002` and `mesh_stretch_y 0.9998` (STRETCH:
   cell widths from 0.45x to 2.2x of the uniform pitch) over its regions,
   the same beside the 30,000-entry `.cs` tables and over phase 10's random
   density grid, and with `fast_math 0` (the region-built grid and the
   stored resonance table), each also under pcg64si.  The sweep kernel
   against its plain version on step 1's census (NO_PITCH_MAIN_N =
   1,000,000 particles for the stretched deck, F64_MODE_N = 2^18 for the
   rest): counts and all 14 fields bitwise in both working types, again at
   64 events per launch; the begin kernel against transport.begin_timestep
   in every one of them at 2^18 and on the stretched deck at 10,000,000, as
   in phase 25.  Then the stretched deck at its own NO_PITCH_N =
   10,000,000 particles and 2 steps through `driver.main` under `--engine
   auto`, in float64 (and again: the same per-step counts, the tally to
   1e-12) and in float32 (its facets printed beside float64's): each must
   print `Engine: kernel.` and `Transport: sweep.`, launch the sweep and
   begin kernels and never a plain version.  Then `tools compare` on the
   card (the plain engine in float64 against the native C++ engine) at
   20,000 particles on the deck cut to 400^2 must print AGREE.
19. fast_math 0 the same way at 10,000,000 particles, float64 and float32;
   its float64 tally within 1e-3 of phase 4's fast_math 1 kernel tally at
   the same particles.  Both decks in float64 on 4 y-slabs and on 2x2
   blocks (`--shards 4 --decomposition spatial|spatial2d`) give the single
   device's per-step counts; so does the stream deck with STRETCH (its own
   1,000,000 particles, float64) on 2x2 blocks, whose lanes migrate (no
   scatter lane crosses a seam).
20. Checkpoint and restore on the kernel path: csp through `driver.main
   --iterations 5 --checkpoint`, then `--restore` on one device and on
   2x2 blocks (`--shards 4 --decomposition spatial2d`).  Steps 1-5 and the
   one-device steps 6-10 must have phase 7's per-step counts, the blocks'
   steps 6-10 those of a one-device run restored from the same checkpoint
   over rects split at the blocks' grid lines; both tallies within 1e-3 of
   omp3's.  Prints the npz write and restore times and its size.
21. Dumps and traces: stream with `visit_dump 1` in a temporary directory
   (energy1.dat must sum to the tally, density1.dat to the live count of
   step 1) and split with `--trace-dir` (the Chrome trace must name the
   flight kernel's and the segment deposit's CUDA kernels), each beside
   the same run without, for their cost.
22. The oracle on the card: the port's plain engine (asked for by name:
   `auto` takes the float64 kernel on the sweep transport) in float64 on
   the card,
   on both transports, against the port's sequential oracle
   (neutral_tpu_torch/oracle.py, float64 on the host, no JAX) on the four
   deck families of tests/test_transport.py (48^2, 25-40 particles, 1-3
   steps; csp cut from 4 to 3, the first two of which have no collision,
   to bound the plain engine's time): per-step facet, collision and processed counts equal, dead
   flags equal, the tally per cell to 1e-9 on the sweep transport (on the
   flight transport, which deposits whole segments, its sum to 1e-11 and
   each cell to 1e-7, as tests/test_flight.py holds JAX's).
23. Two processes sharing the card, which run every run of MP_RUNS in
   turn, each as `python -m neutral_tpu_torch <deck> --shards 4
   --decomposition D --coordinator 127.0.0.1:<free port> --num-processes
   2 --process-id r` (through `--process`; the process group of the first
   run serves the others), 2 shards each on cuda:0, at full size on the
   kernel engine: scatter replicated and on 2x2
   blocks, stream and csp on 2x2 blocks.  Each must print `Distributed:
   2 processes, 4 shards.`, `PASSED validation.` (csp: within 1e-3 of
   omp3's tally) and phase 14's per-step counts of the same deck and
   layout; both processes must have launched the kernels and no plain
   version.  Prints each run's step times beside phase 14's, its
   exchange time and the lanes sent between the processes per step.
   Both processes have a timeout (MP_TIMEOUT), after which both are
   killed.
24. Lanes below 1e-2 eV, the resonance table's lowest key, where the
   closed-form index's root is NaN and converts to index 0: phase 22's
   scatter family born at 5e-3 eV (every lane below) and at 1.01e-2 eV
   (lanes cross in their first scatters), each in a deck file at
   MODE_N = 1,000,000 particles.  The sweep kernel against its plain
   version on the card in float32, as in phase 3 (counts and all 14
   fields bitwise, again at 1 event per launch: a lane here ends within a
   few events, so 64 would take the census in one launch), printing the lanes
   that ended below 1e-2 eV; the deck through `driver.main` (the sweep
   kernel launched, no plain version, step 1's counts equal to the
   comparison's); and, at the family's 30 particles, the plain engine in
   float64 on the card against the oracle as in phase 22, on both
   transports.  Each must show lanes below 1e-2 eV.
25. The begin kernel (csrc/begin.cu, begin_kernel.begin_timestep_kernel)
   against transport.begin_timestep on the card: scatter at its
   10,000,000 particles; stream, split and csp, the four decks under
   pcg64si, scatter and split with the 30,000-entry tables, scatter on
   phase 10's random grid (25% vacuum cells, where the mean free path is
   inf), the scatter and split windows of phases 12-13 and phase 24's two
   low-energy decks, each at 1,000,000.  On step 1's state and on a copy
   with a seeded quarter of its lanes dead and its clocks, mean free paths
   and counters scrambled, all 14 fields bitwise and the live count equal
   to (~dead).sum(), the caller's state unchanged.  Prints each mode's
   device time (BEGIN_REPS calls in one CUDA graph), one call on the
   clock, the plain version's time and the bound.
   Every main path (phases 4, 7-10, 14 and 18-24, and each process of
   phase 23) must have started each census of each shard once: the begin
   kernel on the kernel engine and never transport.begin_timestep (which
   counts its calls), the plain version on the plain engine and never the
   kernel.  Each must have injected as phase 31 says.
26. float64 on the card's kernels (the float64 instantiations of the sweep,
   begin and lookup kernels, global coordinates; `auto` routes float64
   decks there, JAX's is_f32 rule sending them to the sweep transport):
   the sweep kernel against its plain float64 version on step 1's census
   in each of its 8 instantiations, the window and phase 24's crossing
   deck (F64_MAIN_N = 1M for analytic/threefry, F64_MODE_N = 2^18 for the
   rest): counts and all 14 fields bitwise, tally sums to 1e-12; the
   lookup kernel alone in float64 on the table census's energies and
   log-uniform ones; the begin kernel in float64 in every mode of phase
   25, bitwise; then through `driver.main --dtype float64`: scatter at 10M
   (`PASSED validation.`), stream and split (`PASSED`) and csp (within
   1e-3 of omp3's tally) under auto on the sweep kernel (stream's facets
   and step time printed), the table scatter (`PASSED`), scatter on 4
   y-slabs (per-step counts equal to the single device's); each with
   sweep and begin kernel launches and no plain sweep or begin.  One
   full-size float64 step of stream, split and csp on the float64 flight
   kernels (`--transport flight`) beside the float64 sweep kernel (auto's
   choice, JAX's is_f32 rule), timed, and phase 22's families on the
   float64 kernels of both transports against the oracle, each with its
   counts set to 0 just before its steps and read after: its transport's
   kernels, one begin launch a step, no plain version (reported apart
   from the main paths' launches, as oracle_family_launches).  Prints its
   seconds.
28. float64 on the flight transport's kernels (the float64
   instantiations of the flight and segment-deposit kernels, global
   coordinates; float64 rows into a float64 tally at the float64 T):
   ptxas's registers and spills of the float64 instantiations of both
   kernels (and of the float32 flight ones); the flight kernel against
   flight_chunk_plain in float64 on step 1's census at the full
   F64_MAIN_N = 1,000,000 of stream, split and csp (analytic, threefry),
   again at 1 piece a launch and under phase 5's forced-small segment
   buffer, and at F64_MODE_N = 2^18 in pcg64si, table and table pcg64si
   (split copies) and in the window (split and stream in the 2x2 block):
   counts and all 14 fields bitwise, segment rows bitwise as sorted
   multisets, tally sums to 1e-12 (the small buffer's tally per cell to
   1e-12 of the largest cell); the deposit against its plain version on
   the rows of the analytic and window comparisons, per cell to 1e-12 of
   the largest cell, with its stage times, T, C and the tile kernel's
   blocks an SM; then `driver.main --transport flight --dtype float64` on
   stream and split (`PASSED validation.`), csp (within 1e-3 of omp3's
   tally) and stream on 2x2 blocks (the single device's per-step counts),
   each launching the float64 flight, deposit and begin kernels and no
   plain version or sweep kernel.  Prints its seconds.  (Phase 28 runs
   after phase 26; Result stays the last.)
29. A state and a tally of different types (MIXED_PAIRS: a float32 state
   with a float64 tally, a float64 state with a float32 tally; the mixed
   instantiations of csrc/sweep_mixed.cu, csrc/flight.cu and
   csrc/raster.cu): per pair, ptxas's registers and spills of its sweep,
   flight and deposit instantiations; the sweep kernel against its plain
   version in all 16 of its instantiations (8 modes on the uniform pitch,
   8 in edge-array mode on the stretched mesh), the flight kernel in all
   4 (stream and split analytic, split under pcg64si, table and table
   pcg64si; split analytic again under the forced-small segment buffer)
   and the deposit on the stream and split rows into a tally of the
   tally's type: counts, all 14 fields and the segment rows bitwise, the
   tally's sums and each of its cells against the largest cell to 1e-12
   (a float64 tally) or 1e-5 (a float32 one).  The mains (MIXED_MAIN:
   analytic regions threefry on the pitch, stream and split analytic, and
   the deposit of stream's rows) run F64_MAIN_N = 1M lanes, as phases 26
   and 28; every other census MIXED_N = 2^18 lanes born at MIXED_E0 = 1.5
   eV (the deck's at 1e3-2.5e4 eV): a history ends when an absorption
   finds it below 1 eV, so these run ~80 collisions a lane, not ~700, and
   their plain versions seconds, not minutes.  Then through
   driver.make_simulation under auto, full size: scatter (10M, 2 steps)
   in both pairs on the sweep kernel; stream, split and csp (1M) with a
   float32 state on the flight kernels and with a float64 state on the
   sweep kernel; stream with a float64 state on the flight kernels by
   name; scatter on 4 y-slabs and stream on 2x2 blocks sharing the card,
   in both pairs.  Each with every count set to 0 just before and read
   after: its transport's kernels and the begin kernel launched, no plain
   version (the plain sweep, flight, deposit and begin counters at 0); its
   tally of the tally's type within 1e-3 of the golden (csp: omp3's); its
   per-step counts equal to those of the earlier phase's run of the same
   deck whose tally is of the state's type (the physics reads no tally),
   with both step times printed; a decomposed run's counts equal to the
   single device's (over rects split at the blocks' walls on the flight
   transport).  Prints its seconds.
31. The inject kernel (csrc/inject.cu, inject_kernel.inject_particles_kernel)
   against particles.inject_particles on the card, in float32 and
   float64: the scatter deck at its 10,000,000 particles (the cell-local
   frame in float32), csp and stream at their 1,000,000, scatter at
   1,000,000, a pcg64si copy of stream and a stretched copy of scatter at
   1,000,000 (no pitch: the edge search, the global frame), each on the
   mesh and source box Simulation gives it: all 14 fields bitwise, one
   counted launch.  Prints each mode's device time (INJECT_REPS calls in
   one CUDA graph), one call on the clock, the plain version's time and
   the bound.  Every main path (and phase 29's, and each process of
   phases 23 and 30) must have injected each of its shards once (a single
   device's Simulation: one): by one inject kernel launch on the kernel
   engine, a decomposition's shard with its vector of pids, and never
   inject_particles (which counts its calls), by inject_particles on the
   plain engine and never the kernel.
30. Several cards (when torch.cuda.device_count() >= 2; the 4x1 and 2x2
   layouts need four, and on fewer phase 30 prints so and does not try
   them; on one card it prints one line saying it needs several): first
   the single-card references on cuda:0 through `driver.main`, scatter
   (10M, 2 steps), stream, split and csp (1M), scatter in float64, and
   stream, split and csp over rects split at the 2x2 blocks' walls
   (`split_single_counts`); then, with the kernel engine throughout:
   1xN, one process over the N cards (`--device cuda --shards 4`, the
   shards on the cards in turn): scatter under all three decompositions,
   stream, split and csp under replicated and spatial2d, and scatter in
   float64 replicated; 4x1 over NCCL, four processes with a card each
   (`--device cuda`, through `--process`): phase 23's MP_RUNS; 2x2: two
   processes with two cards each, scatter on 2x2 blocks with every card
   visible to both (each takes a block of two) and stream on 2x2 blocks
   with CUDA_VISIBLE_DEVICES giving each its own two.  Each run must
   give its single-card reference's per-step counts exactly (a spatial2d
   flight run: the split-rect run's) and pass its golden (csp: within
   1e-3 of omp3's tally); its layout line must name its cards, its
   processes must print `Process group: nccl`, and every card must have
   launched the begin kernel and its transport's kernels (counted by card,
   the wrappers' `cards`), with no plain version.  Prints each run's step
   times beside the single card's and, where phase 14 ran in this
   invocation, beside its four shards on one card, its migrate and
   exchange phases, the lanes that crossed between processes and each
   card's peak memory.  The processes of each layout have CARDS_TIMEOUT
   seconds.
27. Result: a JSON line on the kernels (each with its bound, and the times
   of every mode it ran; the float64 instantiations as sweep_kernel_f64,
   table_lookup_f64, begin_kernel_f64, flight_kernel_f64 and
   segment_deposit_kernel_f64 beside the float32 entries, the sweep
   kernel's edge-array mode as sweep_kernel_edge_array and
   sweep_kernel_edge_array_f64, the begin kernel's no-pitch comparisons in
   its entries' no_pitch_modes, the mixed pairs' as sweep_kernel_f32t64,
   flight_kernel_f32t64, segment_deposit_kernel_f32t64 and their _f64t32
   twins, the inject kernel as inject_kernel and inject_kernel_f64; with
   phase 30, the main kernels' `launches_on_cards`: each
   phase 30 run's launches by card), then the JSON result line.  With
   `--cards`, a JSON line of phase 30's runs (launches by card, step
   times, peak memory by card) stands in place of the kernels line; with
   `--inject`, the kernels line holds the inject kernel's entries alone.

Each kernel's `bound_ms` is the least time the card could take for the
work this run gave it: the larger of the bytes it must move (each lane's
state read once and written once, each segment row written by the flight
kernel or read by the deposit once, each tally written once) over 3.35
TB/s, and its operations over the peak rate of their type: the draws'
integer operations (threefry-2x64/20 about 160 a draw, pcg64si about 30,
two draws a collision) over the H100's int32 issue rate (132 SMs x 64
lanes x 1.98 GHz), the float work (about 60 operations an event or flight
piece, 40 more a collision, 15 a cell visited by a segment deposit; pieces
counted as at least one a collision and one a lane) over 67 TFLOP/s.  In
float64 (phase 26) a lane moves 186 bytes and a tally cell 8, and the
float work is counted in FP64 instructions (F64_EVENT_OPS and
F64_COLLISION_OPS, each IEEE division, square root and logarithm weighed
by its SASS sequence, F64_SEQUENCES) over the card's FP64 issue rate
(132 SMs x 64 lanes x 1.98 GHz, the data sheet's 34 TFLOP/s with an FMA
counted once).  The float64 flight kernel's bound (phase 28) counts the
same way, with 40 bytes a segment row; the float64 deposit's reads 40
bytes a row, writes 8 a tally cell and does FLOPS_VISIT FP64 instructions a
cell visited and a row's two reciprocals.  A deck without a
pitch adds its two edge arrays, read once.  A tally of its own type (phase
29) counts its cells at 4 or 8 bytes by that type, the rest as the state's
type; a deposit walks in the rows' type (FP64 instructions for float64
rows).  The
flight kernel's `ms` is its own device time (CUDA events), without the
segment deposits, whose time stands beside it; its entry also holds csp's
own time and bound over all 10 steps of its main path and the launches of
each flight main path.  No single PyTorch call
computes any of the three kernels' functions, so their `library_ms` is
null.  The table lookup's entry is the lookup kernel alone (phase 9) at
the main path's shape (1M census energies, the 30,000-entry table); its
`ms` and `library_ms` (CrossSection.lookup: torch.searchsorted, the
gathers and the interpolation) are device times, LOOKUP_REPS calls
captured in one CUDA graph, so that no host work between launches is
timed; its bound is what the function must move, its energies read and
values written once and the table's keys and values read once, beside
the interpolation's float operations: no search steps, since a bucketed
index could find an interval in O(1).  Its `launches` are those of the
sweep and flight kernels on the table main paths, which run the lookup
inside (`fused_launches` splits them); the lookup kernel alone never runs
on a main path.  In table mode the sweep and flight kernels' bounds add
their tables' keys and values, read once, and nothing for the searches.
No roofline sees the lookup's chain of dependent loads.  The begin
kernel's bound: 37 bytes a lane (dead, cells, energy and pid read;
clock, mean free path and counter written), 4 more a dead lane (its old
mean free path, which a live lane's draw replaces), the scatter
table's keys and values in table mode, and a live lane's pair draw and
12 float operations; its `ms` is device time as the lookup's is, and no
PyTorch call computes its function (`library_ms` null).  The inject
kernel's bound: a lane's 14 fields written once (61 bytes in float32, 97
in float64), the edge arrays read once on a mesh without a pitch, and two
pair draws a lane; its float work (the mapping, the cell, cos and sin) is
not counted.  Its `ms` is device time as the begin kernel's is.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

SCATTER = "problems/scatter.params"
COMPARE_SIZES = (65_536, 1_000_000, 10_000_000)
FLIGHT_DECKS = ("problems/stream.params", "problems/split.params",
                "problems/csp.params")
CSP_OMP3_TALLY = 1.1201464e7     # omp3's converged csp tally (BASELINE.md)
MODE_N = 1_000_000               # particles of the phase 8-10 comparisons
BLOCK = (2000, 2000, 2000, 2000)  # (x_off, y_off, nx, ny) of phases 12-13
SHARDS = ["--shards", "4", "--decomposition"]
SMALL_ROWS, SMALL_MAX = 1024, 16384   # phase 5's forced-small segment buffer
BIG_N = 64_000_000               # phase 16's split particles
NO_PITCH_N = 10_000_000          # phases 18-19's main paths (the deck's)
NO_PITCH_MAIN_N = 1_000_000      # phases 18-19's stretched comparison
STRETCH = "mesh_stretch_x 1.0002\nmesh_stretch_y 0.9998\n"
TRACE_KERNELS = ("flight_kernel", "tile_kernel")   # phase 21's symbols
# Phase 22: tests/test_transport.py's families (density, x, y, w, h) regions
ORACLE_DECKS = {
    "scatter": dict(problems=((1.0e4, 0, 0, 1, 1),), initial_energy=1.0e3,
                    nparticles=30, niters=2, source=(0.2, 0.2, 0.6, 0.6)),
    "stream": dict(problems=((1.0e-30, 0, 0, 1, 1),), initial_energy=1.0e6,
                   nparticles=40, niters=1, source=(0.45, 0.45, 0.1, 0.1)),
    # csp's family runs 3 of its 4 steps: collisions start in step 3.
    "csp": dict(problems=((1.0e-30, 0, 0, 1, 1), (1.0e4, 0.4, 0.4, 0.2, 0.2)),
                initial_energy=1.0e4, nparticles=25, niters=3,
                source=(0.1, 0.1, 0.2, 0.2)),
    "split": dict(problems=((1.0e-30, 0.0, 0.0, 1.0, 0.5),
                            (1.0e3, 0.0, 0.5, 1.0, 0.5)),
                  initial_energy=2.5e4, nparticles=25, niters=1,
                  source=(0.4, 0.4, 0.2, 0.2)),
}
# Phase 23: (name, deck, decomposition) over two processes, 4 shards.
MP_RUNS = (("scatter", SCATTER, "replicated"),
           ("scatter", SCATTER, "spatial2d"),
           ("stream", FLIGHT_DECKS[0], "spatial2d"),
           ("csp", FLIGHT_DECKS[2], "spatial2d"))
MP_TIMEOUT = 300                 # seconds phase 23's processes may take
# Phase 30: several cards.  The single-card references (name, deck, CLI
# arguments), the 1xN runs (name, deck, decomposition, arguments) and the
# 2x2 runs (name, deck, decomposition): every card visible to both
# processes, then each process with its own two (CUDA_VISIBLE_DEVICES).
CARD_DECKS = (("scatter", SCATTER, ()), ("stream", FLIGHT_DECKS[0], ()),
              ("split", FLIGHT_DECKS[1], ()), ("csp", FLIGHT_DECKS[2], ()),
              ("f64 scatter", SCATTER, ("--dtype", "float64")))
CARDS_1XN = tuple(
    [("scatter", SCATTER, d, ()) for d in ("replicated", "spatial",
                                            "spatial2d")]
    + [(deck.split("/")[-1].split(".")[0], deck, d, ())
       for deck in FLIGHT_DECKS for d in ("replicated", "spatial2d")]
    + [("f64 scatter", SCATTER, "replicated", ("--dtype", "float64"))])
CARDS_2X2 = (("scatter", SCATTER, "spatial2d"),
             ("stream", FLIGHT_DECKS[0], "spatial2d"))
CARDS_TIMEOUT = 400              # seconds phase 30's processes may take
# Phase 24: phase 22's scatter family born below and just above 1e-2 eV.
THRESHOLD = 1.0e-2               # the resonance table's lowest key, eV
LOW_ENERGY = {"born 5e-3": 5.0e-3, "crossing 1.01e-2": 1.01e-2}

# The card's peaks (NVIDIA's H100 SXM data sheet and Hopper white paper).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_I32 = 132 * 64 * 1.98e9
# float64 outside the tensor cores: 34 TFLOP/s on the data sheet, 64 FP64
# lanes an SM a clock: as instructions (an FMA one), 132 x 64 x 1.98 GHz.
PEAK_F64_INSTR = 132 * 64 * 1.98e9
LANE_BYTES = 61 + 53             # 14 fields read, 13 written (not pid)
LANE_BYTES_F64 = 97 + 89         # the same in float64 (9 floats of 8)
DRAW_OPS = {"threefry": 160, "pcg64si": 30}
FLOPS_EVENT, FLOPS_COLLISION, FLOPS_VISIT = 60, 40, 15
FLOPS_INTERPOLATE = 6            # one interpolation of a table lookup
LOOKUP_REPS = 20                 # timed calls of a standalone lookup
# The begin kernel: a lane reads dead 1, cellx 4, celly 4, energy 4 and
# pid 8 bytes (read whole: a dead lane's entries share their sectors with
# live lanes') and writes dt_to_census 4, mfp 4 and counter 8; a dead lane
# also reads its old mfp (4), which a live lane's draw replaces.  A live
# lane draws one pair and does the interpolation (6), mac_s's three
# products, the logarithm, its negation and the division.
BEGIN_LANE_BYTES = 21 + 16
BEGIN_DEAD_BYTES = 4
FLOPS_BEGIN = FLOPS_INTERPOLATE + 6
BEGIN_REPS = 20                  # timed calls of the begin kernel
# The inject kernel writes a lane's 14 fields once (nine floats, two int32
# cells, the dead flag, pid and counter) and reads nothing but a mesh
# without a pitch's two edge arrays; it makes two pair draws a lane.
INJECT_INT_BYTES = 2 * 4 + 1 + 2 * 8
INJECT_REPS = 20                 # timed calls of the inject kernel
# Phase 26: float64 on the card's kernels.
F64_MAIN_N = 1_000_000           # the analytic, threefry comparison
F64_MODE_N = 1 << 18             # the other modes' comparisons
# Phase 29: a state and a tally of different types.
MIXED_PAIRS = (("float32", "float64"), ("float64", "float32"))
MIXED_N = 1 << 18                # its comparisons' lanes but the mains'
MIXED_E0 = 1.5                   # eV: their lanes' birth but the mains'
MIXED_MAIN = ("analytic regions threefry pitch", "analytic split",
              "analytic stream")   # at F64_MAIN_N lanes, as phases 26, 28
# float64 work of an event and of a collision, in FP64 instructions (an
# FMA one), from the plain version's operations (transport.sweep_core,
# collision_physics) with each IEEE reciprocal, division, square root and
# logarithm counted as the instructions of its sequence in the float64
# sweep kernel's SASS (F64_SEQUENCES): an event's three reciprocals
# (1/mac_t, 1/(omega speed) twice), two divisions and ~30 products and
# sums; a collision's seven divisions, six square roots (two in the
# analytic lookup), one logarithm and ~40 products and sums.
F64_EVENT_OPS = {"rcp": 3, "div": 2, "plain": 30}
F64_COLLISION_OPS = {"div": 7, "sqrt": 6, "log": 1, "plain": 40}


def bound(nbytes: float, int_ops: float, float_ops: float,
          peak_float: float = PEAK_F32) -> dict:
    """bound_ms and bound_by of work that moves `nbytes` and does the given
    integer and float operations (float32 operations over PEAK_F32, or
    FP64 instructions over PEAK_F64_INSTR)."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(int_ops / PEAK_I32, float_ops / peak_float)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def table_bytes(lay) -> int:
    """Bytes of a stored table's keys and values (float32 or float64):
    what a lookup function must read of it, once."""
    return 2 * lay.keys.element_size() * lay.nentries


def table_work(sim, loads: int, collisions: int) -> dict:
    """The table-mode part of a census's work (work_bound) on `sim`'s
    tables: each table's keys and values read once, and the lookups,
    (loads + collisions) a table, counted but bounded by nothing more;
    nothing in analytic mode."""
    if sim.cs_scatter.analytic:
        return {}
    tabs = [sim.cs_scatter] + ([] if sim.geom.same_xs else [sim.cs_absorb])
    return {"lookups": len(tabs) * (loads + collisions),
            "table_bytes": sum(table_bytes(t.table_layout) for t in tabs)}


def f64_ops(counts: dict) -> float:
    """FP64 instructions of an operation count (F64_EVENT_OPS,
    F64_COLLISION_OPS) with each division, square root and logarithm
    weighted by its SASS sequence (F64_SEQUENCES)."""
    return sum(n * F64_SEQUENCES.get(op, 1) for op, n in counts.items())


# FP64 instructions (DFMA, DMUL, DADD, MUFU.RCP64H/RSQ64H) of one IEEE
# reciprocal (MUFU.RCP64H and five DFMA), division (three more), square
# root (MUFU.RSQ64H, four DMUL and four DFMA) and logarithm (libdevice's
# polynomial, about 25) on their fast paths, as the float64 sweep
# kernel's SASS has them (`measure.py kernels --sass FILE`).
F64_SEQUENCES = {"rcp": 6, "div": 9, "sqrt": 9, "log": 25}


def work_bound(r: dict) -> dict:
    """The bound of one comparison's census (compare / compare_flight): its
    lanes, collisions, events or pieces, segment rows and cell visits, in
    table mode its tables and without a pitch its edge arrays (each read
    once); in float64 ("f64" in r) its doubles and its FP64
    instructions; a tally of its own type ("tally_bytes" a cell, phase 29)
    its cells at that size."""
    rows = r.get("rows", 0)
    f64 = r.get("f64", False)
    nbytes = (r["n"] * (LANE_BYTES_F64 if f64 else LANE_BYTES)
              + r["ncells"] * r.get("tally_bytes", 8 if f64 else 4)
              + rows * (40 if f64 else 20)
              + r.get("table_bytes", 0) + r.get("edge_bytes", 0))
    int_ops = r["collisions"] * 2 * DRAW_OPS[r["rng"]]
    events = (r["collisions"] + r["n"] if "rows" in r
              else r["facets"] + r["collisions"])
    if f64:
        return bound(nbytes, int_ops,
                     events * f64_ops(F64_EVENT_OPS)
                     + r["collisions"] * f64_ops(F64_COLLISION_OPS),
                     PEAK_F64_INSTR)
    float_ops = events * FLOPS_EVENT + r["collisions"] * FLOPS_COLLISION
    return bound(nbytes, int_ops, float_ops)


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out = out
        self.buf = io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def bits(torch, t):
    """A float64 tensor's bit patterns (-0.0 differs from 0.0, NaN equals
    itself); a float32 one's likewise; others as they are."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def differing_field(a, b, torch, fields):
    """The first of `fields` in which states a and b differ (bitwise in
    float64, by value in float32 as the earlier phases hold them), or
    None."""
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype == torch.float64:
            x, y = bits(torch, x), bits(torch, y)
        if not torch.equal(x, y):
            return f
    return None


def differing_bits(a, b, torch, fields):
    """The first of `fields` in which states a and b differ bitwise, or
    None."""
    return next((f for f in fields if not torch.equal(
        bits(torch, getattr(a, f)), bits(torch, getattr(b, f)))), None)


def timed(torch, fn, *args, **kw):
    """(milliseconds, result) of fn(*args, **kw), device synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def window_args(torch, transport, sim, start, window):
    """(geom, tally, {x_off, y_off}, lanes outside the window) of a
    comparison in `window` = (x_off, y_off, nx, ny), or of none."""
    import dataclasses
    if window is None:
        return sim.geom, torch.zeros_like(sim.tally), {}, None
    x_off, y_off, nx, ny = window
    geom = dataclasses.replace(sim.geom, nx=nx, ny=ny)
    win = {"x_off": x_off, "y_off": y_off}
    _, _, inside = transport.window_cells(start, geom, **win)
    tally = torch.zeros(nx * ny, dtype=sim.tally.dtype, device="cuda")
    return geom, tally, win, ~inside


def check_outside(torch, name, start, state, outside, fields):
    """Fail unless the lanes outside the window are bitwise untouched."""
    if outside is None:
        return
    if not bool(outside.any()):
        fail(f"{name}: no lane lies outside the window")
    for f in fields:
        if not torch.equal(getattr(state, f)[outside],
                           getattr(start, f)[outside]):
            fail(f"{name}: state.{f} changed outside the window")
    print(f"[{name}] {int(outside.sum())} lanes outside the window "
          "untouched")


def compare(nparticles: int, torch, driver, transport, sweep_kernel,
            fields, deck=SCATTER, label="compare", window=None, events=64,
            dtype="float32", bitwise=False, tally=None, cells=False):
    """Phase 3 at one size (and phases 8-10, 18-19 and 24 on `deck`, phase
    12 in `window`, phase 26 in float64): returns a dict of the kernel's
    and the plain version's times (ms, plain_ms), max_abs_err and the work
    (lanes, cells, counts; a deck without a pitch, its edge arrays' bytes)
    for the bound.

    Besides the timed runs, the kernel runs once more with `events` events
    per launch, so that one census takes many launches; its state must be
    equal too (the main path's census fits in one launch).  In float64, and
    in float32 with `bitwise`, the 14 fields compare bitwise; the tally
    sums to 1e-12 in a float64 tally.  `tally` is the tally's dtype (None:
    `dtype`; phase 29 gives it the other); with `cells` each cell is held
    against the largest cell at the sums' tolerance too."""
    tally = tally or dtype
    cfg = driver.load_config(deck).with_(nparticles=nparticles,
                                         expected_tally=None)
    if (dtype, tally) != (cfg.dtype, cfg.tally_dtype):
        cfg = cfg.with_(dtype=dtype, tally_dtype=tally)
    sim = driver.Simulation(cfg, device="cuda", engine="plain",
                            transport="sweep", quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    geom, tally0, win, outside = window_args(torch, transport, sim, start,
                                             window)
    args = (geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    same = ((lambda a, b: differing_field(a, b, torch, fields)) if not bitwise
            else lambda a, b: differing_bits(a, b, torch, fields))

    def run(fn, **kw):
        state, tally = start.clone(), torch.zeros_like(tally0)
        ms, (state, nf, nc, _) = timed(torch, fn, state, tally, *args,
                                       **win, **kw)
        return ms, state, nf, nc, tally

    loads = int((~start.dead).sum())    # every lane of step 1 is live
    buffers = sweep_kernel.SweepBuffers("cuda")
    run(driver.census.sweep_chunk_kernel, buffers=buffers)         # warm-up
    k_ms, ks, knf, knc, kt = run(driver.census.sweep_chunk_kernel,
                                 buffers=buffers)
    slot_use = buffers.slot_use()
    slot_pid = sweep_kernel.thread_slot_use(ks.counter - start.counter)
    blocks, sms, per_sm = buffers.grid
    p_ms, ps, pnf, pnc, pt = run(sweep_kernel.sweep_chunk_plain)
    print(f"[{label} n={nparticles}] kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms; facets {knf} / {pnf}, collisions {knc} / {pnc}",
          flush=True)
    print(f"[{label} n={nparticles}] grid {blocks} blocks x "
          f"{sweep_kernel.THREADS} threads ({per_sm} per SM, {sms} SMs); "
          f"thread slots that ran events {slot_use:.4f}, against "
          f"{slot_pid:.4f} for one thread per lane in pid order", flush=True)
    if (knf, knc) != (pnf, pnc):
        fail(f"{label} n={nparticles}: event counts differ: kernel {(knf, knc)} "
             f"plain {(pnf, pnc)}")
    if knc == 0:
        fail(f"{label} n={nparticles}: no collisions, the comparison is empty")
    f = same(ks, ps)
    if f is not None:
        n_bad = int((bits(torch, getattr(ks, f))
                     != bits(torch, getattr(ps, f))).sum())
        fail(f"{label} n={nparticles}: state.{f} differs on {n_bad} lanes")
    check_outside(torch, f"{label} n={nparticles}", start, ks, outside,
                  fields)
    ksum, psum = float(kt.double().sum()), float(pt.double().sum())
    max_abs_err = float((kt.double() - pt.double()).abs().max())
    peak = float(pt.double().abs().max())
    rel = abs(ksum - psum) / abs(psum)
    print(f"[{label} n={nparticles}] all {len(fields)} per-lane state fields "
          "equal; tally sums "
          f"{ksum:.9e} / {psum:.9e} (rel {rel:.3e}), max abs err per cell "
          f"{max_abs_err:.3e} (largest cell {peak:.3e})")
    tol = 1e-12 if tally == "float64" else 1e-5
    if not rel <= tol:
        fail(f"{label} n={nparticles}: tally sums differ by {rel:.3e} "
             f"(> {tol})")
    check_cells(f"{label} n={nparticles}", cells, max_abs_err, peak, tol)
    launches0 = driver.census.sweep_chunk_kernel.launches
    _, cs, cnf, cnc, _ = run(driver.census.sweep_chunk_kernel,
                             max_events=events)
    nl = driver.census.sweep_chunk_kernel.launches - launches0
    if nl < 2 or (cnf, cnc) != (pnf, pnc) or same(cs, ps) is not None:
        fail(f"{label} n={nparticles}: the census in {nl} launches of "
             f"{events} events differs from the plain version")
    print(f"[{label} n={nparticles}] {events} events per launch: {nl} "
          "launches, counts and per-lane state equal")
    return {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": max_abs_err,
            "n": nparticles, "ncells": geom.nx * geom.ny, "facets": knf,
            "collisions": knc, "rng": cfg.rng, "grid_blocks": blocks,
            "slot_use": slot_use, "slot_use_pid_order": slot_pid,
            "below_threshold": int((ks.energy < THRESHOLD).sum()),
            "f64": dtype == "float64", "tally_bytes": kt.element_size(),
            **({} if geom.dx else {"edge_bytes": (
                geom.edgex.numel() + geom.edgey.numel())
                * geom.edgex.element_size()}),
            **({} if sim.cs_scatter.analytic else {"energy": ks.energy}),
            **table_work(sim, loads, knc)}


def check_cells(name: str, cells: bool, max_abs_err: float, peak: float,
                tol: float) -> None:
    """With `cells`, fail unless every cell of the kernel's tally is within
    `tol` of the largest cell of the plain version's: a flush into the
    wrong cell keeps the sum, not the cells."""
    if cells and not max_abs_err <= tol * peak:
        fail(f"{name}: a tally cell differs by {max_abs_err:.3e}, more than "
             f"{tol} of the largest cell {peak:.3e}")


def sorted_rows(torch, segs):
    """Segment rows as bit patterns (int32 of float32 rows, int64 of
    float64 ones), sorted lexicographically."""
    rows = torch.cat(segs).contiguous()
    rows = rows.view(torch.int64 if rows.dtype == torch.float64
                     else torch.int32)
    idx = torch.arange(rows.shape[0], device=rows.device)
    for c in reversed(range(rows.shape[1])):
        idx = idx[torch.sort(rows[idx, c], stable=True)[1]]
    return rows[idx]


def cell_visits(torch, rows) -> int:
    """Cells the segment rows cross: |dcx| + |dcy| + 1 each."""
    c = torch.floor(rows[:, :4].double()).long()
    return int(((c[:, 2] - c[:, 0]).abs() + (c[:, 3] - c[:, 1]).abs()
                + 1).sum())


def compare_flight(deck: str, torch, driver, transport, flight,
                   flight_kernel, fields, label="flight", window=None,
                   small=False, dtype="float32", n=MODE_N, tally=None,
                   bitwise=False, cells=False):
    """Phase 5 on one deck (and phases 8-9, phase 13 in `window`, phase 28
    in float64 at `n` particles): returns a dict as compare's, with the
    kernel census's segment rows ("segs") and their count.  "ms" and
    "plain_ms" are the flight pieces' own time (the kernel's from CUDA
    events, the plain version's from the clock), "deposit_ms" and
    "plain_deposit_ms" the segment deposits' and "census_ms" the kernel
    census's whole time.  With `small`, the kernel census runs once more
    under a forced-small segment buffer.  In float64 the 14 fields compare
    bitwise, the tally sums to 1e-12 and the small buffer's tally per cell
    to 1e-12 of the largest cell (in a float64 tally).  `tally` is the
    tally's dtype (None: `dtype`); with `bitwise` float32 fields compare
    bitwise too, and with `cells` each cell of the tally is held against
    the largest cell at the sums' tolerance."""
    tally = tally or dtype
    cfg = driver.load_config(deck).with_(nparticles=n, expected_tally=None)
    if (dtype, tally) != (cfg.dtype, cfg.tally_dtype):
        cfg = cfg.with_(dtype=dtype, tally_dtype=tally)
    sim = driver.Simulation(cfg, device="cuda", engine="plain",
                            transport="flight", quiet=True)
    if dtype == "float32" and driver.auto_transport(cfg) != "flight":
        fail(f"{deck}: auto picks the {driver.auto_transport(cfg)} "
             "transport")
    tol = 1e-12 if tally == "float64" else 1e-5
    same = (differing_bits if bitwise else differing_field)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    geom, tally0, win, outside = window_args(torch, transport, sim, start,
                                             window)
    args = (geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    name = f"{label} {deck.split('/')[-1].split('.')[0]}"
    dep = {"buffers": flight_kernel.FlightBuffers(
        geom.nx, geom.ny, "cuda", dtype=sim.dtype,
        tally_dtype=sim.tally.dtype)}
    times = {}

    def run(fn, segments=None, **kw):
        state, tally = start.clone(), torch.zeros_like(tally0)
        ms, (state, nf, nc, n, ph) = timed(torch, fn, state, tally, *args,
                                           segments=segments, **win, **kw)
        times[fn.__name__] = (ms, ph["flight"] * 1e3, ph["raster"] * 1e3)
        return state, nf, nc, n, tally

    ksegs, psegs, csegs, rounds = [], [], [], []
    # warm-up (it grows the deposit's piece buffer), collects the rows
    run(driver.census.flight_chunk_kernel, ksegs, **dep)
    ks, knf, knc, kl, kt = run(driver.census.flight_chunk_kernel,
                               rounds=rounds, **dep)
    # a launch loads each lane of its list; every lane of step 1 is live
    loads = sum(r["lanes"] for r in rounds[1:]) + int((~start.dead).sum())
    ps, pnf, pnc, pn, pt = run(flight.flight_chunk_plain, psegs)
    c_ms, k_ms, kd_ms = times["flight_chunk_kernel"]
    _, p_ms, pd_ms = times["flight_chunk_plain"]
    print(f"[{name}] kernel {k_ms:.3f} ms ({kl} launches) + deposits "
          f"{kd_ms:.3f} ms (census {c_ms:.3f} ms), plain {p_ms:.3f} ms "
          f"({pn} sweeps) + deposit {pd_ms:.3f} ms; facets {knf} / {pnf}, "
          f"collisions {knc} / {pnc}", flush=True)
    if (knf, knc) != (pnf, pnc):
        fail(f"{name}: event counts differ: kernel {(knf, knc)} plain "
             f"{(pnf, pnc)}")
    if knf == 0:
        fail(f"{name}: no facet events, the comparison is empty")
    f = same(ks, ps, torch, fields)
    if f is not None:
        n_bad = int((bits(torch, getattr(ks, f))
                     != bits(torch, getattr(ps, f))).sum())
        fail(f"{name}: state.{f} differs on {n_bad} lanes")
    check_outside(torch, name, start, ks, outside, fields)
    if torch.cat(ksegs).dtype != sim.dtype:
        fail(f"{name}: the kernel wrote {torch.cat(ksegs).dtype} rows")
    krows, prows = sorted_rows(torch, ksegs), sorted_rows(torch, psegs)
    if not torch.equal(krows, prows):
        fail(f"{name}: segment rows differ ({krows.shape[0]} kernel, "
             f"{prows.shape[0]} plain)")
    ksum, psum = float(kt.double().sum()), float(pt.double().sum())
    max_abs_err = float((kt.double() - pt.double()).abs().max())
    peak = float(pt.double().abs().max())
    rel = abs(ksum - psum) / abs(psum)
    print(f"[{name}] all {len(fields)} per-lane state fields equal, "
          f"{krows.shape[0]} segment rows equal as multisets; tally sums "
          f"{ksum:.9e} / {psum:.9e} (rel {rel:.3e}), max abs err per cell "
          f"{max_abs_err:.3e} (largest cell {peak:.3e})")
    if not rel <= tol:
        fail(f"{name}: tally sums differ by {rel:.3e} (> {tol})")
    check_cells(name, cells, max_abs_err, peak, tol)
    cs, cnf, cnc, cl, _ = run(driver.census.flight_chunk_kernel, csegs,
                              max_pieces=1, **dep)
    one_ms = times["flight_chunk_kernel"][0]
    if (cl < 2 or (cnf, cnc) != (pnf, pnc)
            or same(cs, ps, torch, fields) is not None
            or not torch.equal(sorted_rows(torch, csegs), prows)):
        fail(f"{name}: the census in {cl} launches of 1 piece differs from "
             "the plain version")
    print(f"[{name}] 1 piece per launch: {cl} launches in "
          f"{one_ms:.3f} ms, counts, per-lane state and segment rows equal")
    if small:
        ssegs, refusals0 = [], driver.census.flight_chunk_kernel.refusals
        buf = flight_kernel.FlightBuffers(geom.nx, geom.ny, "cuda",
                                          rows=SMALL_ROWS, max_rows=SMALL_MAX,
                                          dtype=sim.dtype,
                                          tally_dtype=sim.tally.dtype)
        ss, snf, snc, sl, st = run(driver.census.flight_chunk_kernel, ssegs,
                                   buffers=buf)
        refusals = driver.census.flight_chunk_kernel.refusals - refusals0
        if ((snf, snc) != (pnf, pnc)
                or same(ss, ps, torch, fields) is not None
                or not torch.equal(sorted_rows(torch, ssegs), prows)):
            fail(f"{name}: the census under a {SMALL_ROWS}-row segment "
                 "buffer differs from the plain version")
        if refusals == 0 and prows.shape[0] > SMALL_ROWS:
            fail(f"{name}: {prows.shape[0]} rows through a {SMALL_ROWS}-row "
                 "buffer without a refusal")
        # the tally holds what the refused rounds deposited
        ssum = float(st.double().sum())
        srel = abs(ssum - psum) / abs(psum)
        serr = float((st.double() - pt.double()).abs().max())
        if not (srel <= tol and serr <= tol * peak):
            fail(f"{name}: the tally under a {SMALL_ROWS}-row segment buffer "
                 f"differs from the plain version's: sums by {srel:.3e}, a "
                 f"cell by {serr:.3e} of the largest {peak:.3e} (> {tol})")
        print(f"[{name}] segment buffer of {SMALL_ROWS} rows grown up to "
              f"{SMALL_MAX}: {sl} rounds, {refusals} with refused rows, in "
              f"{times['flight_chunk_kernel'][0]:.3f} ms; counts, per-lane "
              f"state and segment rows equal; tally sums {ssum:.9e} (rel "
              f"{srel:.3e}), max abs err per cell {serr:.3e} (largest cell "
              f"{peak:.3e})")
    return {"ms": k_ms, "plain_ms": p_ms, "deposit_ms": kd_ms,
            "plain_deposit_ms": pd_ms, "census_ms": c_ms,
            "max_abs_err": max_abs_err, "n": n,
            "ncells": geom.nx * geom.ny, "facets": knf, "collisions": knc,
            "rng": cfg.rng, "segs": ksegs, "f64": dtype == "float64",
            "tally_bytes": kt.element_size(),
            "rows": sum(r.shape[0] for r in ksegs),
            **table_work(sim, loads, knc)}


def compare_raster(segs, torch, nx, ny, raster, raster_kernel, label,
                   tally_dtype=None):
    """Phase 6 on one set of segment rows into an nx x ny tally (and phase
    28 on float64 rows, into a float64 tally; phase 29 into a tally of
    `tally_dtype`, None: the rows' type): returns a dict of the kernel's
    time (CUDA events) and its stages', the plain version's time,
    max_abs_err, the bins' sizes, the tile kernel's blocks an SM and the
    bound (40 bytes a float64 row, 8 a float64 tally cell, and FP64
    instructions for a walk in float64)."""
    rows = torch.cat(segs).contiguous()
    f64 = rows.dtype == torch.float64
    tally_dtype = tally_dtype or rows.dtype
    tol = 1e-12 if tally_dtype == torch.float64 else 1e-5
    nseg = torch.tensor([rows.shape[0]], dtype=torch.int64,
                        device=rows.device)
    kt = torch.zeros(nx * ny, dtype=tally_dtype, device=rows.device)
    pt = torch.zeros_like(kt)
    dep = raster_kernel.SegmentDeposit(nx, ny, "cuda", dtype=rows.dtype,
                                       tally_dtype=tally_dtype)
    # warm-up: the first launch overflows the new piece buffer, which grows
    raster_kernel.deposit_segments_kernel(kt, rows, nseg, nx, ny, dep)
    kt.zero_()
    stages = []
    wall_ms, _ = timed(torch, raster_kernel.deposit_segments_kernel, kt, rows,
                       nseg, nx, ny, dep, stages=stages)
    if len(stages) != 1:
        fail(f"segment deposit {label}: {len(stages)} launches after the "
             "warm-up (want 1)")
    ev = stages[0]
    bin_ms, tile_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    st = dep.stats()
    st["tile_blocks_per_sm"] = raster_kernel.tile_blocks_per_sm(
        rows.dtype, rows.device, tally_dtype)
    p_ms, _ = timed(torch, raster.deposit_segments_plain, pt, rows, nx, ny)
    ksum, psum = float(kt.double().sum()), float(pt.double().sum())
    max_abs_err = float((kt.double() - pt.double()).abs().max())
    peak = float(pt.double().abs().max())
    rel = abs(ksum - psum) / abs(psum)
    print(f"[raster {label}] {rows.shape[0]} {rows.dtype} segment rows, "
          f"{nx}x{ny} {tally_dtype} tally: "
          f"kernel {bin_ms + tile_ms:.3f} ms (bins {bin_ms:.3f} + tiles "
          f"{tile_ms:.3f}; {wall_ms:.3f} ms on the clock), plain "
          f"{p_ms:.3f} ms; T {st['tile']}, C {st['chunk']}, tile kernel "
          f"{st['tile_blocks_per_sm']} blocks an SM: "
          f"{st['pieces']} pieces in {st['work_items']} work items, "
          f"per tile max {st['pieces_per_tile_max']} / mean "
          f"{st['pieces_per_tile_mean']:.1f} over "
          f"{st['tiles_with_pieces']} tiles; sums {ksum:.9e} / {psum:.9e} "
          f"(rel {rel:.3e}); max abs err per cell {max_abs_err:.3e} "
          f"(largest cell {peak:.3e})", flush=True)
    if not (rel <= tol and max_abs_err <= tol * peak):
        fail(f"segment deposit {label}: kernel and plain version differ by "
             f"more than {tol}")
    visits = cell_visits(torch, rows)
    nbytes = rows.shape[0] * (40 if f64 else 20) + nx * ny * kt.element_size()
    work = (bound(nbytes, 0, visits * FLOPS_VISIT
                  + rows.shape[0] * f64_ops({"rcp": 2}), PEAK_F64_INSTR)
            if f64 else bound(nbytes, 0, visits * FLOPS_VISIT))
    return {"ms": bin_ms + tile_ms, "bin_ms": bin_ms, "tile_ms": tile_ms,
            "wall_ms": wall_ms, "plain_ms": p_ms, "max_abs_err": max_abs_err,
            "rows": rows.shape[0], "cell_visits": visits, **st, **work}


def deck_copy(src: str, dirpath: str, extra: str = "") -> str:
    """A copy of deck `src` in `dirpath` under its own basename (so that
    its golden is found by name), with `extra` lines appended."""
    path = os.path.join(dirpath, os.path.basename(src))
    shutil.copy(src, path)
    with open(path, "a") as f:
        f.write(extra)
    return path


def step_counts(out: str) -> list:
    """[(facets, collisions), ...] per step of a driver.main output."""
    return [(int(f), int(c)) for f, c in re.findall(
        r"Facets\s+(\d+)\nCollisions\s+(\d+)", out)]


def flight_steps(out: str) -> list:
    """Per step of a driver.main output with the flight kernel: its live
    lanes, launches, pieces granted, lanes of its first, median and last
    launch, segment rows and counts."""
    keys = ("n", "pieces", "launches", "first", "median", "last", "rows",
            "facets", "collisions")
    return [dict(zip(keys, map(int, g))) for g in re.findall(
        r"Handled (\d+) particles, with (\d+) event sweeps \((\d+) flight "
        r"kernel launches.*\nFlight launch lanes: first (\d+), median "
        r"(\d+), last (\d+); segment rows (\d+)\n(?:.*\n)*?Facets\s+(\d+)"
        r"\nCollisions\s+(\d+)", out)]


def kernel_wrappers():
    """(wrapper, count attribute) of every kernel and plain version of
    the main paths."""
    from neutral_tpu_torch import (begin_kernel, census, flight,
                                   inject_kernel, particles, raster,
                                   raster_kernel, sweep_kernel, transport)
    return [(census.sweep_chunk_kernel, "launches"),
            (sweep_kernel.sweep_chunk_plain, "calls"),
            (census.flight_chunk_kernel, "launches"),
            (flight.flight_chunk_plain, "calls"),
            (raster_kernel.deposit_segments_kernel, "launches"),
            (raster_kernel.deposit_segments_kernel, "overflows"),
            (raster.deposit_segments_plain, "calls"),
            (begin_kernel.begin_timestep_kernel, "launches"),
            (transport.begin_timestep, "calls"),
            (inject_kernel.inject_particles_kernel, "launches"),
            (particles.inject_particles, "calls")]


def check_begin(name: str, out: str, c: dict, shards: int) -> int:
    """Fail unless a main path started each census of each of its `shards`
    shards once, with the begin kernel on the kernel engine and the plain
    begin_timestep on the plain one, and never the other; returns the
    begin kernel's launches."""
    censuses = len(re.findall(r"^Iteration  \d+$", out, re.M))
    kernel = "Engine: kernel." in out
    want = censuses * shards
    got = (c["begin_timestep_kernel"], c["begin_timestep"])
    if censuses == 0 or got != ((want, 0) if kernel else (0, want)):
        fail(f"{name}: begin kernel launches and plain begin calls {got}; "
             f"want {want} ({censuses} censuses x {shards} shards) of the "
             f"{'kernel' if kernel else 'plain version'} and none of the "
             "other")
    return c["begin_timestep_kernel"]


def check_inject(name: str, shards: int, kernel: bool, c: dict) -> int:
    """Fail unless a process injected each of its `shards` shards once (a
    single device's Simulation: one), by one inject kernel launch on the
    kernel engine and one particles.inject_particles call on the plain
    one, and never the other.  Returns the kernel's launches."""
    want = (shards, 0) if kernel else (0, shards)
    got = (c["inject_particles_kernel"], c["inject_particles"])
    if got != want:
        fail(f"{name}: inject kernel launches and plain inject calls {got}; "
             f"want {want} ({shards} shard(s), the "
             f"{'kernel' if kernel else 'plain'} engine)")
    return got[0]


def reset_counts(wrappers):
    for fn, attr in wrappers:
        setattr(fn, attr, 0)
        if hasattr(fn, "cards"):
            fn.cards.clear()


def read_counts(wrappers) -> dict:
    return {fn.__name__ if attr in ("launches", "calls")
            else f"{fn.__name__}.{attr}": getattr(fn, attr)
            for fn, attr in wrappers}


def read_cards(wrappers) -> dict:
    """Each kernel's launches by card ({name: {"cuda:i": n}}), counted by
    the wrappers beside their launches."""
    return {fn.__name__: {f"cuda:{k}": v for k, v in sorted(fn.cards.items())}
            for fn, attr in wrappers if attr == "launches"}


def reset_peaks(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)


def card_peaks(torch) -> dict:
    """Peak allocated GiB of every card this process used, by card."""
    peaks = {f"cuda:{i}": torch.cuda.max_memory_allocated(i) / 2**30
             for i in range(torch.cuda.device_count())}
    return {k: v for k, v in peaks.items() if v > 0}


def main_path(deck, torch, driver, wrappers, argv=(), label=None):
    """Run driver.main on `deck` (with `argv`; on cuda:0 unless it names a
    device) with every count set to 0 just before; returns (stdout,
    tally, {wrapper name: count}) read just after (and the launches by
    card and the cards' peak memory into main_path.cards and .peaks)."""
    argv = list(argv) if "--device" in argv else ["--device", "cuda:0",
                                                  *argv]
    reset_counts(wrappers)
    reset_peaks(torch)
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = driver.main([deck, *argv])
    wall = time.perf_counter() - t0
    counts = read_counts(wrappers)
    out = tee.buf.getvalue()
    name = label or deck.split("/")[-1].split(".")[0]
    main_path.walls[name] = wall
    if rc != 0:
        fail(f"{name}: driver.main returned {rc}")
    shards = re.search(r"^Decomposition: \w+, (\d+) shards", out, re.M)
    main_path.begin_launches[name] = check_begin(
        name, out, counts, int(shards[1]) if shards else 1)
    main_path.inject_launches[name] = check_inject(
        name, int(shards[1]) if shards else 1, "Engine: kernel." in out,
        counts)
    total = float(re.search(r"Final global_energy_tally (\S+)", out)[1])
    if not math.isfinite(total):
        fail(f"{name}: tally sum {total} is not finite")
    main_path.runs[name] = (step_counts(out), step_seconds(out))
    steps = re.findall(r"Step time\s+(\S+)s\nWallclock.*\nFacets\s+(\d+)\n"
                       r"Collisions\s+(\d+)", out)
    migrated = re.findall(r"Migrated (\d+) particles between shards", out)
    flights = flight_steps(out)
    iterations = re.findall(r"Iteration  (\d+)", out)
    for i, (st, nf, nc) in enumerate(steps, 1):
        st, ev = float(st), int(nf) + int(nc)
        moved = (f", {migrated[i - 1]} lanes migrated" if migrated else "")
        fl = (f"; {flights[i - 1]['launches']} flight launches granting "
              f"{flights[i - 1]['pieces']} pieces, lanes first "
              f"{flights[i - 1]['first']} / median {flights[i - 1]['median']}"
              f" / last {flights[i - 1]['last']}" if flights else "")
        print(f"[main {name}] step {iterations[i - 1]}: {ev} events in "
              f"{st:.4f} s = {ev / st:.4e} events/s{moved}{fl}")
    main_path.cards[name] = read_cards(wrappers)
    main_path.peaks[name] = peaks = card_peaks(torch)
    by_card = (f" ({', '.join(f'{k} {v:.2f}' for k, v in peaks.items())})"
               if len(peaks) > 1 else "")
    print(f"[main {name}] counts {counts}, tally {total:.12e}, wall "
          f"{wall:.1f} s, peak device memory "
          f"{max(peaks.values(), default=0.0):.2f} GiB{by_card}", flush=True)
    return out, total, counts


main_path.walls = {}     # wall seconds of each main path, by label
main_path.runs = {}      # (per-step counts, step seconds), by label
main_path.begin_launches = {}    # begin kernel launches, by label
main_path.inject_launches = {}   # inject kernel launches, by label
main_path.cards = {}     # kernel launches by card, by label
main_path.peaks = {}     # peak GiB by card, by label


def check_kernel_path(name: str, out: str, c: dict,
                      passed: bool = True) -> tuple:
    """Fail unless a main path of phases 8-10 and 14 printed `PASSED
    validation.` (unless `passed` is False) and ran its transport's kernels
    and no plain version; returns its (sweep, flight, segment-deposit)
    launch counts and the deposit's overflow re-runs."""
    if passed and "PASSED validation." not in out:
        fail(f"the full {name} deck did not print 'PASSED validation.'")
    if c["sweep_chunk_plain"] != 0 or c["flight_chunk_plain"] != 0:
        fail(f"{name} main path: counts {c} (a plain version ran)")
    if "Transport: flight." in out:
        ok = c["flight_chunk_kernel"] > 0 and c["deposit_segments_kernel"] > 0
    else:
        ok = c["sweep_chunk_kernel"] > 0
    if not ok or "Engine: kernel." not in out:
        fail(f"{name} main path: counts {c} (want kernel launches)")
    return (c["sweep_chunk_kernel"], c["flight_chunk_kernel"],
            c["deposit_segments_kernel"],
            c["deposit_segments_kernel.overflows"])


def mode_entry(runs: list, shape: str) -> dict:
    """The kernels-line entry of a mode from its comparisons (times and
    bounds summed over decks, the largest error)."""
    bounds = [work_bound(r) for r in runs]
    top = max(bounds, key=lambda b: b["bound_ms"])
    out = {"ms": sum(r["ms"] for r in runs),
           "plain_ms": sum(r["plain_ms"] for r in runs),
           "max_abs_err": max(r["max_abs_err"] for r in runs),
           "bound_ms": sum(b["bound_ms"] for b in bounds),
           "bound_by": top["bound_by"], "shape": shape}
    if "deposit_ms" in runs[0]:
        out["deposit_ms"] = sum(r["deposit_ms"] for r in runs)
    if "lookups" in runs[0]:
        out["lookups"] = sum(r["lookups"] for r in runs)
    return out


def graph_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` calls captured in one
    CUDA graph, so that no host work stands between them (CUDA events
    around one replay, after a warm-up call and a warm-up replay)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def compare_lookup(torch, keys, values, energy, label: str) -> dict:
    """Phase 9's lookup kernel alone on one table (host float arrays) and
    energies (float32 on the card; float64 in phase 26, the table made in
    the energies' dtype): indices bitwise the plain two-level search's and
    torch.searchsorted's, values bitwise TableLayout.lookup's and
    CrossSection.lookup's.  Returns its time (graph_ms), the plain
    version's (TableLayout.lookup, on the clock), the library's
    (CrossSection.lookup, graph_ms) and its bound."""
    from neutral_tpu_torch.table_kernel import table_lookup_kernel
    from neutral_tpu_torch.xs import CrossSection

    tab = CrossSection(
        torch.as_tensor(keys, dtype=energy.dtype, device="cuda"),
        torch.as_tensor(values, dtype=energy.dtype, device="cuda"))
    lay = tab.table_layout
    n = lay.nentries
    got, idx = table_lookup_kernel(lay, energy, index=True)
    want = (torch.searchsorted(tab.keys, energy, right=True) - 1).clamp(
        0, n - 2)
    if not (torch.equal(idx.long(), want)
            and torch.equal(idx.long(), lay.index(energy))):
        bad = int((idx.long() != want).sum())
        fail(f"lookup {label}: {bad} indices differ from searchsorted's")
    p_ms, plain = timed(torch, lay.lookup, energy)
    for name, ref in (("TableLayout.lookup", plain),
                      ("CrossSection.lookup", tab.lookup(energy))):
        if not torch.equal(bits(torch, got), bits(torch, ref)):
            bad = int((bits(torch, got) != bits(torch, ref)).sum())
            fail(f"lookup {label}: {bad} values differ from {name}'s")
    ms = graph_ms(torch, lambda: table_lookup_kernel(lay, energy),
                  LOOKUP_REPS)
    library_ms = graph_ms(torch, lambda: tab.lookup(energy), LOOKUP_REPS)
    count = energy.numel()
    size = energy.element_size()
    b = (bound(count * 2 * size + table_bytes(lay), 0,
               count * FLOPS_INTERPOLATE) if size == 4
         else bound(count * 2 * size + table_bytes(lay), 0,
                    count * (5 + F64_SEQUENCES.get("div", 1)),
                    PEAK_F64_INSTR))
    print(f"[lookup {label}] {count} energies, {n} entries (S = "
          f"{1 << lay.shift}, {lay.coarse.shape[0]} coarse keys): kernel "
          f"{ms:.4f} ms, library {library_ms:.4f} ms, plain {p_ms:.3f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); indices and "
          "values bitwise equal", flush=True)
    return {"ms": ms, "plain_ms": p_ms, "library_ms": library_ms,
            "max_abs_err": 0.0, "energies": count, "entries": n,
            "stride": 1 << lay.shift, **b}


def run_modes(tmp: str, torch, driver, transport, flight, sweep_kernel,
              flight_kernel, fields, wrappers, scatter_counts) -> dict:
    """Phases 8-10.  Returns the per-mode comparison results of the sweep
    and flight kernels and the launches of the main paths."""
    import numpy as np
    from neutral_tpu_torch.mesh import build_density
    from neutral_tpu_torch.table_kernel import (PROBE_TABLES, probe_energies,
                                                probe_table)
    from neutral_tpu_torch.xs import resonance_log_table, write_cs_file

    res = {"sweep": {}, "flight": {}, "sweep_launches": 0,
           "flight_launches": 0, "raster_launches": 0, "overflows": 0,
           "fused_launches": {"sweep": 0, "flight": 0}, "lookups": {},
           "lookup": {}}

    def add_launches(counts):
        res["sweep_launches"] += counts[0]
        res["flight_launches"] += counts[1]
        res["raster_launches"] += counts[2]
        res["overflows"] += counts[3]

    def sweep_mode(mode, deck, shape):
        r = compare(MODE_N, torch, driver, transport, sweep_kernel, fields,
                    deck=deck, label=f"compare {mode}")
        res["sweep"][mode] = mode_entry([r], shape)
        return r

    def flight_mode(mode, decks, shape):
        runs = [compare_flight(d, torch, driver, transport, flight,
                               flight_kernel, fields, label=f"flight {mode}")
                for d in decks]
        res["flight"][mode] = mode_entry(runs, shape)

    # ---- 8. pcg64si -----------------------------------------------------
    pcg = os.path.join(tmp, "pcg")
    os.mkdir(pcg)
    decks = {d: deck_copy(d, pcg, "rng pcg64si\n")
             for d in (SCATTER, *FLIGHT_DECKS)}
    sweep_mode("pcg64si", decks[SCATTER],
               f"scatter with rng pcg64si, {MODE_N} particles, one census")
    flight_mode("pcg64si", [decks[d] for d in FLIGHT_DECKS[:2]],
                f"stream + split with rng pcg64si, {MODE_N} particles each, "
                "one step-1 census each")
    for src, deck in decks.items():
        name = f"pcg64si {os.path.basename(src).split('.')[0]}"
        out, _, c = main_path(deck, torch, driver, wrappers, label=name)
        add_launches(check_kernel_path(name, out, c))

    # ---- 9. table mode --------------------------------------------------
    table = os.path.join(tmp, "table")
    os.mkdir(table)
    keys, values = resonance_log_table()
    for fname in ("elastic_scatter.cs", "capture.cs"):
        write_cs_file(os.path.join(table, fname), keys, values)
    split = FLIGHT_DECKS[1]
    decks = {d: deck_copy(d, table) for d in (SCATTER, split)}
    census = sweep_mode("table", decks[SCATTER],
                        f"scatter with 30,000-entry .cs tables, {MODE_N} "
                        "particles, one census")
    flight_mode("table", [decks[split]],
                f"split with 30,000-entry .cs tables, {MODE_N} particles, "
                "one step-1 census")
    for src, deck in decks.items():
        name = f"table {os.path.basename(src).split('.')[0]}"
        out, _, c = main_path(deck, torch, driver, wrappers, label=name)
        add_launches(check_kernel_path(name, out, c))
        # the sweep and flight kernels run the table lookup inside
        res["fused_launches"]["sweep"] += c["sweep_chunk_kernel"]
        res["fused_launches"]["flight"] += c["flight_chunk_kernel"]
        # one table (same_xs): a lookup at each lane's load and collision
        handled = sum(map(int, re.findall(r"Handled (\d+) particles", out)))
        res["lookups"][name] = handled + sum(
            nc for _, nc in step_counts(out))
    print(f"[table] lookups on the main paths, (lanes handled + collisions) "
          f"per step, summed: {res['lookups']}", flush=True)
    # a second, 3,001-entry capture table: the absorb lookup
    distinct = os.path.join(tmp, "table_distinct")
    os.mkdir(distinct)
    write_cs_file(os.path.join(distinct, "elastic_scatter.cs"), keys, values)
    k2, v2 = resonance_log_table(3001)
    write_cs_file(os.path.join(distinct, "capture.cs"), k2, 0.5 * v2)
    decks = {d: deck_copy(d, distinct) for d in (SCATTER, split)}
    sweep_mode("table distinct", decks[SCATTER],
               f"scatter with a 30,000-entry scatter and a 3,001-entry "
               f"capture table, {MODE_N} particles, one census")
    flight_mode("table distinct", [decks[split]],
                f"split with a 30,000-entry scatter and a 3,001-entry "
                f"capture table, {MODE_N} particles, one step-1 census")
    # the lookup kernel alone: census energies (the table census's end
    # state; ten times over at 10M) and log-uniform ones, at 1M and 10M
    e_census = census.pop("energy")
    for count in (MODE_N, 10 * MODE_N):
        e_log = torch.from_numpy(
            probe_energies(keys, count)[-count:]).cuda()
        for dist, e in (("census energies",
                         e_census.repeat(count // MODE_N)),
                        ("log-uniform", e_log)):
            label = dist + ("" if count == MODE_N else " 10M")
            res["lookup"][label] = compare_lookup(
                torch, keys, values, e, f"30,000 entries, {label}")
        del e_log, e
    for name in PROBE_TABLES:
        k, v = probe_table(name)
        res["lookup"][name] = compare_lookup(
            torch, k, v, torch.from_numpy(probe_energies(k, MODE_N)).cuda(),
            name)

    # ---- 10. grid mode --------------------------------------------------
    rgrid = os.path.join(tmp, "random_grid")
    own = os.path.join(tmp, "own_grid")
    os.mkdir(rgrid)
    os.mkdir(own)
    cfg = driver.load_config(SCATTER)
    rng = np.random.default_rng(7)
    dens = rng.uniform(1.0e3, 2.0e4, size=(cfg.ny, cfg.nx))
    dens[rng.random((cfg.ny, cfg.nx)) < 0.25] = 0.0
    np.save(os.path.join(rgrid, "dens.npy"), dens)
    np.save(os.path.join(own, "dens.npy"), build_density(cfg))
    del dens
    sweep_mode("grid", deck_copy(SCATTER, rgrid, "density_file dens.npy\n"),
               f"scatter on a random 4000x4000 grid, 25% vacuum cells, "
               f"{MODE_N} particles, one census")
    out, _, c = main_path(deck_copy(SCATTER, own, "density_file dens.npy\n"),
                          torch, driver, wrappers, label="grid scatter")
    add_launches(check_kernel_path("grid scatter", out, c))
    grid_counts = step_counts(out)
    print(f"[main grid scatter] per-step (facets, collisions) {grid_counts}; "
          f"region run {scatter_counts}")
    if grid_counts != scatter_counts or not grid_counts:
        fail("the grid scatter deck's event counts differ from the region "
             "deck's")
    return res


def split_single_counts(deck, torch, driver, flight, transport="auto",
                        **cfg_kw) -> list:
    """Per-step (facets, collisions) of a single-device kernel run of the
    full `deck` (its config with `cfg_kw`, on `transport`) over its rects
    split at the 2x2 blocks' grid lines (the geometry that spatial2d's
    windows give)."""
    import dataclasses
    sim = driver.Simulation(driver.load_config(deck).with_(**cfg_kw),
                            transport=transport, quiet=True)
    # the census runs over its one shard's geometry
    sim.shards[0].geom = dataclasses.replace(
        sim.geom, rects=flight.split_rects(sim.geom.rects, [2000], [2000]))
    sim.run()
    return [(m.nfacets, m.ncollisions) for m in sim.step_metrics]


def decomposed_paths(tmp, torch, driver, flight, wrappers,
                     scatter_counts) -> dict:
    """Phase 14.  Returns the launches of its main paths and, per run, its
    per-step counts, migrations and launches."""
    import numpy as np
    from neutral_tpu_torch.mesh import build_density

    res = {"sweep_launches": 0, "flight_launches": 0, "raster_launches": 0,
           "overflows": 0, "runs": {}}

    def run(deck, decomposition, name, want_counts):
        out, total, c = main_path(deck, torch, driver, wrappers,
                                  argv=[*SHARDS, decomposition],
                                  label=f"{decomposition} {name}")
        if f"Decomposition: {decomposition}, 4 shards on cuda:0" not in out:
            fail(f"{decomposition} {name}: the decomposition did not run")
        if name == "csp":
            rel = abs(total - CSP_OMP3_TALLY) / CSP_OMP3_TALLY
            print(f"[main {decomposition} csp] tally {total:.9e} against "
                  f"omp3's {CSP_OMP3_TALLY:.7e}: rel {rel:.3e}")
            if not rel <= 1e-3:
                fail(f"{decomposition} csp tally is {rel:.3e} from omp3's")
        launches = check_kernel_path(f"{decomposition} {name}", out, c,
                                     passed=name != "csp")
        res["sweep_launches"] += launches[0]
        res["flight_launches"] += launches[1]
        res["raster_launches"] += launches[2]
        res["overflows"] += launches[3]
        counts = step_counts(out)
        res["runs"][f"{decomposition} {name}"] = {
            "counts": counts, "step_s": step_seconds(out)}
        if want_counts is not None and counts != want_counts:
            fail(f"{decomposition} {name}: per-step counts {counts} differ "
                 f"from the single-device run's {want_counts}")
        print(f"[main {decomposition} {name}] per-step counts equal to the "
              f"single-device run's: {want_counts is not None}; launches "
              f"{launches}", flush=True)

    for decomposition in ("replicated", "spatial", "spatial2d"):
        run(SCATTER, decomposition, "scatter", scatter_counts)
    for deck in FLIGHT_DECKS:
        name = deck.split("/")[-1].split(".")[0]
        run(deck, "spatial2d", name,
            split_single_counts(deck, torch, driver, flight))
    pcg = os.path.join(tmp, "pcg_spatial")
    grid = os.path.join(tmp, "grid_spatial")
    os.mkdir(pcg)
    os.mkdir(grid)
    cfg = driver.load_config(SCATTER)
    np.save(os.path.join(grid, "dens.npy"), build_density(cfg))
    run(deck_copy(FLIGHT_DECKS[1], pcg, "rng pcg64si\n"), "spatial",
        "pcg64si split", None)
    run(deck_copy(SCATTER, grid, "density_file dens.npy\n"), "spatial",
        "grid scatter", scatter_counts)
    return res


def csp_entry(out: str, driver, launches: int) -> dict:
    """csp's flight kernel over the 10 steps of its main path: its own
    device time (the "flight" phase, CUDA events), the bound of the work
    those steps gave it, and its launches."""
    cfg = driver.load_config(FLIGHT_DECKS[2])
    steps = flight_steps(out)
    ms = float(re.search(r"PHASE BREAKDOWN.*flight=([0-9.]+)s", out)[1]) * 1e3
    bounds = [work_bound({"n": st["n"], "ncells": cfg.nx * cfg.ny,
                          "rows": st["rows"], "facets": st["facets"],
                          "collisions": st["collisions"], "rng": cfg.rng})
              for st in steps]
    r = {"ms": ms, "bound_ms": sum(b["bound_ms"] for b in bounds),
         "bound_by": max(bounds, key=lambda b: b["bound_ms"])["bound_by"],
         "launches": launches, "steps": len(steps),
         "lanes_first_median_last": [[st["first"], st["median"], st["last"]]
                                     for st in steps]}
    print(f"[main csp] flight kernel over {len(steps)} steps: {ms:.1f} ms "
          f"(bound {r['bound_ms']:.3f} ms, {r['bound_by']}) in {launches} "
          "launches")
    return r


def big_split(torch, driver, wrappers, fields) -> dict:
    """Phase 16: split at BIG_N particles, one step through Simulation,
    against a 1,000,000-particle run of the same step."""
    cfg = driver.load_config(FLIGHT_DECKS[1])
    small = driver.Simulation(cfg, quiet=True)
    small.step(1)
    ref = small.state
    del small
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    sim = driver.Simulation(cfg.with_(nparticles=BIG_N), quiet=True)
    setup = time.perf_counter() - t0
    m = sim.step(1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {fn.__name__: getattr(fn, attr) for fn, attr in wrappers
              if attr in ("launches", "calls")}
    launches = counts["flight_chunk_kernel"]
    if launches == 0 or counts["flight_chunk_plain"] != 0:
        fail(f"split at {BIG_N}: counts {counts} (want flight launches "
             "and no plain run)")
    bad = [f for f in fields
           if not torch.equal(getattr(sim.state, f)[:ref.n], getattr(ref, f))]
    if bad:
        fail(f"split at {BIG_N}: its first {ref.n} lanes differ from the "
             f"{ref.n}-particle run in {bad}")
    total = float(sim.host_tally().sum())
    rel = abs(total - cfg.expected_tally) / cfg.expected_tally
    events = m.nfacets + m.ncollisions
    print(f"[split {BIG_N}] set-up {setup:.1f} s, step {m.step_time:.4f} s: "
          f"{events} events = {events / m.step_time:.4e} events/s; "
          f"{launches} flight launches (lanes "
          f"{[r['lanes'] for r in m.rounds]}); first {ref.n} lanes equal to "
          f"the {ref.n}-particle run in all {len(fields)} fields; tally "
          f"{total:.9e}, {rel:.3e} from the golden {cfg.expected_tally:.9e}; "
          f"peak device memory {peak:.2f} GiB; phases {m.phases}", flush=True)
    if not (math.isfinite(total) and rel <= 1e-2):
        fail(f"split at {BIG_N}: tally {total:.9e} is {rel:.3e} from the "
             "golden (> 1e-2)")
    return {"nparticles": BIG_N, "step_s": m.step_time,
            "events_per_s": events / m.step_time, "launches": launches,
            "peak_gib": peak, "tally": total}


def sweep_registers(log: str, real: str = "float", edge: int = 0,
                    tally: str | None = None) -> int:
    """ptxas's register count of the sweep kernel's analytic, region,
    threefry instantiation in the working type `real` (float or double),
    edge mode `edge` (0 pitch, 1 edge arrays) and tally type `tally`
    (None: `real`), from the build's log: its mangled name ends the
    template arguments with the working type's code, f or d, the edge
    mode's and the tally type's."""
    tag = (f"XsModeE0ELNS1_11DensityModeE0ELNS1_9RngSchemeE0E{real[0]}"
           f"LNS1_8EdgeModeE{edge}E{(tally or real)[0]}E")
    for name, regs in re.findall(r"Compiling entry function '([^']*)'"
                                 r".*?Used (\d+) registers", log, re.S):
        if "sweep_kernel" in name and tag in name:
            return int(regs)
    fail(f"the build log has no register count of the sweep kernel in {real}"
         f", edge mode {edge}")


def analytic_grid_check(torch, driver) -> None:
    """Phase 17: the grid the kernels' analytic lookup reads, made on the
    card, against _key_at/_val_at evaluated on the CPU, where the tests
    prove the lookup through the grid bitwise equal to the plain one."""
    sim = driver.Simulation(driver.load_config(SCATTER).with_(
        nparticles=1, expected_tally=None), quiet=True)
    tab = sim.cs_scatter
    grid = tab.analytic_grid_in(torch.float32)
    i = torch.arange(tab.nentries, dtype=torch.int32)
    keys, values = tab._key_at(i, torch.float32), tab._val_at(i, torch.float32)
    if not (grid.is_cuda and torch.equal(grid[:, 0].cpu(), keys)
            and torch.equal(grid[:, 1].cpu(), values)):
        fail("the analytic grid made on the card differs from _key_at/"
             "_val_at on the CPU")
    print(f"[analytic grid] {tab.nentries} (key, value) pairs made on "
          f"{grid.device}, {grid.numel() * 4} bytes, bitwise equal to "
          "_key_at/_val_at on the CPU at every index", flush=True)


def census_repeats(tmp: str) -> dict:
    """Phase 15: the unwindowed 10M scatter census, 5 times."""
    from neutral_tpu_torch.measure import census
    r = census(5, "analytic", tmp)
    print(f"[census 10M] unwindowed sweep kernel: "
          + ", ".join(f"{t:.3f}" for t in r["census_ms"])
          + f" ms (min {r['min_ms']:.3f}, median {r['median_ms']:.3f})",
          flush=True)
    return r


def step_seconds(out: str) -> list:
    return [float(t) for t in re.findall(r"Step time\s+(\S+)s", out)]


def captured(fn, *args) -> tuple:
    """(return value, stdout) of fn(*args), the output also shown."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = fn(*args)
    return rc, tee.buf.getvalue()


def no_pitch_decks(tmp: str, torch, driver, transport, sweep_kernel,
                   fields, wrappers, scatter_total: float, log: str) -> dict:
    """Phases 18-19: the decks without a pitch on the kernels.  Returns the
    sweep kernel's edge-array comparisons and the begin kernel's, by
    working type, the main instantiation's registers and the launches of
    their main paths."""
    import numpy as np
    from neutral_tpu_torch import begin_kernel, tools
    from neutral_tpu_torch.xs import resonance_log_table, write_cs_file

    res = {"sweep": {"float32": {}, "float64": {}},
           "begin": {"float32": {}, "float64": {}},
           "launches": {"float32": 0, "float64": 0}, "runs": {},
           "registers": {r: sweep_registers(log, r, edge=1)
                         for r in ("float", "double")}}
    print(f"[no pitch] the sweep kernel's edge-array main instantiation "
          f"(analytic, regions, threefry) uses {res['registers']} registers",
          flush=True)
    keys, values = resonance_log_table()
    cfg = driver.load_config(SCATTER)
    rng = np.random.default_rng(7)           # phase 10's random grid
    dens = rng.uniform(1.0e3, 2.0e4, size=(cfg.ny, cfg.nx))
    dens[rng.random((cfg.ny, cfg.nx)) < 0.25] = 0.0
    grid_file = os.path.join(tmp, "dens.npy")
    np.save(grid_file, dens)
    del dens

    def deck_dir(name, extra, table=False, grid=False):
        d = os.path.join(tmp, name.replace(" ", "_"))
        os.mkdir(d)
        if table:
            for fname in ("elastic_scatter.cs", "capture.cs"):
                write_cs_file(os.path.join(d, fname), keys, values)
        if grid:
            os.symlink(grid_file, os.path.join(d, "dens.npy"))
        return deck_copy(SCATTER, d, extra
                         + ("density_file dens.npy\n" if grid else ""))

    # Every edge-array instantiation, (cross-sections, density) x draws:
    # the stretched mesh over regions (analytic, and beside .cs tables) and
    # over a density grid (analytic), and fast_math 0 (table over a grid).
    pcg = "rng pcg64si\n"
    modes = {}
    for r, extra in (("", ""), (" pcg64si", pcg)):
        modes[f"stretched{r}"] = deck_dir(f"stretched{r}", STRETCH + extra)
        modes[f"stretched table{r}"] = deck_dir(f"stretched table{r}",
                                                STRETCH + extra, table=True)
        modes[f"stretched grid{r}"] = deck_dir(f"stretched grid{r}",
                                               STRETCH + extra, grid=True)
        modes[f"fast_math 0{r}"] = deck_dir(f"fast_math 0{r}",
                                            "fast_math 0\n" + extra)

    # ---- the kernels against their plain versions, every instantiation --
    for dtype in ("float32", "float64"):
        for mode, deck in modes.items():
            n = NO_PITCH_MAIN_N if mode == "stretched" else F64_MODE_N
            r = compare(n, torch, driver, transport, sweep_kernel, fields,
                        deck=deck, label=f"no pitch {dtype} {mode}",
                        dtype=dtype, bitwise=True)
            r.pop("energy", None)
            res["sweep"][dtype][mode] = mode_entry(
                [r], f"{mode}: the scatter deck (4000x4000) with "
                f"{'fast_math 0' if 'fast' in mode else 'the stretch'}, "
                f"{n} particles, one census, {dtype}, all 14 fields bitwise")
            res["begin"][dtype][mode] = begin_compare(
                torch, driver, transport, begin_kernel, deck, F64_MODE_N,
                f"no pitch {dtype} {mode}", dtype=dtype)
            torch.cuda.empty_cache()
        res["begin"][dtype]["stretched 10M"] = begin_compare(
            torch, driver, transport, begin_kernel, modes["stretched"],
            NO_PITCH_N, f"no pitch {dtype} stretched", dtype=dtype)
        torch.cuda.empty_cache()

    # ---- the main paths through the CLI, under --engine auto -----------
    def kernel_run(deck, label, dtype, argv=(), n=NO_PITCH_N):
        out, total, c = main_path(
            deck, torch, driver, wrappers, label=label,
            argv=["--dtype", dtype, *argv,
                  *(["--nparticles", str(n)] if n else [])])
        if "Transport: sweep." not in out:
            fail(f"{label}: want 'Transport: sweep.'")
        launches = check_kernel_path(label, out, c, passed=False)
        res["launches"][dtype] += launches[0]
        counts = step_counts(out)
        if not counts or sum(counts[0]) == 0:
            fail(f"{label}: per-step counts {counts}")
        migrated = sum(int(m) for m in re.findall(
            r"Migrated (\d+) particles between shards", out))
        res["runs"][label] = {"step_s": step_seconds(out), "counts": counts,
                              "tally": total, "launches": launches[0],
                              "migrated": migrated}
        return counts, total

    stretched, fast0 = modes["stretched"], modes["fast_math 0"]
    # ---- 18. non-uniform mesh ----
    counts, total = kernel_run(stretched, "f64 stretched", "float64")
    again, total2 = kernel_run(stretched, "f64 stretched re-run", "float64")
    if again != counts or not abs(total2 - total) <= 1e-12 * abs(total):
        fail(f"f64 stretched: the re-run gave {again} {total2!r} against "
             f"{counts} {total!r}")
    counts32, total32 = kernel_run(stretched, "stretched", "float32")
    (f32, c32), (f64_, c64) = counts32[0], counts[0]
    print(f"[stretched] float32 (global coordinates) step 1: {f32} facets, "
          f"{c32} collisions; float64: {f64_} facets, {c64} collisions; "
          f"facets x{f32 / max(f64_, 1):.2f}; tally {total32:.9e} against "
          f"{total:.9e} (rel {abs(total32 - total) / abs(total):.3e})",
          flush=True)
    t0 = time.perf_counter()
    rc, out = captured(tools.main, ["compare", stretched, "--nparticles",
                                    "20000", "--mesh-scale", "10"])
    print(f"[stretched] tools compare on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 0 or "AGREE (port sweep transport on cuda" not in out:
        fail("tools compare on the card did not print AGREE")

    # ---- 19. fast_math 0 ----
    counts0, total0 = kernel_run(fast0, "f64 fast_math 0", "float64")
    counts0_32, total0_32 = kernel_run(fast0, "fast_math 0", "float32")
    print(f"[fast_math 0] float32 (global coordinates) step 1: "
          f"{counts0_32[0][0]} facets; float64: {counts0[0][0]} facets; "
          f"facets x{counts0_32[0][0] / max(counts0[0][0], 1):.2f}",
          flush=True)
    rel = abs(total0 - scatter_total) / abs(scatter_total)
    print(f"[fast_math 0] float64 kernel tally {total0:.9e} against the "
          f"fast_math 1 kernel's float32 {scatter_total:.9e} (phase 4, same "
          f"{NO_PITCH_N} particles): rel {rel:.3e}", flush=True)
    if not rel <= 1e-3:
        fail(f"fast_math 0: tally {rel:.3e} from the kernel engine's (> 1e-3)")

    # ---- both decks decomposed on the card, float64 ----
    for name, deck, want in (("stretched", stretched, counts),
                             ("fast_math 0", fast0, counts0)):
        for decomposition in ("spatial", "spatial2d"):
            label = f"f64 {name} {decomposition}"
            got, _ = kernel_run(deck, label, "float64",
                                [*SHARDS, decomposition])
            if got != want:
                fail(f"{label}: per-step counts {got} differ from the "
                     f"single device's {want}")
            print(f"[main {label}] per-step counts equal to the single "
                  f"device's {want}", flush=True)
    # No scatter lane crosses a shard's seam (a dense deck); the stream deck
    # on the stretched mesh (its own 1,000,000 particles, vacuum: the
    # sweep transport's facet-heaviest case) sends lanes across them.
    os.mkdir(os.path.join(tmp, "stretched_stream"))
    stream = deck_copy(FLIGHT_DECKS[0], os.path.join(tmp, "stretched_stream"),
                       STRETCH)
    want, _ = kernel_run(stream, "f64 stretched stream", "float64", n=None)
    got, _ = kernel_run(stream, "f64 stretched stream spatial2d", "float64",
                        [*SHARDS, "spatial2d"], n=None)
    moved = res["runs"]["f64 stretched stream spatial2d"]["migrated"]
    if got != want or moved == 0:
        fail(f"f64 stretched stream on 2x2 blocks: per-step counts {got} "
             f"against the single device's {want}, {moved} lanes migrated")
    print(f"[main f64 stretched stream spatial2d] per-step counts equal to "
          f"the single device's {want}; {moved} lanes migrated", flush=True)
    return res


def restored_split_counts(ck: str, torch, driver, flight) -> list:
    """Per-step counts of steps 6-10 of a one-device kernel run of csp
    restored from `ck` over its rects split at the 2x2 blocks' grid lines
    (the geometry of spatial2d's windows)."""
    import dataclasses
    sim = driver.Simulation(driver.load_config(FLIGHT_DECKS[2]), quiet=True)
    # the census runs over its one shard's geometry
    sim.shards[0].geom = dataclasses.replace(
        sim.geom, rects=flight.split_rects(sim.geom.rects, [2000], [2000]))
    start = sim.restore(ck) + 1
    return [(m.nfacets, m.ncollisions)
            for m in (sim.step(t) for t in range(start, sim.cfg.niters + 1))]


def checkpoint_restore(tmp: str, torch, driver, flight, wrappers,
                       csp_counts: list) -> dict:
    """Phase 20.  Returns the npz's size, write and restore times and the
    launches of its main paths."""
    ck = os.path.join(tmp, "csp5.npz")
    csp = FLIGHT_DECKS[2]
    res = {"launches": [0, 0, 0, 0]}

    def run(argv, label):
        out, total, c = main_path(csp, torch, driver, wrappers, argv=argv,
                                  label=label)
        res["launches"] = [a + b for a, b in zip(
            res["launches"], check_kernel_path(label, out, c, passed=False))]
        return out, total

    out, _ = run(["--iterations", "5", "--checkpoint", ck], "csp 1-5")
    res["write_s"] = float(re.search(r"Wrote checkpoint .* in (\S+) s",
                                     out)[1])
    res["bytes"] = os.path.getsize(ck)
    if step_counts(out) != csp_counts[:5]:
        fail(f"csp 1-5: counts {step_counts(out)} differ from phase 7's")
    for argv, label in (([], "csp 6-10 restored"),
                        ([*SHARDS, "spatial2d"], "spatial2d csp 6-10 "
                                                 "restored")):
        out, total = run(["--restore", ck, *argv], label)
        got = re.search(r"Restored checkpoint at step 5 in (\S+) s", out)
        if got is None or "Iteration  1\n" in out:
            fail(f"{label}: did not resume at step 6")
        res[f"{label} restore_s"] = float(got[1])
        want = (csp_counts[5:] if not argv
                else restored_split_counts(ck, torch, driver, flight))
        rel = abs(total - CSP_OMP3_TALLY) / CSP_OMP3_TALLY
        print(f"[{label}] steps 6-10 counts equal to "
              f"{'phase 7' if not argv else 'a split-rect restored run'}: "
              f"{step_counts(out) == want}; tally {total:.9e}, rel {rel:.3e} "
              f"from omp3's", flush=True)
        if step_counts(out) != want or not rel <= 1e-3:
            fail(f"{label}: counts {step_counts(out)} (want {want}), tally "
                 f"rel {rel:.3e} from omp3's")
    print(f"[checkpoint] csp at step 5: {res['bytes']} bytes of npz, "
          f"written in {res['write_s']:.3f} s, restored in "
          f"{res['csp 6-10 restored restore_s']:.3f} s (one device) and "
          f"{res['spatial2d csp 6-10 restored restore_s']:.3f} s (2x2 "
          "blocks)", flush=True)
    return res


def dumps_and_trace(tmp: str, torch, driver, wrappers) -> dict:
    """Phase 21.  Returns the dump's and the trace's wall times beside the
    same runs without, and the launches of its main paths."""
    import numpy as np
    res = {"launches": [0, 0, 0, 0]}

    def run(deck, argv, label, passed=True):
        out, total, c = main_path(deck, torch, driver, wrappers, argv=argv,
                                  label=label)
        res["launches"] = [a + b for a, b in zip(
            res["launches"], check_kernel_path(label, out, c, passed))]
        return out, total

    dump = os.path.join(tmp, "dump")
    os.mkdir(dump)
    deck = deck_copy(FLIGHT_DECKS[0], dump, "visit_dump 1\n")
    shutil.copy("problems/neutral.tests", dump)
    run(FLIGHT_DECKS[0], [], "stream again")
    cwd = os.getcwd()
    os.chdir(dump)
    try:
        out, total = run(deck, [], "stream visit_dump")
    finally:
        os.chdir(cwd)
    energy = np.fromfile(os.path.join(dump, "energy1.dat"))
    density = np.fromfile(os.path.join(dump, "density1.dat"))
    live = int(re.search(r"Handled (\d+) particles", out)[1])
    files = sorted(f for f in os.listdir(dump) if f[-4:] in (".bov", ".dat"))
    print(f"[visit_dump] {files}: energy1.dat sums to {energy.sum():.12e} "
          f"(tally {total:.12e}), density1.dat to {density.sum():.0f} "
          f"(live {live}); wall {main_path.walls['stream visit_dump']:.2f} s "
          f"against {main_path.walls['stream again']:.2f} s without",
          flush=True)
    if (abs(energy.sum() - total) > 1e-12 * abs(total)
            or density.sum() != live or len(files) != 6):
        fail("the visit dumps do not hold the tally and the live count")

    trace = os.path.join(tmp, "trace")
    run(FLIGHT_DECKS[1], [], "split again", passed=False)
    run(FLIGHT_DECKS[1], ["--trace-dir", trace], "split traced",
        passed=False)
    path = os.path.join(trace, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in name for name in kernels) for k in TRACE_KERNELS}
    print(f"[trace] {os.path.getsize(path)} bytes, {len(events)} events, "
          f"{len(kernels)} CUDA kernels, of them {found}; wall "
          f"{main_path.walls['split traced']:.2f} s against "
          f"{main_path.walls['split again']:.2f} s without", flush=True)
    if not all(found.values()):
        fail(f"the trace names no {[k for k, v in found.items() if not v]}")
    res.update({k: main_path.walls[k] for k in (
        "stream again", "stream visit_dump", "split again", "split traced")})
    return res


def family_deck(path: str, d: dict, nparticles: int) -> str:
    """Phase 22's deck family `d` as a deck file at `path`."""
    problems = "".join(
        f"problem_{i} density={r[0]!r} energy=0.0 xpos={r[1]!r} "
        f"ypos={r[2]!r} width={r[3]!r} height={r[4]!r}\n"
        for i, r in enumerate(d["problems"]))
    with open(path, "w") as f:
        f.write(f"nparticles {nparticles}\ninitial_energy "
                f"{d['initial_energy']!r}\ndt 1.0e-7\nnx 48\nny 48\n"
                f"iterations {d['niters']}\nsource xpos={d['source'][0]!r} "
                f"ypos={d['source'][1]!r} width={d['source'][2]!r} "
                f"height={d['source'][3]!r}\n{problems}")
    return path


def oracle_on_card(torch, driver, decks=ORACLE_DECKS, low=False,
                   engine="plain", transports=("sweep", "flight"),
                   wrappers=None) -> dict:
    """Phase 22 (and phase 24's oracle runs: `low` fails a run in which no
    lane ended below THRESHOLD; phase 26's on the float64 kernels, with
    `engine` "kernel" on both transports).  Given `wrappers`, every count
    is set to 0 just before a run's steps and read just after, and a
    kernel run must have launched its transport's kernels (the sweep
    kernel, or the flight kernel and the segment deposit) and the begin
    kernel (one a step), no other transport's kernel and no plain version;
    returns those counts by family and transport."""
    import numpy as np
    from neutral_tpu_torch import ProblemRegion, SimConfig, SourceBox, oracle

    counts = {}
    for kind, d in decks.items():
        cfg = SimConfig(
            nx=48, ny=48, width=1.0, height=1.0, dt=1e-7, niters=d["niters"],
            nparticles=d["nparticles"], initial_energy=d["initial_energy"],
            source=SourceBox(*d["source"]),
            problems=tuple(ProblemRegion(*r) for r in d["problems"]),
            dtype="float64", tally_dtype="float64")
        t0 = time.perf_counter()
        tally, want, parts = oracle.run_config(cfg)
        t_oracle = time.perf_counter() - t0
        dead = np.array([p.dead for p in parts])
        for transport in transports:
            t0 = time.perf_counter()
            sim = driver.Simulation(cfg, transport=transport, engine=engine,
                                    quiet=True)
            if sim.engine != engine or sim.device.type != "cuda":
                fail(f"oracle {kind}: {sim.engine} engine on {sim.device}")
            if wrappers:
                reset_counts(wrappers)
            got = [dict(nf=m.nfacets, nc=m.ncollisions, nproc=m.nprocessed)
                   for m in (sim.step(t) for t in range(1, cfg.niters + 1))]
            card = sim.host_tally().reshape(tally.shape)
            wall = time.perf_counter() - t0
            if wrappers:
                c = counts[f"{kind} {transport}"] = read_counts(wrappers)
                begins = (c["begin_timestep_kernel"], c["begin_timestep"])
                ran = ((c["sweep_chunk_kernel"] > 0, c["flight_chunk_kernel"]
                        > 0 and c["deposit_segments_kernel"] > 0)
                       if transport == "sweep" else
                       (c["flight_chunk_kernel"] > 0
                        and c["deposit_segments_kernel"] > 0,
                        c["sweep_chunk_kernel"] > 0))
                if (engine == "kernel" and (
                        not ran[0] or ran[1] or c["sweep_chunk_plain"]
                        or c["flight_chunk_plain"]
                        or begins != (cfg.niters, 0))):
                    fail(f"oracle {kind} {transport}: counts {c} (want the "
                         f"{transport} transport's kernels, {cfg.niters} "
                         "begin launches and no plain version)")
            err = float(np.abs(card - tally).max() / np.abs(tally).max())
            if transport == "sweep":
                close = np.allclose(card, tally, rtol=1e-9, atol=1e-300)
            else:
                close = (abs(card.sum() - tally.sum())
                         <= 1e-11 * abs(tally.sum())
                         and np.allclose(card, tally, rtol=1e-7, atol=1e-30))
            below = int((sim.state.energy < THRESHOLD).sum())
            print(f"[oracle {kind} {transport} {engine}] counts {got} "
                  f"(oracle's equal: {got == want}); tally "
                  f"{card.sum():.15e} against "
                  f"{tally.sum():.15e}, largest cell difference {err:.3e} "
                  f"of the largest cell; {below} lanes ended below "
                  f"{THRESHOLD} eV; card {wall:.2f} s, oracle "
                  f"{t_oracle:.2f} s", flush=True)
            if low and below == 0:
                fail(f"oracle {kind} {transport}: no lane went below "
                     f"{THRESHOLD} eV")
            if (got != want or tally.sum() == 0.0 or not close
                    or not np.array_equal(sim.state.dead.cpu().numpy(),
                                          dead)):
                fail(f"oracle {kind} {transport}: the {engine} engine on "
                     "the card differs from the oracle")
    return counts


def low_energy(tmp: str, torch, driver, transport, sweep_kernel, fields,
               wrappers) -> dict:
    """Phase 24.  Returns the sweep kernel's comparisons and the launches
    of the main paths."""
    runs, launches = [], 0
    for label, energy in LOW_ENERGY.items():
        d = dict(ORACLE_DECKS["scatter"], initial_energy=energy)
        deck = family_deck(os.path.join(tmp, f"lowenergy_{energy!r}.params"),
                           d, MODE_N)
        # A lane here ends within a few events: one event per launch
        # still takes the census through several launches.
        r = compare(MODE_N, torch, driver, transport, sweep_kernel, fields,
                    deck=deck, label=f"low energy {label}", events=1)
        out, _, c = main_path(deck, torch, driver, wrappers,
                              label=f"low energy {label}")
        if ("Engine: kernel." not in out or "Transport: sweep." not in out
                or c["sweep_chunk_kernel"] <= 0 or c["sweep_chunk_plain"]):
            fail(f"low energy {label} main path: counts {c} (want sweep "
                 "kernel launches and no plain run)")
        step1 = step_counts(out)[0]
        if step1 != (r["facets"], r["collisions"]):
            fail(f"low energy {label}: step 1 counts {step1} differ from "
                 f"the comparison's {(r['facets'], r['collisions'])}")
        print(f"[low energy {label}] kernel equal to plain at {MODE_N} "
              f"lanes, {r['below_threshold']} of them ended below "
              f"{THRESHOLD} eV; main path step 1 {step1}, equal to the "
              f"comparison's; {c['sweep_chunk_kernel']} sweep launches",
              flush=True)
        if r["below_threshold"] == 0:
            fail(f"low energy {label}: no lane went below {THRESHOLD} eV")
        runs.append(r)
        launches += c["sweep_chunk_kernel"]
    oracle_on_card(torch, driver, low=True, decks={
        f"low energy {label}": dict(ORACLE_DECKS["scatter"],
                                    initial_energy=energy)
        for label, energy in LOW_ENERGY.items()})
    return {"runs": runs, "launches": launches}


def begin_compare(torch, driver, transport, begin_kernel, deck: str,
                  n: int, label: str, window=None,
                  dtype: str = "float32") -> dict:
    """Phase 25 on one deck at n particles: the begin kernel against
    transport.begin_timestep on step 1's injected state (every lane live)
    and on a copy with a seeded quarter of its lanes dead and its clocks,
    mean free paths and counters scrambled: all 14 fields bitwise and the
    live count equal, the caller's state unchanged.  Returns the kernel's
    device time on step 1's state (BEGIN_REPS calls in one CUDA graph), its
    time on the clock, the plain version's and the bound."""
    import dataclasses
    from neutral_tpu_torch.particles import STATE_FIELDS

    cfg = driver.load_config(deck).with_(nparticles=n, expected_tally=None)
    if dtype != cfg.dtype:
        cfg = cfg.with_(dtype=dtype, tally_dtype=dtype)
    sim = driver.Simulation(cfg, device="cuda", engine="plain",
                            transport="sweep", quiet=True)
    geom, win = sim.geom, {}
    if window is not None:
        x_off, y_off, nx, ny = window
        geom = dataclasses.replace(geom, nx=nx, ny=ny)
        win = {"x_off": x_off, "y_off": y_off}
    tab = sim.cs_scatter
    gen = torch.Generator(device="cuda").manual_seed(25)
    scrambled = sim.state.clone()
    scrambled.dead = torch.rand(n, device="cuda", generator=gen) < 0.25
    scrambled.dt_to_census.uniform_(0.0, cfg.dt, generator=gen)
    scrambled.mfp_to_collision.uniform_(0.0, 5.0, generator=gen)
    scrambled.counter.random_(0, 1000, generator=gen)
    for key, state in ((1, sim.state), (2, scrambled)):
        before = state.clone()
        got, live = begin_kernel.begin_timestep_kernel(
            state, geom, tab, cfg.dt, key, **win)
        want = transport.begin_timestep(state, geom, tab, cfg.dt, key, **win)
        torch.cuda.synchronize()
        bad = [f for f in STATE_FIELDS
               if not torch.equal(bits(torch, getattr(got, f)),
                                  bits(torch, getattr(want, f)))]
        changed = differing_field(state, before, torch, STATE_FIELDS)
        nlive = int((~state.dead).sum())
        if bad or changed or int(live) != nlive:
            fail(f"begin {label} (master key {key}): fields {bad} differ "
                 f"from the plain version's, caller's {changed} changed, "
                 f"live {int(live)} against {nlive}")
    args = (sim.state, geom, tab, cfg.dt, 1)
    ms = graph_ms(torch, lambda: begin_kernel.begin_timestep_kernel(
        *args, **win), BEGIN_REPS)
    wall_ms = min(timed(torch, begin_kernel.begin_timestep_kernel, *args,
                        **win)[0] for _ in range(3))
    plain_ms = sorted(timed(torch, transport.begin_timestep, *args, **win)[0]
                      for _ in range(3))[1]
    live = int((~sim.state.dead).sum())
    extra = 0 if tab.analytic else table_bytes(tab.table_layout)
    if dtype == "float64":
        # the energy and both written floats 4 bytes more, a dead lane's old
        # mean free path 8; the interpolation's and mfp's divisions, the
        # lookup's two square roots and the logarithm in FP64 instructions
        b = bound(n * (BEGIN_LANE_BYTES + 12)
                  + (n - live) * 2 * BEGIN_DEAD_BYTES + extra,
                  live * DRAW_OPS[cfg.rng],
                  live * f64_ops({"div": 2, "sqrt": 2, "log": 1,
                                  "plain": 8}), PEAK_F64_INSTR)
    else:
        b = bound(n * BEGIN_LANE_BYTES + (n - live) * BEGIN_DEAD_BYTES
                  + extra, live * DRAW_OPS[cfg.rng], live * FLOPS_BEGIN)
    print(f"[begin {label}] {n} lanes: kernel {ms:.4f} ms (device, "
          f"{BEGIN_REPS} calls in one CUDA graph; {wall_ms:.3f} ms on the "
          f"clock), plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}); all {len(STATE_FIELDS)} fields and the live "
          "count equal on step 1's state and on a scrambled one with dead "
          "lanes", flush=True)
    return {"ms": ms, "wall_ms": wall_ms, "plain_ms": plain_ms,
            "max_abs_err": 0.0, "n": n, "live": live, **b}


def begin_phase(tmp: str, torch, driver, transport,
                dtype: str = "float32") -> dict:
    """Phase 25 (and phase 26 in float64): the begin kernel against its
    plain version in every mode of the main paths.  Returns each mode's
    comparison."""
    import numpy as np
    from neutral_tpu_torch import begin_kernel
    from neutral_tpu_torch.xs import resonance_log_table, write_cs_file

    dirs = {}
    for d in ("pcg", "table", "grid"):
        dirs[d] = os.path.join(tmp, d)
        os.mkdir(dirs[d])
    keys, values = resonance_log_table()
    for fname in ("elastic_scatter.cs", "capture.cs"):
        write_cs_file(os.path.join(dirs["table"], fname), keys, values)
    cfg = driver.load_config(SCATTER)
    rng = np.random.default_rng(7)           # phase 10's random grid
    dens = rng.uniform(1.0e3, 2.0e4, size=(cfg.ny, cfg.nx))
    dens[rng.random((cfg.ny, cfg.nx)) < 0.25] = 0.0
    np.save(os.path.join(dirs["grid"], "dens.npy"), dens)
    del dens
    name = lambda d: d.split("/")[-1].split(".")[0]  # noqa: E731
    modes = [("scatter", SCATTER, COMPARE_SIZES[-1], None)]
    modes += [(name(d), d, MODE_N, None) for d in FLIGHT_DECKS]
    modes += [(f"pcg64si {name(d)}", deck_copy(d, dirs["pcg"],
                                               "rng pcg64si\n"), MODE_N, None)
              for d in (SCATTER, *FLIGHT_DECKS)]
    modes += [(f"table {name(d)}", deck_copy(d, dirs["table"]), MODE_N, None)
              for d in (SCATTER, FLIGHT_DECKS[1])]
    modes.append(("grid scatter", deck_copy(
        SCATTER, dirs["grid"], "density_file dens.npy\n"), MODE_N, None))
    modes += [(f"window {name(d)}", d, MODE_N, BLOCK)
              for d in (SCATTER, FLIGHT_DECKS[1])]
    for label, energy in LOW_ENERGY.items():
        d = dict(ORACLE_DECKS["scatter"], initial_energy=energy)
        modes.append((f"low energy {label}", family_deck(
            os.path.join(tmp, f"lowenergy_{energy!r}.params"), d, MODE_N),
            MODE_N, None))
    res = {}
    for label, deck, n, window in modes:
        res[label] = begin_compare(torch, driver, transport, begin_kernel,
                                   deck, n, label, window, dtype)
        torch.cuda.empty_cache()
    return res


def inject_compare(torch, driver, deck: str, label: str, dtype: str,
                   n: int | None = None) -> dict:
    """Phase 31 on one deck at n particles (its own count if None) in
    `dtype`: the inject kernel against particles.inject_particles on the
    mesh and source box that Simulation gives it (the cell-local frame on
    the sweep transport in float32 with a pitch), all 14 fields bitwise,
    one counted launch.  Returns the kernel's device time (INJECT_REPS calls in one
    CUDA graph), its time on the clock, the plain version's and the
    bound."""
    from neutral_tpu_torch.inject_kernel import inject_particles_kernel
    from neutral_tpu_torch.particles import STATE_FIELDS, inject_particles

    cfg = driver.load_config(deck)
    cfg = cfg.with_(nparticles=n or cfg.nparticles, expected_tally=None,
                    dtype=dtype, tally_dtype=dtype)
    sim = driver.Simulation(cfg, device="cuda", engine="plain", quiet=True)
    n = cfg.nparticles
    kw = dict(nparticles=n, initial_energy=cfg.initial_energy, dt=cfg.dt,
              dtype=sim.dtype, device=sim.device, **sim.source())
    launches = inject_particles_kernel.launches
    got = inject_particles_kernel(sim.mesh, **kw)
    want = inject_particles(sim.mesh, **kw)
    torch.cuda.synchronize()
    bad = [f for f in STATE_FIELDS
           if not torch.equal(bits(torch, getattr(got, f)),
                              bits(torch, getattr(want, f)))]
    if bad or inject_particles_kernel.launches != launches + 1:
        fail(f"inject {label}: fields {bad} differ from the plain "
             f"version's; {inject_particles_kernel.launches - launches} "
             "launches for one call")
    del got, want
    ms = graph_ms(torch, lambda: inject_particles_kernel(sim.mesh, **kw),
                  INJECT_REPS)
    wall_ms = min(timed(torch, inject_particles_kernel, sim.mesh, **kw)[0]
                  for _ in range(3))
    plain_ms = sorted(timed(torch, inject_particles, sim.mesh, **kw)[0]
                      for _ in range(3))[1]
    real = 4 if dtype == "float32" else 8
    edges = 0 if sim.mesh.uniform else (cfg.nx + cfg.ny + 2) * real
    b = bound(n * (9 * real + INJECT_INT_BYTES) + edges,
              2 * n * DRAW_OPS[cfg.rng], 0)
    frame, uniform = sim.coords(), bool(sim.mesh.uniform)
    print(f"[inject {label}] {n} lanes, {cfg.rng}, "
          f"{'uniform' if uniform else 'stretched'} mesh, {frame} "
          f"frame: kernel {ms:.4f} ms (device, {INJECT_REPS} calls in one "
          f"CUDA graph; {wall_ms:.3f} ms on the clock), plain "
          f"{plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}); all {len(STATE_FIELDS)} fields equal bit "
          "for bit, one launch", flush=True)
    del sim
    torch.cuda.empty_cache()
    return {"ms": ms, "wall_ms": wall_ms, "plain_ms": plain_ms,
            "max_abs_err": 0.0, "n": n, "rng": cfg.rng, "frame": frame,
            "uniform": uniform, **b}


def inject_phase(tmp: str, torch, driver) -> dict:
    """Phase 31: the inject kernel against its plain version, in float32
    and float64, on each deck of the benchmark at its own count (scatter
    10,000,000, csp and stream 1,000,000), on scatter at 1,000,000, on a
    pcg64si copy of stream and on a stretched copy of scatter (no pitch:
    the edge search, the global frame).  Returns each mode's comparison
    by working type."""
    modes = [("scatter", SCATTER, None), ("csp", FLIGHT_DECKS[2], None),
             ("stream", FLIGHT_DECKS[0], None),
             ("scatter 1M", SCATTER, MODE_N),
             ("pcg64si stream", deck_copy(FLIGHT_DECKS[0], tmp,
                                          "rng pcg64si\n"), None),
             ("stretched scatter 1M", deck_copy(SCATTER, tmp, STRETCH),
              MODE_N)]
    return {dtype: {label: inject_compare(torch, driver, deck, label, dtype,
                                          n)
                    for label, deck, n in modes}
            for dtype in ("float32", "float64")}


def inject_entries(inject: dict, launches: dict) -> list:
    """The inject kernel's entries of the kernels line, float32 and
    float64: scatter's 10,000,000 lanes as the main comparison, every
    mode's, and the launches of the main paths (`launches`, by label; a
    float64 run's label starts with "f64 ")."""
    out = []
    for dtype, sfx in (("float32", ""), ("float64", "_f64")):
        modes, top = inject[dtype], inject[dtype]["scatter"]
        mine = {k: v for k, v in launches.items()
                if k.startswith("f64 ") == (dtype == "float64")}
        out.append({
            "name": "inject_kernel" + sfx, "route": "cuda",
            "source": "neutral_tpu_torch/csrc/inject.cu",
            "replaces": "neutral_tpu/particles.py:267",
            "launches": sum(mine.values()), "max_abs_err": 0.0,
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "wall_ms": top["wall_ms"],
            "launches_per_main_path": mine, "modes": modes,
            "shape": f"the scatter deck's {top['n']} particles, 4000x4000 "
                     f"mesh, the {top['frame']} frame; ms is the device "
                     f"time of one of {INJECT_REPS} calls captured in one "
                     "CUDA graph, wall_ms one call on the host clock, "
                     "plain_ms particles.inject_particles' on the host "
                     "clock (median of 3); bound: the 14 fields written "
                     "once and two pair draws a lane, float work not "
                     "counted; modes: csp and stream at 1,000,000, scatter "
                     "at 1,000,000, a pcg64si stream and a stretched "
                     "scatter; launches: one a single-device Simulation "
                     "on the kernel engine, summed over every main path"})
    return out


def f64_steps(torch, driver) -> dict:
    """Phase 26: one full-size step of each flight deck in float64 on the
    flight transport's kernels and on the sweep kernel (auto's choice),
    timed; returns {deck: {"kernel flight"/"kernel sweep": (seconds,
    facets, collisions)}}."""
    res = {}
    for deck in FLIGHT_DECKS:
        name = deck.split("/")[-1].split(".")[0]
        one = driver.load_config(deck).with_(
            niters=1, expected_tally=None, dtype="float64",
            tally_dtype="float64")
        times = {}
        for transport_name in ("flight", "sweep"):
            sim = driver.Simulation(one, transport=transport_name,
                                    quiet=True)
            if sim.engine != "kernel":
                fail(f"f64 step {name}: the {sim.engine} engine on the "
                     f"{transport_name} transport")
            m = sim.step(1)
            times[f"{sim.engine} {transport_name}"] = (
                m.step_time, m.nfacets, m.ncollisions)
            del sim
            torch.cuda.empty_cache()
        print(f"[f64 step {name}] {one.nparticles} particles, step 1: "
              + "; ".join(f"{k} {t:.4f} s ({nf} facets, {nc} collisions)"
                          for k, (t, nf, nc) in times.items()), flush=True)
        res[name] = times
    return res


def float64_phase(tmp: str, torch, driver, transport, sweep_kernel,
                  fields, wrappers, log: str) -> dict:
    """Phase 26: float64 on the card's kernels.  Returns the float64 sweep
    kernel's comparisons, the lookup's, the begin kernel's and the
    launches of its main paths."""
    import numpy as np
    from neutral_tpu_torch.xs import resonance_log_table, write_cs_file

    t_phase = time.perf_counter()
    res = {"sweep": {}, "launches": {"sweep": 0, "table": 0}, "lookup": {},
           "registers": sweep_registers(log, "double")}
    print(f"[f64] the sweep kernel's float64 main instantiation (analytic, "
          f"regions, threefry) uses {res['registers']} registers", flush=True)

    # -- the sweep kernel against its plain version, every instantiation --
    keys, values = resonance_log_table()
    k2, v2 = resonance_log_table(3001)
    cfg = driver.load_config(SCATTER)
    rng = np.random.default_rng(7)           # phase 10's random grid
    dens = rng.uniform(1.0e3, 2.0e4, size=(cfg.ny, cfg.nx))
    dens[rng.random((cfg.ny, cfg.nx)) < 0.25] = 0.0
    grid_file = os.path.join(tmp, "dens.npy")
    np.save(grid_file, dens)
    del dens

    def deck_dir(name, table=False, capture=False, grid=False, pcg=False):
        d = os.path.join(tmp, name)
        os.mkdir(d)
        if table or capture:
            write_cs_file(os.path.join(d, "elastic_scatter.cs"), keys, values)
            k, v = (k2, 0.5 * v2) if capture else (keys, values)
            write_cs_file(os.path.join(d, "capture.cs"), k, v)
        if grid:
            os.symlink(grid_file, os.path.join(d, "dens.npy"))
        return deck_copy(SCATTER, d, ("rng pcg64si\n" if pcg else "")
                         + ("density_file dens.npy\n" if grid else ""))

    low = dict(ORACLE_DECKS["scatter"], initial_energy=LOW_ENERGY[
        "crossing 1.01e-2"])
    modes = [
        ("analytic", SCATTER, F64_MAIN_N, None),
        ("pcg64si", deck_dir("pcg", pcg=True), F64_MODE_N, None),
        ("table", deck_dir("table", table=True), F64_MODE_N, None),
        ("table pcg64si", deck_dir("table_pcg", table=True, pcg=True),
         F64_MODE_N, None),
        ("table distinct", deck_dir("capture", capture=True), F64_MODE_N,
         None),
        ("grid", deck_dir("grid", grid=True), F64_MODE_N, None),
        ("grid pcg64si", deck_dir("grid_pcg", grid=True, pcg=True),
         F64_MODE_N, None),
        ("grid table", deck_dir("grid_table", grid=True, table=True),
         F64_MODE_N, None),
        ("grid table pcg64si", deck_dir("grid_table_pcg", grid=True,
                                        table=True, pcg=True),
         F64_MODE_N, None),
        ("window", SCATTER, F64_MODE_N, BLOCK),
        ("low energy", family_deck(os.path.join(tmp, "low.params"), low,
                                   F64_MODE_N), F64_MODE_N, None),
    ]
    for mode, deck, n, window in modes:
        r = compare(n, torch, driver, transport, sweep_kernel, fields,
                    deck=deck, label=f"f64 {mode}", window=window,
                    events=1 if mode == "low energy" else 64,
                    dtype="float64")
        energy = r.pop("energy", None)
        res["sweep"][mode] = mode_entry([r], f"{deck}, {n} particles, "
                                        "one census, float64")
        if mode == "table":
            e = energy.repeat(-(-F64_MAIN_N // n))[:F64_MAIN_N]
            res["lookup"]["census energies"] = compare_lookup(
                torch, keys, values, e, "f64 30,000 entries, census energies")
            e_log = torch.from_numpy(log_uniform_f64(F64_MAIN_N)).cuda()
            res["lookup"]["log-uniform"] = compare_lookup(
                torch, keys, values, e_log, "f64 30,000 entries, log-uniform")
        torch.cuda.empty_cache()

    # -- the begin kernel against its plain version, every mode ----------
    begin_dir = os.path.join(tmp, "begin")
    os.mkdir(begin_dir)
    res["begin"] = begin_phase(begin_dir, torch, driver, transport,
                               "float64")

    # -- the main paths through the CLI ----------------------------------
    def f64_path(deck, label, argv=()):
        out, total, c = main_path(deck, torch, driver, wrappers,
                                  argv=["--dtype", "float64", *argv],
                                  label=label)
        if ("Engine: kernel." not in out or "Transport: sweep." not in out
                or c["sweep_chunk_kernel"] <= 0 or c["sweep_chunk_plain"]
                or c["flight_chunk_kernel"] or c["flight_chunk_plain"]):
            fail(f"{label}: counts {c} (want the float64 sweep kernel and "
                 "no plain sweep)")
        res["launches"]["sweep"] += c["sweep_chunk_kernel"]
        return out, total, c

    out, _, _ = f64_path(SCATTER, "f64 scatter")
    if "PASSED validation." not in out:
        fail("float64 scatter did not print 'PASSED validation.'")
    scatter_counts = step_counts(out)
    for deck in FLIGHT_DECKS:
        name = deck.split("/")[-1].split(".")[0]
        out, total, _ = f64_path(deck, f"f64 {name}")
        if name == "csp":
            rel = abs(total - CSP_OMP3_TALLY) / CSP_OMP3_TALLY
            print(f"[main f64 csp] tally {total:.9e} against omp3's "
                  f"{CSP_OMP3_TALLY:.7e}: rel {rel:.3e}")
            if not rel <= 1e-3:
                fail(f"float64 csp tally is {rel:.3e} from omp3's (> 1e-3)")
        elif "PASSED validation." not in out:
            fail(f"float64 {name} did not print 'PASSED validation.'")
        if name == "stream":
            nf, _ = step_counts(out)[0]
            print(f"[main f64 stream] {nf} facets in step 1, "
                  f"{step_seconds(out)[0]:.4f} s", flush=True)
    out, _, c = f64_path(deck_dir("table_main", table=True), "f64 table "
                         "scatter")
    if "PASSED validation." not in out:
        fail("float64 table scatter did not print 'PASSED validation.'")
    res["launches"]["table"] = c["sweep_chunk_kernel"]
    out, _, _ = f64_path(SCATTER, "f64 scatter spatial", [*SHARDS, "spatial"])
    if step_counts(out) != scatter_counts:
        fail(f"float64 scatter on 4 y-slabs: counts {step_counts(out)} "
             f"differ from the single device's {scatter_counts}")
    print(f"[main f64 scatter spatial] per-step counts equal to the single "
          f"device's {scatter_counts}", flush=True)

    res["steps"] = f64_steps(torch, driver)

    # -- the oracle's families on the float64 kernels of both transports,
    # counted apart from the main paths ---------------------------------
    res["oracle_launches"] = oracle_on_card(
        torch, driver, engine="kernel", transports=("sweep", "flight"),
        wrappers=wrappers)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[f64] phase 26 took {res['seconds']:.1f} s", flush=True)
    return res


def kernel_resources(log: str, names: tuple, real: str,
                     tally: str | None = None) -> dict:
    """ptxas's registers and spill bytes, by demangled name, of the
    kernels in the build's log whose names contain one of `names` and whose
    template arguments end with the working type `real` (float or double)
    and the tally type `tally` (None: `real`)."""
    from neutral_tpu_torch import measure
    found = {}
    for name, body in re.findall(r"Compiling entry function '([^']*)'"
                                 r"(.*?)(?=Compiling entry function|\Z)",
                                 log, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", body)
        if regs and any(n in name for n in names):
            found[name] = {"registers": int(regs[1]),
                           "spill_stores": int(spill[1]) if spill else 0,
                           "spill_loads": int(spill[2]) if spill else 0}
    names_of = measure._demangle(sorted(found))
    return {names_of[k].replace("(anonymous namespace)::", ""): v
            for k, v in found.items()
            if re.search(rf"\b{real}, {tally or real}>\(", names_of[k])}


def float64_flight_phase(tmp: str, torch, driver, transport, flight,
                         flight_kernel, raster, raster_kernel, fields,
                         wrappers, log) -> dict:
    """Phase 28: float64 on the flight transport's kernels.  Returns the
    float64 flight kernel's comparisons (per mode), the deposit's, the
    main paths' launches and runs, and the registers of both kernels'
    float64 instantiations."""
    from neutral_tpu_torch.xs import resonance_log_table, write_cs_file

    t_phase = time.perf_counter()
    res = {"flight": {}, "deposit": {}, "runs": {},
           "launches": {"flight": 0, "deposit": 0, "overflows": 0},
           "path_launches": {}}
    res["registers"] = {
        "flight": kernel_resources(log, ("flight_kernel",), "double"),
        "deposit": kernel_resources(log, ("count_kernel", "scan_kernel",
                                          "fill_kernel", "tile_kernel"),
                                    "double"),
        "flight_float32": kernel_resources(log, ("flight_kernel",),
                                           "float")}
    for group, kernels in res["registers"].items():
        for name, r in kernels.items():
            print(f"[f64 flight] {group}: {name}: {r['registers']} "
                  f"registers, spill {r['spill_stores']} / "
                  f"{r['spill_loads']} bytes", flush=True)
    if len(res["registers"]["flight"]) != 4:
        fail(f"the build log holds {len(res['registers']['flight'])} "
             "float64 flight instantiations (want 4)")

    # -- the flight kernel against its plain version in float64 ----------
    keys, values = resonance_log_table()

    def deck_dir(name, src, table=False, pcg=False):
        d = os.path.join(tmp, name)
        os.mkdir(d)
        if table:
            for f in ("elastic_scatter.cs", "capture.cs"):
                write_cs_file(os.path.join(d, f), keys, values)
        return deck_copy(src, d, "rng pcg64si\n" if pcg else "")

    split = FLIGHT_DECKS[1]
    modes = [
        ("analytic", FLIGHT_DECKS, F64_MAIN_N, None, True),
        ("pcg64si", [deck_dir("pcg", split, pcg=True)], F64_MODE_N, None,
         False),
        ("table", [deck_dir("table", split, table=True)], F64_MODE_N, None,
         False),
        ("table pcg64si", [deck_dir("table_pcg", split, table=True,
                                    pcg=True)], F64_MODE_N, None, False),
        ("window", [split, FLIGHT_DECKS[0]], F64_MODE_N, BLOCK, False),
    ]
    rows = {}
    for mode, decks, n, window, small in modes:
        runs = [compare_flight(d, torch, driver, transport, flight,
                               flight_kernel, fields, label=f"f64 {mode}",
                               window=window, small=small, dtype="float64",
                               n=n)
                for d in decks]
        for d, r in zip(decks, runs):
            name = d.split("/")[-1].split(".")[0]
            segs = r.pop("segs")
            if mode in ("analytic", "window"):
                rows[f"{mode} {name}"] = segs
            if mode == "analytic":
                res.setdefault("per_deck", {})[name] = {
                    k: r[k] for k in ("ms", "plain_ms", "deposit_ms",
                                      "plain_deposit_ms", "census_ms",
                                      "rows")} | work_bound(r)
        res["flight"][mode] = mode_entry(
            runs, f"{' + '.join(d.split('/')[-1] for d in decks)}, {n} "
            "particles each, one step-1 census each, float64"
            + (f", in the window {window}" if window else ""))
        torch.cuda.empty_cache()

    # -- the segment deposit against its plain version on those rows (the
    # window's of split and stream in one tally: split's window, the dense
    # half, may emit none) ----------------------------------------------
    geom = driver.make_geometry(driver.load_config(split))
    for label in ("analytic stream", "analytic split", "analytic csp"):
        res["deposit"][label] = compare_raster(
            rows[label], torch, geom.nx, geom.ny, raster, raster_kernel,
            f"f64 {label}")
    res["deposit"]["window split + stream"] = compare_raster(
        rows["window split"] + rows["window stream"], torch, BLOCK[2],
        BLOCK[3], raster, raster_kernel, "f64 window split + stream")
    del rows
    torch.cuda.empty_cache()

    # -- the main paths: --transport flight --dtype float64 ---------------
    f64_flight = ["--transport", "flight", "--dtype", "float64"]
    single = {}
    for deck, argv in [(d, []) for d in FLIGHT_DECKS] + [
            (FLIGHT_DECKS[0], [*SHARDS, "spatial2d"])]:
        name = deck.split("/")[-1].split(".")[0]
        label = f"f64 flight {name}" + (" spatial2d" if argv else "")
        out, total, c = main_path(deck, torch, driver, wrappers,
                                  argv=[*f64_flight, *argv], label=label)
        if ("Engine: kernel." not in out or "Transport: flight." not in out
                or c["flight_chunk_kernel"] <= 0
                or c["deposit_segments_kernel"] <= 0
                or c["begin_timestep_kernel"] <= 0
                or c["flight_chunk_plain"] or c["sweep_chunk_plain"]
                or c["sweep_chunk_kernel"] or c["begin_timestep"]):
            fail(f"{label}: counts {c} (want the float64 flight, deposit "
                 "and begin kernels and no plain version)")
        if name == "csp":
            rel = abs(total - CSP_OMP3_TALLY) / CSP_OMP3_TALLY
            print(f"[main {label}] tally {total:.9e} against omp3's "
                  f"{CSP_OMP3_TALLY:.7e}: rel {rel:.3e}")
            if not rel <= 1e-3:
                fail(f"{label}: tally is {rel:.3e} from omp3's (> 1e-3)")
        elif "PASSED validation." not in out:
            fail(f"{label} did not print 'PASSED validation.'")
        counts = step_counts(out)
        if argv:
            if counts != single[name]:
                fail(f"{label}: per-step counts {counts} differ from the "
                     f"single device's {single[name]}")
            print(f"[main {label}] per-step counts equal to the single "
                  f"device's {counts}", flush=True)
        else:
            single[name] = counts
        res["launches"]["flight"] += c["flight_chunk_kernel"]
        res["launches"]["deposit"] += c["deposit_segments_kernel"]
        res["launches"]["overflows"] += c["deposit_segments_kernel.overflows"]
        res["path_launches"][label] = {
            k: c[k] for k in ("flight_chunk_kernel", "deposit_segments_kernel",
                              "begin_timestep_kernel")}
        res["runs"][label] = {"counts": counts, "step_s": step_seconds(out),
                              "tally": total}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[f64 flight] phase 28 took {res['seconds']:.1f} s", flush=True)
    return res


def mixed_run(torch, driver, wrappers, deck: str, label: str, state: str,
              tally: str, transport_name: str = "auto",
              decomposition: str | None = None, want: list | None = None,
              want_transport: str | None = None) -> dict:
    """Phase 29's main path: `deck` at full size through
    driver.make_simulation (one device, or 4 shards on the card under
    `decomposition`) in a `state` state with a `tally` tally, every count
    set to 0 just before and read just after.  Fails unless the kernel
    engine ran it on `want_transport`, with its transport's kernels, the
    begin kernel once a census and shard and no plain version, its tally
    of the tally's type within 1e-3 of the golden (csp: omp3's), and, when
    `want` is given, those per-step counts.  Returns its per-step counts,
    step seconds, tally, relative error and counts."""
    cfg = driver.load_config(deck).with_(dtype=state, tally_dtype=tally)
    devices = [torch.device("cuda", 0)] * (4 if decomposition else 1)
    kw = {} if transport_name == "auto" else {"transport": transport_name}
    reset_counts(wrappers)
    t0 = time.perf_counter()
    sim = driver.make_simulation(cfg, decomposition or "replicated",
                                 devices, quiet=True, **kw)
    total = sim.run()
    wall = time.perf_counter() - t0
    c = read_counts(wrappers)
    counts = [(m.nfacets, m.ncollisions) for m in sim.step_metrics]
    steps = [m.step_time for m in sim.step_metrics]
    tallies = ([sh.tally for sh in sim.shards] if decomposition
               else [sim.tally])
    kernel = ("sweep_chunk_kernel" if sim.transport == "sweep"
              else "flight_chunk_kernel")
    censuses = len(steps) * len(devices)
    if (sim.engine != "kernel" or sim.transport != want_transport
            or sim.dtype != getattr(torch, state)
            or any(t.dtype != getattr(torch, tally) for t in tallies)
            or c[kernel] <= 0
            or (sim.transport == "flight"
                and c["deposit_segments_kernel"] <= 0)
            or c["begin_timestep_kernel"] != censuses
            or any(c[k] for k in ("sweep_chunk_plain", "flight_chunk_plain",
                                  "deposit_segments_plain",
                                  "begin_timestep"))):
        fail(f"{label}: engine {sim.engine}, transport {sim.transport}, "
             f"state {sim.dtype}, tallies "
             f"{sorted({str(t.dtype) for t in tallies})}, counts {c} (want "
             f"the {want_transport} transport's {state}/{tally} kernels, "
             f"{censuses} begin launches and no plain version)")
    check_inject(label, len(devices) if decomposition else 1, True, c)
    expected = (CSP_OMP3_TALLY if "csp" in os.path.basename(deck)
                else cfg.expected_tally)
    rel = abs(total - expected) / abs(expected)
    print(f"[main {label}] {sim.transport} transport, {len(devices)} "
          f"device(s): tally {total:.9e} against {expected:.9e} (rel "
          f"{rel:.3e}); counts {counts}; steps "
          + ", ".join(f"{t:.4f}" for t in steps) + f" s; wall {wall:.1f} s; "
          f"launches {c}", flush=True)
    if not rel <= 1e-3:
        fail(f"{label}: tally {total:.9e} is {rel:.3e} from {expected:.9e} "
             "(> 1e-3)")
    if want is not None and counts != want:
        fail(f"{label}: per-step counts {counts} differ from the single "
             f"device's {want}")
    del sim
    torch.cuda.empty_cache()
    return {"counts": counts, "step_s": steps, "tally": total, "rel": rel,
            "wall_s": wall, "transport": want_transport,
            "launches": {k: c[k] for k in (
                kernel, "deposit_segments_kernel",
                "deposit_segments_kernel.overflows",
                "begin_timestep_kernel")}}


def mixed_phase(tmp: str, torch, driver, transport, flight, sweep_kernel,
                flight_kernel, raster, raster_kernel, fields, wrappers,
                log) -> dict:
    """Phase 29: a state and a tally of different types on the kernels.
    Returns, per pair, the sweep, flight and deposit kernels'
    comparisons, their registers and the main paths' runs and
    launches."""
    import numpy as np
    from neutral_tpu_torch.xs import resonance_log_table, write_cs_file

    t_phase = time.perf_counter()
    keys, values = resonance_log_table()
    cfg = driver.load_config(SCATTER)
    rng = np.random.default_rng(7)           # phase 10's random grid
    dens = rng.uniform(1.0e3, 2.0e4, size=(cfg.ny, cfg.nx))
    dens[rng.random((cfg.ny, cfg.nx)) < 0.25] = 0.0
    grid_file = os.path.join(tmp, "dens.npy")
    np.save(grid_file, dens)
    del dens

    def deck_dir(name, src, extra, table=False, grid=False):
        d = os.path.join(tmp, name.replace(" ", "_"))
        os.mkdir(d)
        if table:
            for fname in ("elastic_scatter.cs", "capture.cs"):
                write_cs_file(os.path.join(d, fname), keys, values)
        if grid:
            os.symlink(grid_file, os.path.join(d, "dens.npy"))
        return deck_copy(src, d, extra
                         + ("density_file dens.npy\n" if grid else ""))

    # Every sweep instantiation: (cross-sections, density, draws) x facet
    # edges (the uniform pitch, or the stretched mesh's edge arrays).  Each
    # plain census costs its lanes' longest history in sweeps (on scatter
    # ~700 collisions, from 1e3 eV down to an absorption below 1 eV: some
    # 7-9 s), so every mode but the main one has its lanes born at
    # MIXED_E0: the same lanes and mesh, every event kind and flush, fewer
    # events a lane.
    cut = f"initial_energy {MIXED_E0!r}\n"
    sweep_decks = {}
    for edges, stretch in (("pitch", ""), ("edge array", STRETCH)):
        for xs in ("analytic", "table"):
            for density in ("regions", "grid"):
                for draws in ("threefry", "pcg64si"):
                    mode = f"{xs} {density} {draws} {edges}"
                    sweep_decks[mode] = deck_dir(
                        mode, SCATTER, stretch + (
                            "rng pcg64si\n" if draws == "pcg64si" else "")
                        + ("" if mode in MIXED_MAIN else cut),
                        table=xs == "table", grid=density == "grid")
    stream, split, csp = FLIGHT_DECKS
    flight_decks = {
        "analytic stream": stream, "analytic split": split,
        "pcg64si split": deck_dir("pcg split", split,
                                  "rng pcg64si\n" + cut),
        "table split": deck_dir("table split", split, cut, table=True),
        "table pcg64si split": deck_dir("table pcg split", split,
                                        "rng pcg64si\n" + cut, table=True)}

    res = {}
    for state, tally in MIXED_PAIRS:
        pair = f"{state}/{tally}"
        real, tal = (ctype_name(state), ctype_name(tally))
        r = res[pair] = {"sweep": {}, "flight": {}, "deposit": {},
                         "runs": {}, "registers": {
                             "sweep": sweep_registers(log, real, 0, tal),
                             "sweep_edge_array": sweep_registers(
                                 log, real, 1, tal),
                             "flight": kernel_resources(
                                 log, ("flight_kernel",), real, tal),
                             "deposit": kernel_resources(
                                 log, ("count_kernel", "scan_kernel",
                                       "fill_kernel", "tile_kernel"),
                                 real, tal)}}
        regs = r["registers"]
        print(f"[mixed {pair}] registers: sweep {regs['sweep']} (edge "
              f"arrays {regs['sweep_edge_array']}); "
              + "; ".join(f"{k}: {v['registers']} (spill "
                          f"{v['spill_stores']}/{v['spill_loads']})"
                          for k, v in {**regs["flight"],
                                       **regs["deposit"]}.items()),
              flush=True)
        if len(regs["flight"]) != 4 or len(regs["deposit"]) != 4:
            fail(f"mixed {pair}: the build log holds "
                 f"{len(regs['flight'])} flight and {len(regs['deposit'])} "
                 "deposit instantiations (want 4 and 4)")

        # -- the sweep kernel against its plain version, all 16 modes ---
        for mode, deck in sweep_decks.items():
            n = F64_MAIN_N if mode in MIXED_MAIN else MIXED_N
            c = compare(n, torch, driver, transport, sweep_kernel,
                        fields, deck=deck, label=f"mixed {pair} {mode}",
                        dtype=state, tally=tally, bitwise=True, cells=True)
            c.pop("energy", None)
            r["sweep"][mode] = mode_entry(
                [c], f"{mode}: the scatter deck (4000x4000)"
                + (" with the stretch" if "edge" in mode else "")
                + f", {n} particles, one census"
                + ("" if mode in MIXED_MAIN else
                   f" of lanes born at {MIXED_E0} eV")
                + f", a {state} state and a {tally} tally, all 14 fields "
                "bitwise")
            torch.cuda.empty_cache()

        # -- the flight kernel, then the deposit on its rows -----------
        rows = {}
        for mode, deck in flight_decks.items():
            n = F64_MAIN_N if mode in MIXED_MAIN else MIXED_N
            c = compare_flight(deck, torch, driver, transport, flight,
                               flight_kernel, fields,
                               label=f"mixed {pair} {mode}",
                               small=mode == "analytic split", dtype=state,
                               n=n, tally=tally, bitwise=True, cells=True)
            segs = c.pop("segs")
            if mode in MIXED_MAIN:
                rows[mode] = segs
            r["flight"][mode] = mode_entry(
                [c], f"{deck}, {n} particles, one step-1 census"
                + ("" if mode in MIXED_MAIN else
                   f" of lanes born at {MIXED_E0} eV")
                + f", a {state} state and a {tally} tally, all 14 fields "
                "and the segment rows bitwise")
            torch.cuda.empty_cache()
        geom = driver.make_geometry(driver.load_config(split))
        for mode, segs in rows.items():
            r["deposit"][mode] = compare_raster(
                segs, torch, geom.nx, geom.ny, raster, raster_kernel,
                f"mixed {pair} {mode}", getattr(torch, tally))
        del rows
        torch.cuda.empty_cache()

    # -- the main paths, through Simulation under auto -------------------
    f32, f64 = "float32", "float64"
    paths = [   # deck, label, state, tally, transport, want, same-type's
        (SCATTER, "scatter", f32, f64, "auto", "sweep", "scatter"),
        (SCATTER, "scatter", f64, f32, "auto", "sweep", "f64 scatter"),
        *[(d, n, f32, f64, "auto", "flight", n)
          for d, n in zip(FLIGHT_DECKS, ("stream", "split", "csp"))],
        *[(d, n, f64, f32, "auto", "sweep", f"f64 {n}")
          for d, n in zip(FLIGHT_DECKS, ("stream", "split", "csp"))],
        (stream, "flight stream", f64, f32, "flight", "flight",
         "f64 flight stream")]
    decomposed = [   # as above, with the decomposition
        (SCATTER, "scatter", f32, f64, "auto", "sweep", "spatial",
         "spatial scatter"),
        (SCATTER, "scatter", f64, f32, "auto", "sweep", "spatial",
         "f64 scatter spatial"),
        (stream, "stream", f32, f64, "auto", "flight", "spatial2d",
         "spatial2d stream"),
        (stream, "flight stream", f64, f32, "flight", "flight", "spatial2d",
         "f64 flight stream spatial2d")]
    single = {}

    def same_type(label, deck, state, transport_name, want_transport,
                  decomposition=None):
        """(per-step counts, step seconds) of the same deck with a tally
        of the state's type: an earlier phase's main path, or run here."""
        if label in main_path.runs:
            return main_path.runs[label]
        run = mixed_run(torch, driver, wrappers, deck, f"{label} (same "
                        "type)", state, state, transport_name, decomposition,
                        want_transport=want_transport)
        return run["counts"], run["step_s"]

    for deck, name, state, tally, tp, want_tp, ref in paths:
        label = f"{state}/{tally} {name}"
        run = mixed_run(torch, driver, wrappers, deck, label, state, tally,
                        tp, want_transport=want_tp)
        single[(deck, state, tally, tp)] = run["counts"]
        ref_counts, ref_steps = same_type(ref, deck, state, tp, want_tp)
        report_same_type(label, run, ref, ref_counts, ref_steps)
        res[f"{state}/{tally}"]["runs"][name] = run
    for deck, name, state, tally, tp, want_tp, dec, ref in decomposed:
        label = f"{state}/{tally} {name} {dec}"
        # The flight transport's blocks end pieces at their walls: the
        # single device's counts are those over rects split there.
        want = (split_single_counts(deck, torch, driver, flight, tp,
                                    dtype=state, tally_dtype=tally)
                if want_tp == "flight" else single[(deck, state, tally, tp)])
        run = mixed_run(torch, driver, wrappers, deck, label, state, tally,
                        tp, dec, want=want, want_transport=want_tp)
        ref_counts, ref_steps = same_type(ref, deck, state, tp, want_tp, dec)
        report_same_type(label, run, ref, ref_counts, ref_steps)
        print(f"[main {label}] per-step counts equal to the single "
              f"device's{' over split rects' if want_tp == 'flight' else ''}"
              f" {run['counts']}", flush=True)
        res[f"{state}/{tally}"]["runs"][f"{name} {dec}"] = run
    for pair, r in res.items():
        r["launches"] = {k: sum(run["launches"].get(k, 0)
                                for run in r["runs"].values())
                         for k in ("sweep_chunk_kernel", "flight_chunk_kernel",
                                   "deposit_segments_kernel",
                                   "deposit_segments_kernel.overflows",
                                   "begin_timestep_kernel")}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[mixed] phase 29 took {res['seconds']:.1f} s", flush=True)
    return res


def mixed_entries(mixed: dict) -> list:
    """Phase 29's entries of the kernels line: per (state, tally) pair the
    sweep, flight and deposit kernels' mixed instantiations, each with its
    main comparison's times and bound, every mode's, and the launches of
    the pair's main paths."""
    out = []
    for state, tally in MIXED_PAIRS:
        r = mixed[f"{state}/{tally}"]
        sfx = f"_f{state[-2:]}t{tally[-2:]}"
        pair = (f"a {state} state with a {tally} tally, {F64_MAIN_N} "
                "particles, 4000x4000 mesh, one step-1 census")
        for name, source, replaces, modes, main, launches, shape in (
                ("sweep_kernel", "neutral_tpu_torch/csrc/sweep_mixed.cu",
                 "neutral_tpu/pallas_sweep.py:59", r["sweep"],
                 "analytic regions threefry pitch",
                 r["launches"]["sweep_chunk_kernel"],
                 f"the scatter deck, {pair}; modes: all 16 instantiations "
                 "of the pair (the edge-array ones on the stretched "
                 "mesh)"),
                ("flight_kernel", "neutral_tpu_torch/csrc/flight.cu",
                 "neutral_tpu/pallas_flight.py:59", r["flight"],
                 "analytic split", r["launches"]["flight_chunk_kernel"],
                 f"the split deck, {pair}; ms is the flight kernel's own "
                 "device time (CUDA events), the deposits' beside it; "
                 "modes: stream and the split copies of all 4 "
                 "instantiations"),
                ("segment_deposit_kernel",
                 "neutral_tpu_torch/csrc/raster.cu",
                 "neutral_tpu/raster.py:331 and neutral_tpu/raster.py:161",
                 r["deposit"], "analytic stream",
                 r["launches"]["deposit_segments_kernel"],
                 f"the stream deck's segment rows ({state}) of a census "
                 f"of {F64_MAIN_N} particles into a {tally} tally; ms is bins "
                 "+ tiles from CUDA events; modes: split's rows too")):
            m = modes[main]   # a census of the deck's own lanes
            out.append({
                "name": name + sfx, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(v["max_abs_err"] for v in modes.values()),
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": None, "modes": modes,
                "main_paths": {k: {q: v[q] for q in ("counts", "step_s",
                                                     "tally", "rel",
                                                     "transport")}
                               for k, v in r["runs"].items()},
                "registers": r["registers"], "shape": shape
                + f"; launches: phase 29's main paths of the pair"})
    return out


def report_same_type(label: str, run: dict, ref: str, ref_counts: list,
                     ref_steps: list) -> None:
    """Print a phase 29 main path's step times beside those of its state
    type's run with a tally of that type (`ref`), and fail unless their
    per-step counts are equal: the physics reads no tally."""
    if run["counts"] != ref_counts:
        fail(f"{label}: per-step counts {run['counts']} differ from "
             f"{ref!r}'s {ref_counts}, whose tally is of the state's type")
    print(f"[main {label}] step times "
          + ", ".join(f"{t:.4f}" for t in run["step_s"]) + f" s against "
          + ", ".join(f"{t:.4f}" for t in ref_steps)
          + f" s of {ref!r} (a tally of the state's type); per-step counts "
          "equal", flush=True)


def ctype_name(dtype: str) -> str:
    """The C++ type of a float dtype's name."""
    return {"float32": "float", "float64": "double"}[dtype]


def log_uniform_f64(count: int):
    """`count` float64 energies log-uniform over [1e-3, 1e9] eV, as
    table_kernel.probe_energies draws its float32 ones."""
    import numpy as np
    return 10.0 ** np.random.default_rng(0).uniform(-3.0, 9.0, count)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_runs(runs: list, nprocs: int, what: str, envs=None,
               timeout: float = MP_TIMEOUT) -> list:
    """`nprocs` processes (this file with --process, `envs[r]` added to
    process r's environment), which run every run of `runs` (CLI
    arguments) in turn over one process group on 127.0.0.1; returns each
    process's output, one piece a run (its lines from `RUN i` on), once
    all have exited 0 within `timeout` seconds (all are killed
    otherwise)."""
    coordinator = ["--coordinator", f"127.0.0.1:{free_port()}",
                   "--num-processes", str(nprocs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--process",
         *[a for i, run in enumerate(runs)
           for a in ([] if i == 0 else ["--then"]) + list(run)
           + coordinator + ["--process-id", str(r)]]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, **(envs[r] if envs else {})})
        for r in range(nprocs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        fail(f"{what}: a process took over {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-6000:])
            fail(f"{what}: process {r} exited {p.returncode}")
    # Each process's output, one piece a run (re.split keeps the
    # process's start-up lines before the first marker in piece 0).
    pieces = [re.split(r"^RUN \d+$", o, flags=re.M)[1:] for o in outs]
    if any(len(ps) != len(runs) for ps in pieces):
        fail(f"{what}: a process did not report every run")
    print(f"[{what}] {len(runs)} runs in one set of {nprocs} processes: "
          f"wall {wall:.1f} s, start-up included", flush=True)
    return pieces


def process_run(what: str, label: str, pieces: list, i: int, nprocs: int,
                want_counts: list, launches: list) -> dict:
    """Check run `i` of spawn_runs' `pieces` (`label`: its decomposition
    and deck name): process 0's `Distributed:` line, a kernel run, its
    golden (csp: omp3's tally), its per-step counts equal to
    `want_counts`, and every process's kernels launched and no plain
    version, each census of each of its shards begun once by the begin
    kernel.  Adds its launches to `launches` (as check_kernel_path
    returns them); returns its output, counts and cards."""
    out = pieces[0][i]
    counts = [json.loads(re.search(r"^COUNTS (.*)$", ps[i], re.M)[1])
              for ps in pieces]
    if (f"Distributed: {nprocs} processes, 4 shards." not in out
            or "Engine: kernel." not in out):
        fail(f"{what}, {label}: not a {nprocs}-process kernel run")
    check_golden(f"{what} {label}", out, float(re.search(
        r"Final global_energy_tally (\S+)", out)[1]))
    flight = "Transport: flight." in out
    for r, c in enumerate(counts):
        ran = (c["flight_chunk_kernel"] > 0
               and c["deposit_segments_kernel"] > 0 if flight
               else c["sweep_chunk_kernel"] > 0)
        if (not ran or c["sweep_chunk_plain"] != 0
                or c["flight_chunk_plain"] != 0):
            fail(f"{what}, {label}: process {r} counts {c}")
        for k, key in enumerate(("sweep_chunk_kernel", "flight_chunk_kernel",
                                 "deposit_segments_kernel",
                                 "deposit_segments_kernel.overflows")):
            launches[k] += c[key]
        main_path.begin_launches[f"{what} {label} {r}"] = check_begin(
            f"{what}, {label}: process {r}", out, c, 4 // nprocs)
        check_inject(f"{what}, {label}: process {r}", 4 // nprocs, True, c)
    if step_counts(out) != want_counts:
        fail(f"{what}, {label}: per-step counts {step_counts(out)} differ "
             f"from {want_counts}")
    cards = [json.loads(re.search(r"^CARDS (.*)$", ps[i], re.M)[1])
             for ps in pieces]
    peaks = [json.loads(re.search(r"^PEAK (.*)$", ps[i], re.M)[1])
             for ps in pieces]
    return {"out": out, "counts": counts, "cards": cards, "peaks": peaks,
            "wall": float(re.search(r"^WALL (\S+)$", out, re.M)[1])}


def phase_seconds(out: str, phase: str) -> float:
    """A phase's cumulative seconds from the PHASE BREAKDOWN line (0.0
    when the run has no such phase)."""
    m = re.search(rf"PHASE BREAKDOWN.*{phase}=([0-9.]+)s", out)
    return float(m[1]) if m else 0.0


def crossed(out: str) -> list:
    """The lanes that crossed between processes, per step."""
    return [int(k) for k in re.findall(
        r"Migrated \d+ particles between shards, (\d+) of them", out)]


def two_processes(decomposed: dict) -> list:
    """Phase 23.  Returns the launches of both processes of every run,
    summed as check_kernel_path returns them."""
    launches = [0, 0, 0, 0]
    runs = [[deck, "--device", "cuda:0", *SHARDS, decomposition]
            for _, deck, decomposition in MP_RUNS]
    pieces = spawn_runs(runs, 2, "two processes")
    for i, (name, deck, decomposition) in enumerate(MP_RUNS):
        label = f"{decomposition} {name}"
        ref = decomposed["runs"][label]
        r = process_run("two processes", label, pieces, i, 2, ref["counts"],
                        launches)
        out = r["out"]
        if f"Decomposition: {decomposition}, 4 shards on cuda:0" not in out:
            fail(f"two processes, {label}: not 4 shards on cuda:0")
        print(f"[two processes {label}] per-step counts equal to phase "
              f"14's; step times {step_seconds(out)} s against phase 14's "
              f"{ref['step_s']} s; exchange "
              f"{phase_seconds(out, 'exchange'):.4f} s in all; "
              f"lanes between the processes per step {crossed(out)}; "
              f"launches per process {r['counts']}; wall {r['wall']:.1f} s",
              flush=True)
    return launches


def card_references(torch, driver, flight, wrappers) -> dict:
    """Phase 30's single-card runs on cuda:0: each deck of CARD_DECKS
    through driver.main (its golden passed), and stream, split and csp
    over rects split at the 2x2 blocks' walls; returns per label its
    per-step counts and step seconds ("<deck> blocks": counts alone)."""
    refs = {}
    for name, deck, extra in CARD_DECKS:
        label = card_label("1 card", name)
        out, total, c = main_path(deck, torch, driver, wrappers, argv=extra,
                                  label=label)
        check_golden(label, out, total)
        check_kernel_path(label, out, c, passed=False)
        refs[name] = {"counts": step_counts(out), "step_s": step_seconds(out)}
    for deck in FLIGHT_DECKS:
        name = deck.split("/")[-1].split(".")[0]
        refs[f"{name} blocks"] = {
            "counts": split_single_counts(deck, torch, driver, flight)}
    return refs


def card_label(layout: str, name: str) -> str:
    """A phase 30 run's label: its layout and deck, "f64 " first for a
    float64 run (as the float64 phases' labels, which the begin kernel's
    float64 entry collects)."""
    if name.startswith("f64 "):
        return f"f64 {layout} {name[4:]}"
    return f"{layout} {name}"


def check_golden(label: str, out: str, total: float) -> None:
    """Fail unless a run printed `PASSED validation.` (csp: its tally
    within 1e-3 of omp3's)."""
    if label.endswith("csp"):
        rel = abs(total - CSP_OMP3_TALLY) / CSP_OMP3_TALLY
        print(f"[main {label}] tally {total:.9e} against omp3's "
              f"{CSP_OMP3_TALLY:.7e}: rel {rel:.3e}")
        if not rel <= 1e-3:
            fail(f"{label}: tally {rel:.3e} from omp3's")
    elif "PASSED validation." not in out:
        fail(f"{label}: no 'PASSED validation.'")


def card_reference(refs: dict, name: str, decomposition: str) -> list:
    """The single-card per-step counts that a decomposed run of deck
    `name` must give: the split-rect run's for a flight deck on blocks."""
    if decomposition == "spatial2d" and f"{name} blocks" in refs:
        return refs[f"{name} blocks"]["counts"]
    return refs[name]["counts"]


def check_cards(label: str, cards: dict, want: list, flight: bool) -> None:
    """Fail unless every card of `want` launched the begin kernel and its
    transport's kernels (`cards`: read_cards' launches by card)."""
    kernels = (["begin_timestep_kernel", "flight_chunk_kernel",
                "deposit_segments_kernel"] if flight
               else ["begin_timestep_kernel", "sweep_chunk_kernel"])
    for k in kernels:
        idle = [d for d in want if not cards[k].get(d)]
        if idle:
            fail(f"{label}: {k} never launched on {idle} ({cards})")


def several_cards(torch, driver, flight, wrappers) -> dict:
    """Phase 30.  Returns its runs (step times, phases, lanes between
    processes, peak memory and launches by card) and the launches of its
    kernels summed as check_kernel_path returns them, float64 apart."""
    n = torch.cuda.device_count()
    res = {"cards": n, "runs": {}, "launches": [0, 0, 0, 0],
           "launches_f64": 0, "launches_on_cards": {}}
    refs = card_references(torch, driver, flight, wrappers)

    def record(label, name, decomposition, out, cards, peaks, wall):
        single = refs[name]["step_s"]
        one_card = main_path.runs.get(f"{decomposition} {name}")
        res["runs"][label] = {
            "step_s": step_seconds(out), "single_card_step_s": single,
            "phase14_step_s": one_card[1] if one_card else None,
            "migrate_s": phase_seconds(out, "migrate"),
            "exchange_s": phase_seconds(out, "exchange"),
            "crossed_processes": crossed(out), "peak_gib": peaks,
            "wall_s": wall}
        for k, by_card in cards.items():
            if by_card:
                res["launches_on_cards"].setdefault(k, {})[label] = by_card
        print(f"[cards {label}] per-step counts equal to one card's; step "
              f"times {step_seconds(out)} s against one card's {single} s"
              + (f" and phase 14's four shards on one card's {one_card[1]} s"
                 if one_card else " (phase 14 did not run)")
              + f"; migrate {phase_seconds(out, 'migrate'):.4f} s, exchange "
              f"{phase_seconds(out, 'exchange'):.4f} s; lanes between "
              f"processes per step {crossed(out)}; peak GiB by card {peaks}; "
              f"launches by card {cards}", flush=True)

    # 1xN: one process, the shards on the cards in turn
    for name, deck, decomposition, extra in CARDS_1XN:
        f64 = "--dtype" in extra
        label = card_label(f"1x{n} {decomposition}", name)
        out, total, c = main_path(
            deck, torch, driver, wrappers, label=label,
            argv=["--device", "cuda", *SHARDS, decomposition, *extra])
        cards = [f"cuda:{i % n}" for i in range(4)]
        if (f"Decomposition: {decomposition}, 4 shards on "
                f"{', '.join(cards)}") not in out:
            fail(f"{label}: the shards are not on {cards}")
        check_golden(label, out, total)
        got = check_kernel_path(label, out, c, passed=False)
        if f64:
            res["launches_f64"] += got[0]
        else:
            res["launches"] = [a + g for a, g in zip(res["launches"], got)]
        want = card_reference(refs, name, decomposition)
        if step_counts(out) != want:
            fail(f"{label}: per-step counts {step_counts(out)} differ from "
                 f"one card's {want}")
        check_cards(label, main_path.cards[label], sorted(set(cards)),
                    "Transport: flight." in out)
        record(label, name, decomposition, out, main_path.cards[label],
               main_path.peaks[label], main_path.walls[label])
    if n < 4:
        print(f"[cards] {n} cards: the 4x1 and 2x2 layouts need four; not "
              "run", flush=True)
        return res
    for d in range(n):
        with torch.cuda.device(d):
            torch.cuda.empty_cache()

    # 4x1: four processes, one card each, over NCCL
    layouts = [("4x1", 4, [(name, deck, dec) for name, deck, dec in MP_RUNS],
                None),
               ("2x2", 2, [CARDS_2X2[0]], None),
               ("2x2 own cards", 2, [CARDS_2X2[1]],
                [{"CUDA_VISIBLE_DEVICES": v} for v in ("0,1", "2,3")])]
    for what, nprocs, runs, envs in layouts:
        pieces = spawn_runs([[deck, "--device", "cuda", *SHARDS, dec]
                             for _, deck, dec in runs], nprocs, what, envs,
                            CARDS_TIMEOUT)
        for i, (name, deck, dec) in enumerate(runs):
            label = f"{what} {dec} {name}"
            r = process_run(what, f"{dec} {name}", pieces, i, nprocs,
                            card_reference(refs, name, dec), res["launches"])
            out = r["out"]
            if "Process group: nccl" not in out:
                fail(f"{label}: not over NCCL")
            # each process's own cards, as it numbers them: a block of the
            # cards that all see, or all that it sees alone
            mine = [[f"cuda:{j}" for j in (
                range(n // nprocs) if envs else
                range(p * n // nprocs, (p + 1) * n // nprocs))]
                for p in range(nprocs)]
            shards = [mine[p][j % len(mine[p])] for p in range(nprocs)
                      for j in range(4 // nprocs)]
            if (f"Decomposition: {dec}, 4 shards on {', '.join(shards)}"
                    not in out):
                fail(f"{label}: the shards are not on {shards}")
            for p, by_card in enumerate(r["cards"]):
                check_cards(f"{label}, process {p}", by_card, mine[p],
                            "Transport: flight." in out)
            merged = {}
            for p, by in enumerate(r["cards"]):
                for k, by_card in by.items():
                    for d, v in by_card.items():
                        merged.setdefault(k, {})[f"process {p} {d}"] = v
            peaks = {f"process {p} {d}": v for p, pk in enumerate(r["peaks"])
                     for d, v in pk.items()}
            record(label, name, dec, out, merged, peaks, r["wall"])
    return res


def stamp(phase: int) -> None:
    """Print the seconds since the script reached the card as `phase`
    starts (where the script's time goes)."""
    print(f"[clock] phase {phase} starts at "
          f"{time.perf_counter() - stamp.t0:.1f} s", flush=True)


def process_main(argv: list) -> int:
    """`chip_smoke.py --process <CLI arguments> [--then <CLI arguments>
    ...]`: one process of phases 23 and 30, driver.main on each run's
    arguments in turn, with every count set to 0 just before it; each
    run's output follows a line `RUN i`, and its counts, its launches by
    card, its cards' peak memory and its wall seconds are printed just
    after, on lines of their own."""
    from neutral_tpu_torch import driver
    wrappers = kernel_wrappers()
    runs, run = [], []
    for a in argv + ["--then"]:
        if a == "--then":
            runs.append(run)
            run = []
        else:
            run.append(a)
    import torch
    for i, run in enumerate(runs):
        print(f"RUN {i}", flush=True)
        reset_counts(wrappers)
        if torch.cuda.is_initialized():   # (a fresh process has no peaks)
            reset_peaks(torch)
        t0 = time.perf_counter()
        rc = driver.main(run)
        print(f"COUNTS {json.dumps(read_counts(wrappers))}", flush=True)
        print(f"CARDS {json.dumps(read_cards(wrappers))}", flush=True)
        print(f"PEAK {json.dumps(card_peaks(torch))}", flush=True)
        print(f"WALL {time.perf_counter() - t0:.3f}", flush=True)
        if rc != 0:
            return rc
    return 0


def phase30(torch, driver, flight, wrappers) -> dict | None:
    """Phase 30 where the machine has several cards (None on one)."""
    stamp(30)
    if torch.cuda.device_count() < 2:
        print("[cards] one card: phase 30 needs several "
              "(torch.cuda.device_count() >= 2)", flush=True)
        return None
    return several_cards(torch, driver, flight, wrappers)


def main(cards_only: bool = False, inject_only: bool = False) -> int:
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test runs only on a CUDA device", file=sys.stderr)
        return 1
    stamp.t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi: {smi}", flush=True)

    from neutral_tpu_torch import (build, driver, flight, flight_kernel,
                                   raster, raster_kernel, sweep_kernel,
                                   table_kernel, transport)
    from neutral_tpu_torch.particles import STATE_FIELDS

    # ---- 2. build -------------------------------------------------------
    stamp(2)
    t0 = time.perf_counter()
    path, log = build.build()
    sweep_kernel.load_library()
    flight_kernel.load_library()
    raster_kernel.load_library()
    table_kernel.load_library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if re.search(r"Compiling entry|registers|spill|bytes stack", line):
            print(f"[build] {line.strip()}")

    wrappers = kernel_wrappers()
    if cards_only:
        cards = phase30(torch, driver, flight, wrappers)
        if cards is None:
            fail("--cards: phase 30 needs several cards")
        print(f"[device] nvidia-smi: {nvidia_smi()}")
        print(json.dumps({"phase30": cards}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if inject_only:
        stamp(31)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            inject = inject_phase(tmp, torch, driver)
        print(json.dumps({"kernels": inject_entries(inject, {})}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- 3. sweep kernel against plain version --------------------------
    stamp(3)
    registers = sweep_registers(log)
    print(f"[compare] the sweep kernel's main instantiation (analytic, "
          f"regions, threefry) uses {registers} registers", flush=True)
    results = {n: compare(n, torch, driver, transport, sweep_kernel,
                          STATE_FIELDS)
               for n in COMPARE_SIZES}

    # ---- 4. main path, scatter ------------------------------------------
    stamp(4)
    out_scatter, scatter_total, c = main_path(SCATTER, torch, driver,
                                              wrappers)
    if "PASSED validation." not in out_scatter:
        fail("the full scatter deck did not print 'PASSED validation.'")
    if c["sweep_chunk_kernel"] <= 0 or c["sweep_chunk_plain"] != 0:
        fail(f"scatter main path: counts {c} (want sweep kernel launches "
             "and no plain run)")
    sweep_launches = c["sweep_chunk_kernel"]

    # ---- 5. flight kernel against plain version -------------------------
    stamp(5)
    flight_results = {}
    for deck in FLIGHT_DECKS:
        flight_results[deck] = compare_flight(
            deck, torch, driver, transport, flight, flight_kernel,
            STATE_FIELDS, small=True)

    # ---- 6. segment-deposit kernel against plain version ----------------
    stamp(6)
    geom = driver.make_geometry(driver.load_config(FLIGHT_DECKS[0]))
    raster_results = {}
    for deck in FLIGHT_DECKS:
        name = deck.split("/")[-1].split(".")[0]
        raster_results[name] = compare_raster(
            flight_results[deck].pop("segs"), torch, geom.nx, geom.ny,
            raster, raster_kernel, name)

    # ---- 7. main path, flight decks -------------------------------------
    stamp(7)
    flight_launches = raster_launches = overflows = 0
    path_launches = {}
    for deck in FLIGHT_DECKS:
        name = deck.split("/")[-1].split(".")[0]
        out, total, c = main_path(deck, torch, driver, wrappers)
        path_launches[name] = c["flight_chunk_kernel"]
        if "Transport: flight." not in out or "Engine: kernel." not in out:
            fail(f"{name}: the main path did not run the flight kernels")
        if (c["flight_chunk_kernel"] <= 0
                or c["deposit_segments_kernel"] <= 0
                or c["flight_chunk_plain"] != 0
                or c["sweep_chunk_plain"] != 0):
            fail(f"{name} main path: counts {c} (want flight and segment "
                 "kernel launches and no plain run)")
        flight_launches += c["flight_chunk_kernel"]
        raster_launches += c["deposit_segments_kernel"]
        overflows += c["deposit_segments_kernel.overflows"]
        if name == "csp":
            csp_counts = step_counts(out)
            csp_steps = csp_entry(out, driver, c["flight_chunk_kernel"])
            rel = abs(total - CSP_OMP3_TALLY) / CSP_OMP3_TALLY
            print(f"[main csp] tally {total:.9e} against omp3's "
                  f"{CSP_OMP3_TALLY:.7e}: rel {rel:.3e}")
            if not rel <= 1e-3:
                fail(f"csp tally {total:.9e} is {rel:.3e} from omp3's "
                     f"{CSP_OMP3_TALLY:.7e} (> 1e-3)")
        elif "PASSED validation." not in out:
            fail(f"the full {name} deck did not print 'PASSED validation.'")

    # ---- 8-10. pcg64si, table and grid modes ---------------------------
    stamp(8)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    modes = run_modes(tmp.name, torch, driver, transport, flight,
                      sweep_kernel, flight_kernel, STATE_FIELDS, wrappers,
                      step_counts(out_scatter))
    sweep_launches += modes["sweep_launches"]
    flight_launches += modes["flight_launches"]
    raster_launches += modes["raster_launches"]
    overflows += modes["overflows"]

    # ---- 12-13. the window modes ----------------------------------------
    stamp(12)
    window = compare(MODE_N, torch, driver, transport, sweep_kernel,
                     STATE_FIELDS, label="window sweep", window=BLOCK)
    window_flight = [compare_flight(d, torch, driver, transport, flight,
                                    flight_kernel, STATE_FIELDS,
                                    label="window flight", window=BLOCK)
                     for d in (FLIGHT_DECKS[1], FLIGHT_DECKS[0])]
    raster_results["window"] = compare_raster(
        [seg for r in window_flight for seg in r.pop("segs")], torch,
        BLOCK[2], BLOCK[3], raster, raster_kernel, "window split + stream")
    block = (f"the 2x2 block [2000, 4000)^2 of the 4000x4000 mesh, "
             f"{MODE_N} particles")
    modes["sweep"]["window"] = mode_entry([window], f"scatter in {block}")
    modes["flight"]["window"] = mode_entry(
        window_flight, f"split + stream in {block}, one census each")

    # ---- 14. decomposed main paths ---------------------------------------
    stamp(14)
    decomposed = decomposed_paths(tmp.name, torch, driver, flight, wrappers,
                                  step_counts(out_scatter))
    sweep_launches += decomposed["sweep_launches"]
    flight_launches += decomposed["flight_launches"]
    raster_launches += decomposed["raster_launches"]
    overflows += decomposed["overflows"]
    for k in ("sweep", "flight"):
        modes[k]["window"]["launches"] = decomposed[f"{k}_launches"]

    # ---- 15. the window parameters' cost --------------------------------
    stamp(15)
    census = census_repeats(tmp.name)
    tmp.cleanup()

    # ---- 16. split at 64M particles -------------------------------------
    stamp(16)
    big = big_split(torch, driver, wrappers, STATE_FIELDS)

    # ---- 17. the analytic grid -----------------------------------------
    stamp(17)
    analytic_grid_check(torch, driver)

    # ---- 18-21. decks without a pitch, checkpoints, dumps, traces ---------
    stamp(18)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    no_pitch = no_pitch_decks(tmp.name, torch, driver, transport,
                              sweep_kernel, STATE_FIELDS, wrappers,
                              scatter_total, log)
    stamp(20)
    restored = checkpoint_restore(tmp.name, torch, driver, flight, wrappers,
                                  csp_counts)
    stamp(21)
    io_runs = dumps_and_trace(tmp.name, torch, driver, wrappers)
    tmp.cleanup()

    # ---- 22. the oracle on the card ---------------------------------------
    stamp(22)
    oracle_on_card(torch, driver)

    # ---- 23. two processes sharing the card ---------------------------------
    stamp(23)
    for launches in (restored["launches"],
                     io_runs["launches"], two_processes(decomposed)):
        sweep_launches += launches[0]
        flight_launches += launches[1]
        raster_launches += launches[2]
        overflows += launches[3]

    # ---- 24. lanes below 1e-2 eV ---------------------------------------
    stamp(24)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    low = low_energy(tmp.name, torch, driver, transport, sweep_kernel,
                     STATE_FIELDS, wrappers)
    tmp.cleanup()
    sweep_launches += low["launches"]

    # ---- 25. the begin kernel -------------------------------------------
    stamp(25)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    begin = begin_phase(tmp.name, torch, driver, transport)
    tmp.cleanup()

    # ---- 26. float64 on the card's kernels ------------------------------
    stamp(26)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    f64 = float64_phase(tmp.name, torch, driver, transport, sweep_kernel,
                        STATE_FIELDS, wrappers, log)
    tmp.cleanup()

    # ---- 28. float64 on the flight transport's kernels -------------------
    stamp(28)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    f64f = float64_flight_phase(tmp.name, torch, driver, transport, flight,
                                flight_kernel, raster, raster_kernel,
                                STATE_FIELDS, wrappers, log)
    tmp.cleanup()

    # ---- 29. a state and a tally of different types ---------------------
    stamp(29)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    mixed = mixed_phase(tmp.name, torch, driver, transport, flight,
                        sweep_kernel, flight_kernel, raster, raster_kernel,
                        STATE_FIELDS, wrappers, log)
    tmp.cleanup()

    # ---- 31. the inject kernel ------------------------------------------
    stamp(31)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    inject = inject_phase(tmp.name, torch, driver)
    tmp.cleanup()

    # ---- 30. several cards -----------------------------------------------
    cards = phase30(torch, driver, flight, wrappers)
    on_cards = {}
    if cards is not None:
        sweep_launches += cards["launches"][0]
        flight_launches += cards["launches"][1]
        raster_launches += cards["launches"][2]
        overflows += cards["launches"][3]
        f64["launches"]["sweep"] += cards["launches_f64"]
        by_kernel = cards["launches_on_cards"]
        f64_runs = {k: {r: c for r, c in v.items() if r.startswith("f64 ")}
                    for k, v in by_kernel.items()}
        f32_runs = {k: {r: c for r, c in v.items()
                        if not r.startswith("f64 ")}
                    for k, v in by_kernel.items()}
        on_cards = {
            "sweep_kernel": f32_runs.get("sweep_chunk_kernel", {}),
            "flight_kernel": f32_runs.get("flight_chunk_kernel", {}),
            "segment_deposit_kernel": f32_runs.get(
                "deposit_segments_kernel", {}),
            "begin_kernel": f32_runs.get("begin_timestep_kernel", {}),
            "sweep_kernel_f64": f64_runs.get("sweep_chunk_kernel", {}),
            "begin_kernel_f64": f64_runs.get("begin_timestep_kernel", {})}

    # ---- 27. result -----------------------------------------------------
    stamp(27)
    top = results[COMPARE_SIZES[-1]]
    flights = list(flight_results.values())
    per_deck = {d.split("/")[-1].split(".")[0]: {
        k: v[k] for k in ("ms", "plain_ms", "deposit_ms", "plain_deposit_ms",
                          "census_ms", "rows")} | work_bound(v)
        for d, v in flight_results.items()}
    sweep_modes = {"analytic": mode_entry(
        [top], f"scatter, {COMPARE_SIZES[-1]} particles")}
    sweep_modes["analytic"]["census_repeats_ms"] = census["census_ms"]
    sweep_modes.update(modes["sweep"])
    sweep_modes["low energy"] = mode_entry(
        low["runs"], f"phase 22's scatter family (48x48) born at 5e-3 and "
        f"1.01e-2 eV, {MODE_N} particles each, one census each")
    sweep_modes["low energy"]["launches"] = low["launches"]
    sweep_modes["low energy"]["below_threshold"] = [
        r["below_threshold"] for r in low["runs"]]
    flight_modes = {"analytic": mode_entry(
        flights, "stream + split + csp, 1,000,000 particles each")}
    flight_modes.update(modes["flight"])
    lookup = modes["lookup"]["census energies"]
    begin_top = begin["scatter"]
    begin_f64 = {k: v for k, v in main_path.begin_launches.items()
                 if k.startswith("f64 ")}
    begin_f32 = {k: v for k, v in main_path.begin_launches.items()
                 if k not in begin_f64}
    f64_main, f64_lookup = f64["sweep"]["analytic"], f64["lookup"][
        "census energies"]
    f64_begin = f64["begin"]["scatter"]
    f64f_main = f64f["flight"]["analytic"]
    f64d_main = f64f["deposit"]["analytic stream"]
    edge = {}
    for dtype, name in (("float32", "sweep_kernel_edge_array"),
                        ("float64", "sweep_kernel_edge_array_f64")):
        modes_e = no_pitch["sweep"][dtype]
        main_e = modes_e["stretched"]
        edge[dtype] = {
            "name": name,
            "route": "cuda",
            "source": "neutral_tpu_torch/csrc/sweep.cu",
            "replaces": "neutral_tpu/pallas_sweep.py:59",
            "launches": no_pitch["launches"][dtype],
            "max_abs_err": max(m["max_abs_err"] for m in modes_e.values()),
            "ms": main_e["ms"],
            "plain_ms": main_e["plain_ms"],
            "bound_ms": main_e["bound_ms"],
            "bound_by": main_e["bound_by"],
            "library_ms": None,
            "registers": no_pitch["registers"][
                "float" if dtype == "float32" else "double"],
            "modes": modes_e,
            "main_paths": {k: v for k, v in no_pitch["runs"].items()
                           if k.startswith("f64 ") == (dtype == "float64")},
            "shape": f"the sweep kernel's edge-array mode in {dtype} (a "
                     "geometry without a pitch: facet edges read from the "
                     "mesh's edge arrays by global cell, positions global; "
                     "JAX runs these decks on its XLA sweep, "
                     "neutral_tpu/transport.py:187): the scatter deck "
                     f"(4000x4000) with {STRETCH.strip().replace(chr(10), ', ')}, "
                     f"{NO_PITCH_MAIN_N} particles, one census; modes: all 8 "
                     f"instantiations at {F64_MODE_N} particles but that "
                     "one, each bitwise its plain version; bound: the "
                     "state's bytes (and the edge arrays, read once) or the "
                     "draws' operations; launches: the main paths of "
                     f"phases 18-19 in {dtype} ({NO_PITCH_N} particles, 2 "
                     "steps each" + (", with y-slabs and 2x2 blocks"
                                     if dtype == "float64" else "") + ")"}
    print(f"[device] nvidia-smi: {nvidia_smi()}")
    kernels_line = [
        {"name": "sweep_kernel",
         "route": "cuda",
         "source": "neutral_tpu_torch/csrc/sweep.cu",
         "replaces": "neutral_tpu/pallas_sweep.py:59",
         "launches": sweep_launches,
         "max_abs_err": top["max_abs_err"],
         "ms": top["ms"],
         "plain_ms": top["plain_ms"],
         **work_bound(top),
         "library_ms": None,
         "grid_blocks": top["grid_blocks"],
         "registers": registers,
         "slot_use": top["slot_use"],
         "slot_use_pid_order": top["slot_use_pid_order"],
         "modes": sweep_modes,
         "shape": f"scatter deck, {COMPARE_SIZES[-1]} particles, 4000x4000 "
                  "mesh, one census; ms and plain_ms are whole-census times "
                  "(analytic, region, threefry); launches are summed over "
                  "every main path, the decomposed ones and both processes "
                  "of phase 23's runs included; the window mode's launches "
                  "are phase 14's decomposed paths'"},
        {"name": "flight_kernel",
         "route": "cuda",
         "source": "neutral_tpu_torch/csrc/flight.cu",
         "replaces": "neutral_tpu/pallas_flight.py:59",
         "launches": flight_launches,
         "max_abs_err": flight_modes["analytic"]["max_abs_err"],
         "ms": flight_modes["analytic"]["ms"],
         "plain_ms": flight_modes["analytic"]["plain_ms"],
         "bound_ms": flight_modes["analytic"]["bound_ms"],
         "bound_by": flight_modes["analytic"]["bound_by"],
         "library_ms": None,
         "deposit_ms": flight_modes["analytic"]["deposit_ms"],
         "per_deck": per_deck,
         "csp_10_steps": csp_steps,
         "launches_per_main_path": path_launches,
         "split_64m": big,
         "modes": flight_modes,
         "shape": "stream, split and csp decks, 1,000,000 particles each, "
                  "4000x4000 mesh, one step-1 census each; ms is the flight "
                  "kernel's own device time (CUDA events), the segment "
                  "deposits' beside it as deposit_ms; ms, plain_ms and "
                  "bound_ms are the sums of the three; max_abs_err is the "
                  "largest per-cell tally difference; csp_10_steps is the "
                  "kernel over the 10 steps of csp's main path; launches "
                  "sum every main path's, both processes of phase 23's "
                  "runs included"},
        {"name": "segment_deposit_kernel",
         "route": "cuda",
         "source": "neutral_tpu_torch/csrc/raster.cu",
         "replaces": "neutral_tpu/raster.py:331 and neutral_tpu/raster.py:161",
         "launches": raster_launches,
         "max_abs_err": raster_results["stream"]["max_abs_err"],
         "ms": raster_results["stream"]["ms"],
         "plain_ms": raster_results["stream"]["plain_ms"],
         "bound_ms": raster_results["stream"]["bound_ms"],
         "bound_by": raster_results["stream"]["bound_by"],
         "library_ms": None,
         "bin_ms": raster_results["stream"]["bin_ms"],
         "tile_ms": raster_results["stream"]["tile_ms"],
         "tile": raster_results["stream"]["tile"],
         "chunk": raster_results["stream"]["chunk"],
         "overflows": overflows,
         "modes": raster_results,
         "shape": "the segment rows of the stream deck's step-1 census "
                  "(1,000,000 particles, 4000x4000 mesh) in one deposit; ms "
                  "is bins + tiles from CUDA events; modes hold the same for "
                  "split's and csp's step-1 rows and for the window-local "
                  "rows of split and stream in the 2000x2000 block; "
                  "launches and overflows (piece-buffer re-runs) are summed "
                  "over every flight main path, the decomposed ones and "
                  "both processes of phase 23's runs included"},
        {"name": "table_lookup",
         "route": "cuda",
         "source": "neutral_tpu_torch/csrc/common.cuh",
         "replaces": "neutral_tpu/pallas_table.py:151",
         "launches": sum(modes["fused_launches"].values()),
         "fused_launches": modes["fused_launches"],
         "max_abs_err": lookup["max_abs_err"],
         "ms": lookup["ms"],
         "plain_ms": lookup["plain_ms"],
         "bound_ms": lookup["bound_ms"],
         "bound_by": lookup["bound_by"],
         "library_ms": lookup["library_ms"],
         "standalone": "neutral_tpu_torch/csrc/table.cu",
         "lookups_per_main_path": modes["lookups"],
         "modes": modes["lookup"],
         "shape": "the lookup kernel alone (csrc/table.cu) on the "
                  "30,000-entry table at the 1,000,000 end-state energies "
                  "of phase 9's table scatter census; ms is the device "
                  f"time of one of {LOOKUP_REPS} calls captured in one CUDA "
                  "graph, library_ms the same of CrossSection.lookup "
                  "(torch.searchsorted, the gathers and the "
                  "interpolation), plain_ms TableLayout.lookup's on the "
                  "host clock; bound: energies, values and the table's "
                  "keys and values moved once; launches are the sweep and "
                  "flight kernels' launches on the table main paths, which "
                  "run the lookup inside (fused_launches); modes hold 10M "
                  "and log-uniform energies and the probe tables"},
        {"name": "begin_kernel",
         "route": "cuda",
         "source": "neutral_tpu_torch/csrc/begin.cu",
         "replaces": "neutral_tpu/transport.py:221",
         "launches": sum(begin_f32.values()),
         "max_abs_err": max(r["max_abs_err"] for r in [
             *begin.values(), *no_pitch["begin"]["float32"].values()]),
         "ms": begin_top["ms"],
         "plain_ms": begin_top["plain_ms"],
         "bound_ms": begin_top["bound_ms"],
         "bound_by": begin_top["bound_by"],
         "library_ms": None,
         "wall_ms": begin_top["wall_ms"],
         "launches_per_main_path": begin_f32,
         "modes": begin,
         "no_pitch_modes": no_pitch["begin"]["float32"],
         "shape": f"step 1's state of the scatter deck, "
                  f"{COMPARE_SIZES[-1]} particles, 4000x4000 mesh; ms is "
                  f"the device time of one of {BEGIN_REPS} calls captured "
                  "in one CUDA graph, wall_ms one call on the host clock, "
                  "plain_ms transport.begin_timestep's on the host clock "
                  "(median of 3); bound: 37 bytes a lane moved once (41 "
                  "a dead lane, which keeps its old mean free path) and "
                  "one pair draw a live lane; modes hold every deck mode "
                  "at 1,000,000 particles; launches: one a census and "
                  "shard, summed over every main path, both processes of "
                  "phase 23's runs included"},
        {"name": "sweep_kernel_f64",
         "route": "cuda",
         "source": "neutral_tpu_torch/csrc/sweep.cu",
         "replaces": "neutral_tpu/pallas_sweep.py:59",
         "launches": f64["launches"]["sweep"],
         "max_abs_err": f64_main["max_abs_err"],
         "ms": f64_main["ms"],
         "plain_ms": f64_main["plain_ms"],
         "bound_ms": f64_main["bound_ms"],
         "bound_by": f64_main["bound_by"],
         "library_ms": None,
         "registers": f64["registers"],
         "oracle_family_launches": {
             k: v for k, v in f64["oracle_launches"].items()
             if k.endswith(" sweep")},
         "modes": f64["sweep"],
         "full_steps": f64["steps"],
         "seconds": f64["seconds"],
         "shape": f"scatter deck in float64, {F64_MAIN_N} particles, "
                  "4000x4000 mesh, one census (the float64 instantiations, "
                  "global coordinates; what neutral_tpu's XLA float64 "
                  "sweep_chunk computes, transport.py:506); modes at "
                  f"{F64_MODE_N} particles; launches: phase 26's main "
                  "paths (scatter, stream, split, csp, table scatter, "
                  "scatter on 4 y-slabs); oracle_family_launches: the "
                  "oracle's 48x48 families through Simulation, each "
                  "counted from 0"},
        {"name": "table_lookup_f64",
         "route": "cuda",
         "source": "neutral_tpu_torch/csrc/common.cuh",
         "replaces": "neutral_tpu/pallas_table.py:151",
         "launches": f64["launches"]["table"],
         "max_abs_err": f64_lookup["max_abs_err"],
         "ms": f64_lookup["ms"],
         "plain_ms": f64_lookup["plain_ms"],
         "bound_ms": f64_lookup["bound_ms"],
         "bound_by": f64_lookup["bound_by"],
         "library_ms": f64_lookup["library_ms"],
         "standalone": "neutral_tpu_torch/csrc/table.cu",
         "modes": f64["lookup"],
         "shape": f"the lookup kernel alone in float64 on the 30,000-entry "
                  f"table at {F64_MAIN_N} census energies (the float64 "
                  "table census's end state, repeated); timed as "
                  "table_lookup's; launches: the float64 sweep kernel's "
                  "on the float64 table scatter main path"},
        {"name": "begin_kernel_f64",
         "route": "cuda",
         "source": "neutral_tpu_torch/csrc/begin.cu",
         "replaces": "neutral_tpu/transport.py:221",
         "launches": sum(begin_f64.values()),
         "max_abs_err": max(r["max_abs_err"] for r in [
             *f64["begin"].values(), *no_pitch["begin"]["float64"].values()]),
         "ms": f64_begin["ms"],
         "plain_ms": f64_begin["plain_ms"],
         "bound_ms": f64_begin["bound_ms"],
         "bound_by": f64_begin["bound_by"],
         "library_ms": None,
         "wall_ms": f64_begin["wall_ms"],
         "launches_per_main_path": begin_f64,
         "modes": f64["begin"],
         "no_pitch_modes": no_pitch["begin"]["float64"],
         "shape": f"step 1's state of the scatter deck in float64, "
                  f"{COMPARE_SIZES[-1]} particles; timed as begin_kernel's; "
                  "modes hold every deck mode at 1,000,000 particles"},
        edge["float32"],
        edge["float64"],
        {"name": "flight_kernel_f64",
         "route": "cuda",
         "source": "neutral_tpu_torch/csrc/flight.cu",
         "replaces": "neutral_tpu/pallas_flight.py:59",
         "launches": f64f["launches"]["flight"],
         "max_abs_err": f64f_main["max_abs_err"],
         "ms": f64f_main["ms"],
         "plain_ms": f64f_main["plain_ms"],
         "bound_ms": f64f_main["bound_ms"],
         "bound_by": f64f_main["bound_by"],
         "library_ms": None,
         "deposit_ms": f64f_main["deposit_ms"],
         "registers": f64f["registers"]["flight"],
         "registers_float32": f64f["registers"]["flight_float32"],
         "per_deck": f64f["per_deck"],
         "launches_per_main_path": f64f["path_launches"],
         "main_paths": f64f["runs"],
         "oracle_family_launches": {
             k: v for k, v in f64["oracle_launches"].items()
             if k.endswith(" flight")},
         "modes": f64f["flight"],
         "seconds": f64f["seconds"],
         "shape": "stream, split and csp decks in float64, "
                  f"{F64_MAIN_N} particles each, 4000x4000 mesh, one "
                  "step-1 census each (the float64 instantiations, global "
                  "coordinates; what neutral_tpu's XLA float64 flight "
                  "engine computes, flight.py:159, :423); ms is the flight "
                  "kernel's own device time (CUDA events), the segment "
                  "deposits' beside it as deposit_ms; ms, plain_ms and "
                  "bound_ms are the sums of the three; modes at "
                  f"{F64_MODE_N} particles; launches: phase 28's main "
                  "paths (--transport flight --dtype float64: stream, "
                  "split, csp, stream on 2x2 blocks)"},
        {"name": "segment_deposit_kernel_f64",
         "route": "cuda",
         "source": "neutral_tpu_torch/csrc/raster.cu",
         "replaces": "neutral_tpu/raster.py:331 and neutral_tpu/raster.py:161",
         "launches": f64f["launches"]["deposit"],
         "max_abs_err": f64d_main["max_abs_err"],
         "ms": f64d_main["ms"],
         "plain_ms": f64d_main["plain_ms"],
         "bound_ms": f64d_main["bound_ms"],
         "bound_by": f64d_main["bound_by"],
         "library_ms": None,
         "bin_ms": f64d_main["bin_ms"],
         "tile_ms": f64d_main["tile_ms"],
         "tile": f64d_main["tile"],
         "chunk": f64d_main["chunk"],
         "tile_blocks_per_sm": f64d_main["tile_blocks_per_sm"],
         "overflows": f64f["launches"]["overflows"],
         "registers": f64f["registers"]["deposit"],
         "modes": f64f["deposit"],
         "shape": "the float64 segment rows of the stream deck's step-1 "
                  f"census ({F64_MAIN_N} particles, 4000x4000 mesh) into a "
                  "float64 tally in one deposit; ms is bins + tiles from "
                  "CUDA events; modes hold split's and csp's rows and the "
                  "window-local rows of split and stream in the 2000x2000 "
                  "block; launches and overflows: phase 28's main paths"},
        *mixed_entries(mixed),
        *inject_entries(inject, main_path.inject_launches),
    ]
    for k in kernels_line:
        if k["name"] in on_cards:
            k["launches_on_cards"] = on_cards[k["name"]]
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(process_main(sys.argv[2:]) if sys.argv[1:2] == ["--process"]
             else main(cards_only=sys.argv[1:] == ["--cards"],
                       inject_only=sys.argv[1:] == ["--inject"]))
