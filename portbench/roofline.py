"""The least time a census's work could take on one card.

The work is what the algorithm needs, counted from a census's own counts
(live lanes, facets, collisions) with the deck's RNG scheme and dtype,
whatever implements it: the sweep and the flight transport read the same
physics as the same work.  Nothing here counts segment rows, flight
pieces, reloads or compiled instruction sequences.

Peaks: NVIDIA's data sheet for the H100 SXM5 80 GB (dense, without
sparsity, at the 700 W limit), and for integers the Hopper white paper's
64 INT32 lanes a streaming multiprocessor at its 1.98 GHz boost clock.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12                       # HBM3, bytes/s
PEAK_FLOPS = {"float32": 67e12,            # FP32, outside the tensor cores
              "float64": 34e12}            # FP64, outside the tensor cores
PEAK_INT = 132 * 64 * 1.98e9               # INT32 operations/s

# 32-bit integer operations of one pair draw, the fewest a 32-bit ALU can
# do.  Threefry-2x64-20: twenty rounds of a 64-bit add (2), a 64-bit
# rotate (2 funnel shifts) and a 64-bit xor (2), five key injections of
# two 64-bit adds (4), the key schedule's parity word (2) and the first
# key add (4): 150.  PCG64si (one 64-bit multiply-add and its output
# permutation, for each of the pair's two generators): 30.
DRAW_OPS = {"threefry": 150, "pcg64si": 30}

# Floating-point operations, each counted once in either precision, the
# fewest that either transport does for the same physics.  A facet: the
# segment deposit's per-cell visit (15; the sweep does 60).  A collision:
# the absorption test, the scatter's energy and direction, the new
# cross-section's interpolation and the fresh mean free path (40).  A
# census start: the interpolation, the macroscopic cross-section and the
# mean free path (12).
FLOPS_FACET = 15
FLOPS_COLLISION = 40
FLOPS_BEGIN = 12

# Bytes of a live lane's state, read once and written once a census: nine
# floats (x, y, two directions, energy, weight, time to census, mean free
# paths, pending deposit), two int32 cells, the dead flag, the int64 id
# (read only) and the int64 draw counter.  A dead lane: its flag.
LANE_READ = {"float32": 9 * 4 + 4 + 4 + 1 + 8 + 8,
             "float64": 9 * 8 + 4 + 4 + 1 + 8 + 8}
LANE_WRITE = {k: v - 8 for k, v in LANE_READ.items()}
TALLY_BYTES = {"float32": 4, "float64": 8}


def census_seconds(live: int, facets: int, collisions: int, deaths: int,
                   nlanes: int, dtype: str, rng: str) -> float:
    """Least seconds of one census on one card: the larger of its bytes
    over the bandwidth, its draws' integer operations over the integer
    peak and its float operations over the float peak.  `deaths` is at
    most the census's deaths: each collision draws once and each survivor
    once more."""
    draws = live + 2 * collisions - deaths
    nbytes = (live * (LANE_READ[dtype] + LANE_WRITE[dtype])
              + (nlanes - live))
    flops = (live * FLOPS_BEGIN + facets * FLOPS_FACET
             + collisions * FLOPS_COLLISION)
    return max(nbytes / PEAK_BYTES, draws * DRAW_OPS[rng] / PEAK_INT,
               flops / PEAK_FLOPS[dtype])


def solve_seconds(steps: list, nlanes: int, ncells: int, dtype: str,
                  tally_dtype: str, rng: str) -> float:
    """Least seconds of a solve's censuses on one card, from its steps'
    (live, facets, collisions): the censuses in turn, and the tally's
    cells written once.  A census's deaths are the lanes live at its
    start and not at the next one's; the last census's, its collisions or
    its live lanes, whichever is fewer."""
    total = ncells * TALLY_BYTES[tally_dtype] / PEAK_BYTES
    for i, (live, facets, collisions) in enumerate(steps):
        deaths = (live - steps[i + 1][0] if i + 1 < len(steps)
                  else min(live, collisions))
        total += census_seconds(live, facets, collisions, deaths, nlanes,
                                dtype, rng)
    return total
