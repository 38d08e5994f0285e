"""Whether a solve of the window is correct: its lanes, its counts and its
tally against the plain reference (reference/engine.py).

The benchmark keeps one solve of the window, drawn from the seed, and of
it the particles that the cell's limits file (limits/<cell>.json) names
under "sample": a number of them drawn from the seed, or "all".  The
other keys of that file are the numbers compared, each with its limit:

* `lanes_off_pct`: the share of the compared particles whose final lane
  departs from the reference's: another dead flag, cell or draw counter,
  or an energy, weight, position or direction off by more than the
  working precision's tolerance (TOLERANCES); a particle the program
  holds not once counts as off.  A history is chaotic, so a lane whose
  rounding flips one decision ends far off; the share of such lanes is
  what the program's precision allows.
* `counts_z`: the largest gap, in standard errors of the sample's
  estimate, between a census's live lanes, facets or collisions as the
  program counts them over all particles and N/K times the compared
  particles' counts in the reference.
* `tally_z` (a sample): the same for the tally summed over each quadrant
  of the mesh.
* `tally_gap` (every particle): the whole tally, cell by cell, against
  the reference's: the sum of the cells' absolute gaps over the sum of
  the reference's cells.

A standard error never falls below a floor: for a count, one sampled
particle's worth, or the share of the census's events that the working
precision's rounding may add or take away (COUNT_FLOOR), whichever is
larger; for a tally the share of the whole tally that its type's rounding
allows (TALLY_FLOOR).  With every particle compared, the error is the
floor alone.  Facets on the scatter deck show why the first floor is
there: they are rare (one event in a million), and float32's cell-local
positions give about ten times float64's, 8e-6 of the census's events: a
property of the working precision, not a fault.
"""

from __future__ import annotations

import hashlib
import json
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLE = 65536            # particles compared, at most

# Per working precision: relative tolerance of energy and weight (with the
# smallest normal number as an absolute floor, below which a weight
# underflows), absolute tolerance of a position in units of the domain's
# extent, and of a direction cosine.  float32 histories of the decks
# keep their energies within 3e-6 and positions within 3e-7 of float64's
# where no decision flips; float64 equals the reference to rounding.
TOLERANCES = {"float32": dict(rel=1e-4, tiny=1.2e-38, pos=1e-5, omega=1e-2),
              "float64": dict(rel=1e-9, tiny=2.3e-308, pos=1e-9, omega=1e-9)}
TALLY_FLOOR = {"float32": 1e-4, "float64": 1e-12}
COUNT_FLOOR = {"float32": 1e-4, "float64": 1e-9}
NUMBERS = ("lanes_off_pct", "counts_z", "tally_z", "tally_gap")
FIELDS = ("pid", "x", "y", "omega_x", "omega_y", "energy", "weight",
          "cellx", "celly", "dead", "counter")


def _digest(*parts) -> int:
    h = hashlib.blake2b("/".join(map(str, parts)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


def master_key(seed: int, replica: int, step: int) -> int:
    """The master key of a census: a 63-bit hash of (seed, replica, step),
    never 0 (injection's key)."""
    return (_digest("key", seed, replica, step) >> 1) | 1


def sample(seed: int, nparticles: int, k=SAMPLE) -> np.ndarray:
    """The sorted particle ids compared: `k` drawn from the seed, or every
    particle (k "all")."""
    rng = np.random.default_rng(_digest("sample", seed))
    if k == "all" or k >= nparticles:
        return np.arange(nparticles, dtype=np.int64)
    return np.sort(rng.choice(nparticles, size=k, replace=False)
                   ).astype(np.int64)


def kept_replica(seed: int, warm_s: float, seconds: float) -> int:
    """Which solve of the window is compared: drawn from the seed among
    those that a window of `seconds` surely completes, at most half as
    many as the warm-up solve's time would fit."""
    n = max(1, int(0.5 * seconds / max(warm_s, 1e-6)))
    return int(np.random.default_rng(_digest("replica", seed)).integers(n))


def load_limits(cell: str) -> dict:
    """The cell's sample and its numbers' limits."""
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)


def compared(limits: dict) -> list:
    """The numbers a cell compares: its limits file's, in NUMBERS' order."""
    return [k for k in NUMBERS if k in limits]


def align(rows: dict, pids: np.ndarray) -> tuple[dict, np.ndarray]:
    """The program's rows (a dict of arrays) in the order of `pids`, and
    whether each particle is held exactly once (else its row is any)."""
    got, first, count = np.unique(rows["pid"], return_index=True,
                                  return_counts=True)
    pos = np.clip(np.searchsorted(got, pids), 0, max(len(got) - 1, 0))
    once = (len(got) > 0) & (got[pos] == pids) & (count[pos] == 1)
    idx = first[pos]
    return {f: rows[f][idx] for f in FIELDS}, once


def departs(port: dict, ref: dict, tol: dict, extent: float) -> np.ndarray:
    """Whether each row of the program's lanes departs from the same row of
    the reference's (both dicts of equal-length arrays)."""
    out = ((port["dead"].astype(bool) != ref["dead"].astype(bool))
           | (port["cellx"] != ref["cellx"]) | (port["celly"] != ref["celly"])
           | (port["counter"].astype(np.int64)
              != ref["counter"].astype(np.int64)))
    for f in ("energy", "weight"):
        a, b = port[f].astype(np.float64), ref[f].astype(np.float64)
        out |= ~(np.abs(a - b) <= tol["rel"] * np.abs(b) + tol["tiny"])
    for f, t in (("x", tol["pos"] * extent), ("y", tol["pos"] * extent),
                 ("omega_x", tol["omega"]), ("omega_y", tol["omega"])):
        a, b = port[f].astype(np.float64), ref[f].astype(np.float64)
        out |= ~(np.abs(a - b) <= t)
    return out


def zscore(total: float, values: np.ndarray, n: int, floor: float) -> float:
    """|total - n * mean(values)| in standard errors of that estimate
    (with the finite-population correction), the error at least `floor`."""
    k = values.shape[0]
    est = n * float(values.mean())
    fpc = math.sqrt(max(0.0, 1.0 - k / n))
    se = n * float(values.std()) / math.sqrt(k) * fpc
    return abs(total - est) / max(se, floor, 1e-300)


def compare(port: dict, ref, *, nparticles: int, dtype: str,
            tally_dtype: str, extent: float) -> dict:
    """The numbers of `port` against the reference's Solve `ref`.

    `port` holds "rows" (the program's lanes of the compared particles, a
    dict of arrays in global coordinates), "steps" ([(live, facets,
    collisions)] over every particle), "quadrants" (the tally's four
    quadrant sums) and, where the reference has the whole tally, "tally"
    (the program's, flat)."""
    tol = TOLERANCES[dtype]
    lanes = ref.lanes.numpy()
    unfinished = ref.unfinished.cpu().numpy()
    rows, once = align(port["rows"], lanes["pid"])
    agree = once & ~departs(rows, {f: lanes[f] for f in FIELDS}, tol,
                            extent)
    k = len(agree)
    off = int((~agree | unfinished).sum())
    per = nparticles / k
    detail = {}
    for s, (live, facets, colls) in enumerate(port["steps"]):
        events = nparticles * float((ref.facets[s] + ref.collisions[s])
                                    .double().mean())
        floor = max(per, COUNT_FLOOR[dtype] * events)
        for name, total, v in (("live", live, ref.live[s]),
                               ("facets", facets, ref.facets[s]),
                               ("collisions", colls, ref.collisions[s])):
            v = v.cpu().double().numpy()
            detail[f"{name}{s + 1}"] = (total, nparticles * float(v.mean()),
                                        zscore(total, v, nparticles, floor))
    quad = ref.quadrant_tally.cpu().numpy()
    scale = max(abs(float(quad.sum())) * per, 1e-300)
    for q in range(4):
        detail[f"tally_q{q}"] = (
            port["quadrants"][q], nparticles * float(quad[:, q].mean()),
            zscore(port["quadrants"][q], quad[:, q], nparticles,
                   TALLY_FLOOR[tally_dtype] * scale))
    tally = [z for n, (_, _, z) in detail.items() if n.startswith("tally")]
    counts = [z for n, (_, _, z) in detail.items()
              if not n.startswith("tally")]
    out = {"lanes_off_pct": 100.0 * off / k, "counts_z": max(counts),
           "tally_z": max(tally)}
    if ref.tally is not None and "tally" in port:
        want = ref.tally.cpu().numpy()
        out["tally_gap"] = (float(np.abs(np.asarray(port["tally"], np.float64)
                                         - want).sum())
                            / max(float(np.abs(want).sum()), 1e-300))
    return {**out, "detail": detail}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number the cell compares is within its limit, and
    those numbers beside their limits."""
    names = compared(limits)
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in names}
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
             for k in names)
    return ok, shown
