"""Readings that set the check's limits (check.py), on the chip at a cell's
own size:

    python3 portbench/control.py --workload <cell> [<cell> ...] \
        --seeds <n> [<n> ...] [--controls <k>] [--faults]

For each seed, in one process: one solve of the cell by the program, as
the window solves it (replica 0 of the seed), against the plain
reference: the sound reading; and, for the first --controls seeds, the
control against the same reference:
the reference itself computed in bfloat16 in the program's place, for a
float32 cell, or the program's own float32 path (the sweep transport in
float32) for a float64 cell.  Prints one JSON line a seed and kind, each
with the numbers; a control must read above a limit, a sound run within
them.  With --faults, the program's numbers with each fault planted.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import check as chk  # noqa: E402
from portbench import harness  # noqa: E402

# A census of the bfloat16 control stops after this many times the
# float64 reference's iterations; its unfinished lanes count as off.
CONTROL_ITERATIONS = 4


def solve_once(cell: dict, seed: int, device: str,
               config_override: dict | None = None) -> dict:
    """Replica 0 of `seed` through the program, with what the check
    compares (harness.solve's `kept`)."""
    import torch
    cfg = harness.sim_config({**cell["config"], **(config_override or {})},
                             cell["traffic"])
    keep = harness.keep_plan(cell, seed, cfg.nparticles)
    s = harness.solve(torch.device(device), cfg, cell["traffic"], seed, 0,
                      keep=keep)
    kept = s["kept"]
    kept["replica"] = 0
    return kept


def reference(cell: dict, seed: int, device: str, dtype=None,
              max_iterations=None, config_override: dict | None = None):
    import torch
    from portbench.reference import engine
    deck = engine.Deck.from_dict({**cell["config"],
                                  **(config_override or {})})
    limits = chk.load_limits(cell["name"])
    pids = torch.as_tensor(chk.sample(seed, deck.nparticles,
                                      limits["sample"]), device=device)
    keys = [chk.master_key(seed, 0, s) for s in range(1, deck.iterations + 1)]
    return deck, engine.solve(deck, pids, keys,
                              dtype=dtype or torch.float64,
                              max_iterations=max_iterations,
                              grid="tally_gap" in limits)


def numbers(cell: dict, deck, kept: dict, ref) -> dict:
    return chk.compare(kept, ref, nparticles=deck.nparticles,
                       dtype=cell["traffic"]["dtype"],
                       tally_dtype=cell["traffic"]["tally_dtype"],
                       extent=max(deck.width, deck.height))


def as_program(deck, ref) -> dict:
    """A reference Solve put in the program's place: its lanes as the
    program's rows (an unfinished lane gets an impossible draw counter),
    its counts and quadrant sums scaled from the compared particles to
    every particle, and its whole tally where it has one."""
    lanes = ref.lanes.numpy()
    lanes["counter"] = np.where(ref.unfinished.cpu().numpy(), -1,
                                lanes["counter"])
    per = deck.nparticles / lanes["pid"].shape[0]
    steps = [(per * float(ref.live[s].sum()), per * float(ref.facets[s].sum()),
              per * float(ref.collisions[s].sum()))
             for s in range(ref.live.shape[0])]
    quads = [per * float(q) for q in ref.quadrant_tally.sum(0).tolist()]
    out = {"rows": {f: lanes[f] for f in chk.FIELDS}, "steps": steps,
           "quadrants": quads}
    if ref.tally is not None:
        out["tally"] = ref.tally.cpu().numpy()
    return out


def control_program(cell: dict, seed: int, device: str,
                    config_override: dict | None = None) -> dict:
    """The program's own path one precision below the cell's: float32 on
    the sweep transport, for a float64 cell."""
    low = copy.deepcopy(cell)
    low["traffic"].update(dtype="float32", tally_dtype="float32",
                          transport="sweep")
    return solve_once(low, seed, device, config_override)


# Faults planted under the timed path, at driver.py's calls of the
# transport (whatever the engine): a census that returns its state
# unchanged, half of the lanes left out, every lane's energy altered where
# the census produces it (by 1e-3), and the tally altered as it is read
# (by 10%).
TRANSPORTS = ("sweep_chunk_kernel", "flight_chunk_kernel",
              "sweep_chunk_plain", "flight_chunk_plain")
FAULTS = ("unchanged", "half", "altered_lanes", "altered_tally")


def _unchanged(orig):
    def census(state, tally, *args, **kw):
        counts = (state, 0, 0, 0)
        return counts + (({"flight": 0.0, "raster": 0.0},)
                         if "flight" in orig.__name__ else ())
    return census


def _half(orig):
    def census(state, tally, *args, **kw):
        import torch
        skip = state.pid % 2 == 1
        dt = state.dt_to_census.clone()
        state.dt_to_census = torch.where(skip, 0.0, dt)
        out = orig(state, tally, *args, **kw)
        out[0].dt_to_census = torch.where(skip, dt, out[0].dt_to_census)
        return out
    return census


def _altered_lanes(orig):
    def census(*args, **kw):
        out = orig(*args, **kw)
        out[0].energy = out[0].energy * (1.0 + 1e-3)
        return out
    return census


def plant(fault: str) -> list:
    """Plant `fault` in the program; returns what to undo, for unplant."""
    from neutral_tpu_torch import driver
    if fault == "altered_tally":
        host = driver.Simulation.host_tally
        driver.Simulation.host_tally = lambda self: host(self) * 1.1
        return [(driver.Simulation, "host_tally", host)]
    wrap = {"unchanged": _unchanged, "half": _half,
            "altered_lanes": _altered_lanes}[fault]
    undo = []
    for name in TRANSPORTS:
        orig = getattr(driver, name)
        setattr(driver, name, wrap(orig))
        undo.append((driver, name, orig))
    return undo


def unplant(undo: list) -> None:
    for obj, name, orig in undo:
        setattr(obj, name, orig)


def same_reference(cells: list) -> None:
    """Cells read together share one reference a seed: one configuration
    and one sample."""
    first = cells[0]
    for cell in cells[1:]:
        assert cell["config"] == first["config"], cell["name"]
        assert (chk.load_limits(cell["name"])["sample"]
                == chk.load_limits(first["name"])["sample"]), cell["name"]


def fault_readings(cells: list, seeds: list, device: str,
                   config_override: dict | None = None,
                   out=sys.stdout) -> list:
    """Per seed, cell and fault, the numbers of the program with the fault
    planted: readings above which a limit must stay."""
    same_reference(cells)
    rows = []
    for seed in seeds:
        deck, ref = reference(cells[0], seed, device,
                              config_override=config_override)
        for cell in cells:
            for fault in FAULTS:
                undo = plant(fault)
                try:
                    kept = solve_once(cell, seed, device, config_override)
                finally:
                    unplant(undo)
                rows.append({"cell": cell["name"], "seed": seed,
                             "kind": fault,
                             **numbers(cell, deck, kept, ref)})
                print(json.dumps(rows[-1]), file=out, flush=True)
    return rows


def readings(cells: list, seeds: list, device: str,
             config_override: dict | None = None, controls: int = 3,
             out=sys.stdout) -> list:
    """Per seed and cell the program's numbers, and for the first
    `controls` seeds the control's."""
    import torch
    same_reference(cells)
    for cell in cells:                                        # warm-up
        solve_once(cell, seeds[0], device, config_override)
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        deck, ref = reference(cells[0], seed, device,
                              config_override=config_override)
        t_ref = time.perf_counter() - t0
        bf = None
        for cell in cells:
            kept = solve_once(cell, seed, device, config_override)
            rows.append({"cell": cell["name"], "seed": seed,
                         "kind": "program", "ref_s": t_ref,
                         **numbers(cell, deck, kept, ref)})
            print(json.dumps(rows[-1]), file=out, flush=True)
            if i >= controls:
                continue
            t1 = time.perf_counter()
            if cell["traffic"]["dtype"] == "float64":
                low = control_program(cell, seed, device, config_override)
            else:
                if bf is None:
                    cap = CONTROL_ITERATIONS * max(max(ref.iterations), 1)
                    bf = reference(cell, seed, device, dtype=torch.bfloat16,
                                   max_iterations=cap,
                                   config_override=config_override)[1]
                low = as_program(deck, bf)
            rows.append({"cell": cell["name"], "seed": seed,
                         "kind": "control",
                         "control_s": time.perf_counter() - t1,
                         **numbers(cell, deck, low, ref)})
            print(json.dumps(rows[-1]), file=out, flush=True)
    return rows


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", nargs="+", required=True,
                   help="one cell, or cells of one configuration and "
                        "sample, which share the reference")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", action="store_true",
                   help="the program's readings with each fault planted")
    p.add_argument("--controls", type=int, default=3,
                   help="how many of the seeds also read the control")
    args = p.parse_args(argv)
    harness.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    from neutral_tpu_torch import build
    build.load()
    cells = [harness.find_cell(w) for w in args.workload]
    if args.faults:
        fault_readings(cells, args.seeds, "cuda")
    else:
        readings(cells, args.seeds, "cuda", controls=args.controls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
