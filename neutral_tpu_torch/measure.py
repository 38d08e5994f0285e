"""Measurements of the port on a card, beside chip_smoke.py.

    python neutral_tpu_torch/measure.py census [--root DIR] [--reps 5]
    python neutral_tpu_torch/measure.py scaled [--nparticles N]
    python neutral_tpu_torch/measure.py profile DECK [--decomposition D]

`census` times one step-1 census of the scatter deck (10,000,000 particles)
through the sweep kernel, `--reps` times after a warm-up, with the package
found under `--root` (default: this checkout).  Given the root of another
checkout, it times that checkout's kernel, so that two versions compare
within one run on one card (run them in turns: A, B, B, A).

`scaled` runs the scaled dense configuration of `__graft_entry__.py` (a
4096^2 mesh of density 1e4, the source over the middle 60%, dt 2e-9, one
step, float32) through `Simulation` and through `Spatial2DSimulation` on
2x2 blocks, four shards on the one card, and prints each run's events/s,
counts, tally and peak device memory.

`profile` runs the first step of DECK (full size) under
`torch.profiler` on one device, or under decomposition D with four shards
on the one card, and prints the 25 operations with the most CUDA time and
the 25 with the most host time, then the step's metrics.

Each prints one JSON line per measurement, with the card's name and
power limit.  All need a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def card() -> str:
    """`nvidia-smi`'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def census(reps: int, nparticles: int = 10_000_000) -> dict:
    """Milliseconds of `reps` scatter censuses through the sweep kernel."""
    import torch
    from neutral_tpu_torch import driver, sweep_kernel, transport

    cfg = driver.load_config("problems/scatter.params").with_(
        nparticles=nparticles, expected_tally=None)
    sim = driver.Simulation(cfg, device="cuda", engine="plain", quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    times = []
    for rep in range(reps + 1):
        state, tally = start.clone(), torch.zeros_like(sim.tally)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, nf, nc, _ = sweep_kernel.sweep_chunk_kernel(
            state, tally, sim.geom, sim.cs_scatter, sim.cs_absorb, 1,
            1.0 / cfg.nparticles)
        torch.cuda.synchronize()
        if rep:                                   # the first is a warm-up
            times.append((time.perf_counter() - t0) * 1e3)
    return {"census_ms": times, "min_ms": min(times),
            "median_ms": sorted(times)[len(times) // 2], "facets": nf,
            "collisions": nc, "nparticles": nparticles}


def scaled(nparticles: int) -> list:
    """The scaled dense configuration on one device and on 2x2 blocks."""
    import torch
    from neutral_tpu_torch import SimConfig, SourceBox, ProblemRegion, driver
    from neutral_tpu_torch.parallel import Spatial2DSimulation

    cfg = SimConfig(nx=4096, ny=4096, dt=2.0e-9, niters=1,
                    nparticles=nparticles, initial_energy=1.0e3,
                    source=SourceBox(0.2, 0.2, 0.6, 0.6),
                    problems=(ProblemRegion(1.0e4, 0.0, 0.0, 1.0, 1.0),),
                    dtype="float32", tally_dtype="float32")
    out = []
    for name, make in (
            ("single", lambda: driver.Simulation(cfg, quiet=True)),
            ("spatial2d 2x2", lambda: Spatial2DSimulation(
                cfg, devices=["cuda"] * 4, quiet=True))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sim = make()
        setup = time.perf_counter() - t0
        m = sim.step(1)
        ev = m.nfacets + m.ncollisions
        out.append({"run": name, "nparticles": nparticles,
                    "setup_s": setup, "step_s": m.step_time,
                    "facets": m.nfacets, "collisions": m.ncollisions,
                    "events_per_s": ev / m.step_time,
                    "migrated": m.nmigrated, "phases": m.phases,
                    "tally": float(sim.host_tally().sum()),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        del sim
    return out


def profile(deck: str, decomposition: str | None) -> list:
    """Step 1 of `deck` under torch.profiler; prints the top operations."""
    import torch
    from torch.profiler import ProfilerActivity
    from neutral_tpu_torch import driver

    cfg = driver.load_config(deck)
    devices = [torch.device("cuda", 0)] * (4 if decomposition else 1)
    sim = driver.make_simulation(cfg, decomposition or "replicated",
                                 devices, quiet=True)
    sim.step(1)                      # warm-up: builds, caches, allocates
    sim = driver.make_simulation(cfg, decomposition or "replicated",
                                 devices, quiet=True)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        m = sim.step(1)
    ka = prof.key_averages()
    print(ka.table(sort_by="cuda_time_total", row_limit=25), flush=True)
    print(ka.table(sort_by="self_cpu_time_total", row_limit=25), flush=True)
    return [{"deck": deck, "decomposition": decomposition,
             "step_s": m.step_time, "facets": m.nfacets,
             "collisions": m.ncollisions, "migrated": m.nmigrated,
             "launches": m.nlaunches, "phases": m.phases}]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="measure", description=__doc__.split(
        "\n\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    c = sub.add_parser("census", help="time the 10M scatter census")
    c.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package to time")
    c.add_argument("--reps", type=int, default=5)
    s = sub.add_parser("scaled", help="the scaled 4096^2 configuration")
    s.add_argument("--nparticles", type=int, default=100_000_000)
    f = sub.add_parser("profile", help="step 1 of a deck under the profiler")
    f.add_argument("deck")
    f.add_argument("--decomposition", default=None,
                   choices=["replicated", "spatial", "spatial2d"])
    args = p.parse_args(argv)

    if args.what == "census":
        # This file's own directory would shadow nothing useful: the
        # package comes from the root asked for.
        sys.path[0] = os.path.abspath(args.root)
        os.chdir(args.root)
        rec = census(args.reps)
        rec["root"] = args.root
        rec = [rec]
    else:
        sys.path[0] = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        rec = (scaled(args.nparticles) if args.what == "scaled"
               else profile(args.deck, args.decomposition))
    for r in rec:
        r["card"] = card()
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
