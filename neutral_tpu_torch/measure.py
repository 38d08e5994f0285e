"""Measurements of the port on a card, beside chip_smoke.py.

    python neutral_tpu_torch/measure.py census [--root DIR] [--reps 5]
        [--dtype float64] [--tally-dtype T] [--modes MODE ...]
    python neutral_tpu_torch/measure.py flight [--root DIR] [--reps 5]
        [--dtype float64] [--tally-dtype T]
    python neutral_tpu_torch/measure.py deposit [--root DIR] [--reps 5]
        [--rows FILE] [--deck DECK] [--dtype float64] [--tally-dtype T]
    python neutral_tpu_torch/measure.py run DECK [--root DIR] [--reps 1]
        [--shards N --decomposition D] [--dtype float64]
        [--tally-dtype T] [--transport flight] [--cards N [N ...]]
        [--processes W]
    python neutral_tpu_torch/measure.py compare FILE [--key total_s]
    python neutral_tpu_torch/measure.py scaled [--nparticles N]
    python neutral_tpu_torch/measure.py tail DECK [--root DIR]
        [--decomposition D] [--steps] [--cards N]
    python neutral_tpu_torch/measure.py kernels [--root DIR] [--sass FILE]
        [--dtype D [--tally-dtype T]]
    python neutral_tpu_torch/measure.py kernels-diff PARENT CHANGE
    python neutral_tpu_torch/measure.py build [--root DIR] [--reps 2]
        [--merge SRC.cu SRC.cu ...]

`census` times one step-1 census of the scatter deck through the sweep
kernel in each of its modes, `--reps` times after a warm-up, with the
package found under `--root` (default: this checkout): analytic (the deck
itself, 10,000,000 particles), and at 1,000,000 particles analytic_1m
(the deck itself), pcg64si (the deck with `rng pcg64si`), table (beside
30,000-entry `.cs` tables, xs.resonance_log_table), grid (a random 4000^2
density grid with 25% vacuum cells, from default_rng(7)) and window (the
2x2 block [2000, 4000)^2), the copies chip_smoke.py's phases 8-10 and 12
make.  Given the
root of another checkout, it times that checkout's kernel, so that two
versions compare within one run on one card (run them in turns: A, B, B,
A).  Each mode's record holds the census's facets and collisions, a
digest of the end state's 14 fields (two checkouts whose kernels compute
the same lanes print the same digest), the share of thread slots that
one thread per lane in pid order would fill (from each lane's draws, its
counter's delta), the share the kernel's launches filled and its grid.
`--dtype float64` runs the census in float64 (the sweep kernel's float64
instantiations, global coordinates).  `--modes` picks the modes to run
(default: those six); besides them it takes the decks without a pitch,
which run the kernel's edge-array mode: stretched (the scatter deck with
`mesh_stretch_x 1.0002` and `mesh_stretch_y 0.9998`, cell widths 0.45x
to 2.2x of the uniform pitch) and fast_math0 (with `fast_math 0`: the
region-built density grid and the stored resonance table), each at the
deck's 10,000,000 particles, and stretched_1m and fast_math0_1m at
1,000,000.

`flight` times the flight kernel's own device time (CUDA events, without
the segment deposits) over one step-1 census of the split deck at
1,000,000 particles, analytic and beside the 30,000-entry `.cs` tables,
`--reps` times after a warm-up, with the package under `--root` as
`census` does, and prints each mode's end-state digest.  `--dtype
float64` runs it in float64 (the flight kernel's float64 instantiations).

`deposit` times the segment deposit of the step-1 segment rows of DECK
(default: the stream deck, 1,000,000 particles, 4000^2 mesh) into a fresh
tally, `--reps` times after a warm-up, with the package under `--root` as
`census` does: CUDA events around each call, and for a package with the
tiled kernel also its two stages (bins, tile deposit), the bins' sizes, T
and C.  The rows come
from that package's flight kernel, or from `--rows FILE` when it exists
(written there otherwise), so that the runs of two checkouts in one call
deposit the same rows.  `--dtype float64` deposits float64 rows (from the
float64 flight kernel) into a float64 tally.

`run` runs DECK at full size through `driver.make_simulation` (one device,
or N shards under decomposition D, over the first `--cards` cards in
turn: 1, the default, puts them all on cuda:0; `--cards 1 2 4` runs each
count in turn, a warm-up run each) with the package under
`--root`, once as a warm-up and `--reps` times timed, and prints for each
timed run its steps' times, the cumulative phases, the launches,
migrations (and lanes exchanged between processes) and each card's peak
device memory: run it for two checkouts in turns in one call (A, B, B,
A, ...) to compare whole steps.  `--processes W` runs it over W
processes that see the first `--cards` cards (CUDA_VISIBLE_DEVICES),
joined through a coordinator on 127.0.0.1, each placing its block of
shards as the package does (this tree: on its own cards, NCCL where no
card is shared; a checkout whose `initialise_distributed` takes no
device: process r on cuda:(r % cards), gloo), and prints process 0's
record with every process's peak memory per card and step times.  `--dtype float64`
runs the deck in float64 (state and tally; `auto` then takes the sweep
transport and its float64 kernels); `--transport sweep|flight` picks the
transport by name (`--transport flight --dtype float64`: the float64
flight and deposit kernels).  `compare` reads the
JSON lines of such runs (with other lines between them) and prints, per
deck and decomposition and per checkout, the runs' count, median, minimum
and quartiles of `--key` (a dotted key such as phases.raster reads a
nested one; a list, such as census's census_ms, adds each of its
values), and the second checkout's medians and minima over the
first's.

`scaled` runs the scaled dense configuration of `__graft_entry__.py` (a
4096^2 mesh of density 1e4, the source over the middle 60%, dt 2e-9, one
step, float32) through `Simulation` and through `Spatial2DSimulation` on
2x2 blocks, four shards on the one card, and prints each run's events/s,
counts, tally and peak device memory.

`tail` runs step 1 of DECK (full size; every step with `--steps`), after
a warm-up step, on one device or under decomposition D with four shards
over the first `--cards` cards, with the package under `--root`, and
prints per step the
record of every flight-kernel launch: the lanes it covers, the lanes with
work at its start and still working after it, and its device time (CUDA
events), with the count and device time of the launches in the census
tail (under 10% of the shard's first launch's lanes with work).

`kernels` builds the kernel library of the checkout under `--root` (its
build.py, its csrc/) and prints one record per compiled kernel: its name
as cu++filt demangles it, with the float32 instantiations named as before
the working type became a template parameter (", float>" and "<float>"
dropped, "SweepParamsT<...>" and its kin of the begin, flight and
deposit kernels read as "SweepParams" and so on, and a kernel left
without template arguments named without its return type) and the sweep
kernel's pitch-mode instantiations as before the edge mode became one
(", (nt::EdgeMode)0" dropped), ptxas's
registers, spill stores and loads and stack frame from the build log,
and a digest of its SASS (cuobjdump -sass, addresses and encodings
stripped): two checkouts whose kernels of one name print
the same digest compiled to the same instructions.  A kernel whose tally
is of its working type is named as before the tally type was a template
parameter (its last template argument dropped); those of a state and a
tally of different types keep their whole name.  `--sass FILE` also
writes the whole SASS listing there.

`kernels-diff` reads two files of `kernels` records (a parent's, then a
change's) and prints one record: how many kernels of one name both
have, how many of those keep their digest, registers, spills and stack,
the names of those that do not and of the parent's that the change
lacks, and how many the change adds.

`build` times the kernel library's build from nothing, as build.py makes
it (one nvcc process a source of `--root`'s csrc/, all started together,
then the link), in a new directory each of `--reps` times: the wall time
and each source's seconds.  With `--merge`, the named sources compile as
one translation unit (a file that includes each in turn), so that a
source split in two is timed against the two as one.

`--tally-dtype` (float32 or float64; default `--dtype`) gives the tally
a type of its own beside the state's working type: a float32 state with
a float64 tally, or a float64 state with a float32 tally, runs the
kernels' mixed instantiations (`deposit` then puts the state type's rows
into a tally of that type).  For `kernels`, `--dtype` and `--tally-dtype`
pick the instantiations of that (working type, tally type) pair, read
from their parameter struct (default: every kernel).

Each prints one JSON line per measurement, with the card's name and
power limit.  All need a card but `kernels`, which needs nvcc and
cuobjdump, and `build`, which needs nvcc.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time


def pair_name(dtype: str, tally: str) -> str:
    """A record name's suffix for a state of `dtype` and a tally of
    `tally`: nothing for float32 and float32, as before the tally had a
    type of its own."""
    return (("" if dtype == "float32" else f" {dtype}")
            + ("" if tally == dtype else f" tally {tally}"))


def card() -> str:
    """`nvidia-smi`'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


CENSUS_MODES = ("analytic", "analytic_1m", "pcg64si", "table", "grid",
                "window")
# Decks without a pitch: the sweep kernel's edge-array mode.
NO_PITCH_MODES = ("stretched", "stretched_1m", "fast_math0", "fast_math0_1m")
STRETCH = "mesh_stretch_x 1.0002\nmesh_stretch_y 0.9998\n"
BLOCK = (2000, 2000, 2000, 2000)   # (x_off, y_off, nx, ny) of "window"


def census_deck(mode: str, tmp: str) -> tuple[str, int, tuple | None]:
    """(deck, particles, window) of a census mode; copies of the scatter
    deck go to `tmp` under their own basename."""
    import shutil
    import numpy as np
    from neutral_tpu_torch import driver, xs

    scatter = "problems/scatter.params"
    if mode in ("analytic", "analytic_1m", "window"):
        return (scatter, 10_000_000 if mode == "analytic" else 1_000_000,
                BLOCK if mode == "window" else None)
    d = os.path.join(tmp, mode)
    os.makedirs(d, exist_ok=True)
    deck = os.path.join(d, os.path.basename(scatter))
    shutil.copy(scatter, deck)
    with open(deck, "a") as f:
        if mode == "pcg64si":
            f.write("rng pcg64si\n")
        elif mode == "grid":
            f.write("density_file dens.npy\n")
        elif mode.startswith("stretched"):
            f.write(STRETCH)
        elif mode.startswith("fast_math0"):
            f.write("fast_math 0\n")
    if mode in NO_PITCH_MODES:
        return deck, 1_000_000 if mode.endswith("_1m") else 10_000_000, None
    if mode == "table":
        keys, values = xs.resonance_log_table()
        for name in ("elastic_scatter.cs", "capture.cs"):
            xs.write_cs_file(os.path.join(d, name), keys, values)
    elif mode == "grid":
        cfg = driver.load_config(scatter)
        rng = np.random.default_rng(7)
        dens = rng.uniform(1.0e3, 2.0e4, size=(cfg.ny, cfg.nx))
        dens[rng.random((cfg.ny, cfg.nx)) < 0.25] = 0.0
        np.save(os.path.join(d, "dens.npy"), dens)
    return deck, 1_000_000, None


def census(reps: int, mode: str, tmp: str, dtype: str = "float32",
           tally: str | None = None) -> dict:
    """Milliseconds of `reps` scatter censuses of `mode` through the sweep
    kernel in `dtype` into a tally of `tally` (None: `dtype`), with the
    census's counts, end-state digest and slot use."""
    import dataclasses
    import hashlib
    import torch
    from neutral_tpu_torch import census, driver, sweep_kernel, transport
    from neutral_tpu_torch.particles import STATE_FIELDS

    tally = tally or dtype
    deck, nparticles, window = census_deck(mode, tmp)
    cfg = driver.load_config(deck).with_(nparticles=nparticles,
                                         expected_tally=None)
    if (dtype, tally) != (cfg.dtype, cfg.tally_dtype):
        cfg = cfg.with_(dtype=dtype, tally_dtype=tally)
    sim = driver.Simulation(cfg, device="cuda", engine="plain",
                            transport="sweep", quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    geom, win = sim.geom, {}
    if window is not None:
        geom = dataclasses.replace(geom, nx=window[2], ny=window[3])
        win = {"x_off": window[0], "y_off": window[1]}
    buffers = sweep_kernel.SweepBuffers("cuda")
    times = []
    for rep in range(reps + 1):
        state = start.clone()
        tally = torch.zeros(geom.nx * geom.ny, dtype=sim.tally.dtype,
                            device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, nf, nc, launches = census.sweep_chunk_kernel(
            state, tally, geom, sim.cs_scatter, sim.cs_absorb, 1,
            1.0 / cfg.nparticles, **win, buffers=buffers)
        torch.cuda.synchronize()
        if rep:                                   # the first is a warm-up
            times.append((time.perf_counter() - t0) * 1e3)
    digest = hashlib.sha256()
    for f in STATE_FIELDS:
        digest.update(getattr(state, f).cpu().numpy().tobytes())
    name = f"census {mode}" + pair_name(dtype, tally)
    return {"deck": name, "shards": 1, "decomposition": None,
            "census_ms": times, "min_ms": min(times),
            "median_ms": sorted(times)[len(times) // 2], "facets": nf,
            "collisions": nc, "launches": launches, "nparticles": nparticles,
            "state_sha256": digest.hexdigest(),
            "slot_use_pid_order": sweep_kernel.thread_slot_use(
                state.counter - start.counter),
            "slot_use": buffers.slot_use(),
            "grid_blocks": buffers.grid[0]}


def table_deck(deck: str, tmp: str) -> str:
    """A copy of `deck` in `tmp` beside 30,000-entry `.cs` tables
    (xs.resonance_log_table), under its own basename."""
    import shutil
    from neutral_tpu_torch import xs

    d = os.path.join(tmp, "table")
    os.makedirs(d, exist_ok=True)
    keys, values = xs.resonance_log_table()
    for name in ("elastic_scatter.cs", "capture.cs"):
        xs.write_cs_file(os.path.join(d, name), keys, values)
    shutil.copy(deck, d)
    return os.path.join(d, os.path.basename(deck))


def flight(reps: int, tmp: str, dtype: str = "float32",
           tally: str | None = None) -> list:
    """The flight kernel's own milliseconds over `reps` split censuses at
    1,000,000 particles in `dtype` into a tally of `tally` (None: `dtype`),
    analytic and in table mode."""
    import hashlib
    import torch
    from neutral_tpu_torch import census, driver, flight_kernel, transport
    from neutral_tpu_torch.particles import STATE_FIELDS

    tally = tally or dtype
    split = "problems/split.params"
    out = []
    for mode, deck in (("analytic", split), ("table", table_deck(split, tmp))):
        cfg = driver.load_config(deck).with_(expected_tally=None)
        if (dtype, tally) != (cfg.dtype, cfg.tally_dtype):
            cfg = cfg.with_(dtype=dtype, tally_dtype=tally)
        sim = driver.Simulation(cfg, device="cuda", engine="plain",
                                transport="flight", quiet=True)
        start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                         cfg.dt, 1)
        # (float32 as a checkout from before float64 flight calls it, a
        # tally of the state's type as one from before the mixed pairs)
        kw = ({} if tally == dtype else {"tally_dtype": sim.tally.dtype})
        buffers = (flight_kernel.FlightBuffers(cfg.nx, cfg.ny, "cuda")
                   if dtype == tally == "float32" else
                   flight_kernel.FlightBuffers(cfg.nx, cfg.ny, "cuda",
                                              dtype=sim.dtype, **kw))
        times, launches = [], 0
        for rep in range(reps + 1):
            state = start.clone()
            _, nf, nc, launches, ph = census.flight_chunk_kernel(
                state, torch.zeros_like(sim.tally), sim.geom, sim.cs_scatter,
                sim.cs_absorb, 1, 1.0 / cfg.nparticles, buffers=buffers)
            if rep:                               # the first is a warm-up
                times.append(ph["flight"] * 1e3)
        digest = hashlib.sha256()
        for f in STATE_FIELDS:
            digest.update(getattr(state, f).cpu().numpy().tobytes())
        name = f"flight {mode}" + pair_name(dtype, tally)
        out.append({"deck": name, "shards": 1,
                    "decomposition": None, "flight_ms": times,
                    "min_ms": min(times),
                    "median_ms": sorted(times)[len(times) // 2],
                    "facets": nf, "collisions": nc, "launches": launches,
                    "nparticles": cfg.nparticles,
                    "state_sha256": digest.hexdigest()})
        del sim, start, state, buffers
    return out


def deposit(reps: int, deck: str, rows_path: str | None,
            dtype: str = "float32", tally: str | None = None) -> dict:
    """Milliseconds of `reps` segment deposits of `deck`'s step-1 rows in
    `dtype` into a tally of `tally` (None: `dtype`)."""
    import torch
    from neutral_tpu_torch import (census, driver, flight_kernel,
                                   raster_kernel)
    from neutral_tpu_torch import transport

    tally_name = tally or dtype
    cfg = driver.load_config(deck).with_(expected_tally=None)
    if (dtype, tally_name) != (cfg.dtype, cfg.tally_dtype):
        cfg = cfg.with_(dtype=dtype, tally_dtype=tally_name)
    if rows_path and os.path.exists(rows_path):
        rows = torch.load(rows_path).cuda()
    else:
        sim = driver.Simulation(cfg, device="cuda", engine="plain",
                                transport="flight", quiet=True)
        start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                         cfg.dt, 1)
        segs = []
        census.flight_chunk_kernel(
            start, torch.zeros_like(sim.tally), sim.geom, sim.cs_scatter,
            sim.cs_absorb, 1, 1.0 / cfg.nparticles, segments=segs)
        rows = torch.cat(segs).contiguous()
        del sim, start, segs
        if rows_path:
            torch.save(rows.cpu(), rows_path)
    nseg = torch.tensor([rows.shape[0]], dtype=torch.int64, device="cuda")
    tally = torch.zeros(cfg.nx * cfg.ny, dtype=getattr(torch, tally_name),
                        device="cuda")
    tiled = hasattr(raster_kernel, "SegmentDeposit")
    kw, stages = {}, []
    if tiled:
        # (float32 as a checkout from before float64 deposits calls it, a
        # tally of the rows' type as one from before the mixed pairs)
        mixed = ({} if tally.dtype == rows.dtype
                 else {"tally_dtype": tally.dtype})
        kw["deposit"] = (raster_kernel.SegmentDeposit(cfg.nx, cfg.ny, "cuda")
                         if dtype == tally_name == "float32" else
                         raster_kernel.SegmentDeposit(cfg.nx, cfg.ny, "cuda",
                                                      dtype=rows.dtype,
                                                      **mixed))
        kw["stages"] = stages
    times, bin_ms, tile_ms = [], [], []
    for rep in range(reps + 1):
        tally.zero_()
        stages.clear()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        raster_kernel.deposit_segments_kernel(tally, rows, nseg, cfg.nx,
                                              cfg.ny, **kw)
        ev[1].record()
        torch.cuda.synchronize()
        if rep:                                   # the first is a warm-up
            times.append(ev[0].elapsed_time(ev[1]))
            for ev0, ev1, ev2 in stages[-1:]:
                bin_ms.append(ev0.elapsed_time(ev1))
                tile_ms.append(ev1.elapsed_time(ev2))
    out = {"deck": deck + pair_name(dtype, tally_name),
           "rows": rows.shape[0], "deposit_ms": times,
           "min_ms": min(times), "median_ms": sorted(times)[len(times) // 2],
           "tally_sum": float(tally.double().sum())}
    if tiled:
        out.update(bin_ms=bin_ms, tile_ms=tile_ms, **kw["deposit"].stats())
    return out


def card_list(ncards: int, nshards: int) -> list:
    """The devices of `nshards` shards over the first `ncards` cards, in
    turn (`ncards` 1: every shard on cuda:0)."""
    import torch
    if ncards > torch.cuda.device_count():
        raise ValueError(f"--cards {ncards}, but the machine shows "
                         f"{torch.cuda.device_count()}")
    return [torch.device("cuda", i % ncards) for i in range(nshards)]


def sim_cards(sim) -> list:
    """The cards this process's part of `sim` runs on."""
    shards = getattr(sim, "shards", None)
    return sorted({sh.device for sh in shards} if shards else {sim.device},
                  key=str)


def join_processes(coordinator: str, processes: int, process_id: int):
    """Join the run over `processes` processes with the package on
    sys.path, and return its devices rule: a package whose
    initialise_distributed takes a device places each process's shards on
    its own cards (its shard_devices); an older one (gloo alone) put
    process r's shards on cuda:(r % cards), as its CLI did."""
    import inspect
    import torch
    from neutral_tpu_torch.parallel import distributed, shard_devices

    init = distributed.initialise_distributed
    if "device" in inspect.signature(init).parameters:
        init(coordinator, processes, process_id, device="cuda")
        return lambda n: shard_devices(n, "cuda")
    init(coordinator, processes, process_id)
    dev = torch.device("cuda", process_id % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return lambda n: [dev] * n


def run(deck: str, shards: int, decomposition: str, reps: int,
        dtype: str | None = None, transport: str = "auto",
        tally: str | None = None, cards: int = 1,
        process: tuple | None = None) -> list:
    """Every step of `deck` at full size, on one device or `shards`
    shards over the first `cards` cards in turn, `reps` times after a
    warm-up run, in `dtype` (the state's, and the tally's unless `tally`
    names its own; None: the deck's) on `transport`.  `process`
    (coordinator, processes, process_id): this process's part of a run
    over several processes, its shards on its own cards."""
    import torch
    from neutral_tpu_torch import driver

    cfg = driver.load_config(deck)
    if dtype or tally:
        cfg = cfg.with_(dtype=dtype or cfg.dtype,
                        tally_dtype=tally or dtype or cfg.dtype)
    if process:
        devices = join_processes(*process)(shards)
    else:
        devices = card_list(cards, shards)
    kw = {} if transport == "auto" else {"transport": transport}
    # warm-up run: builds the kernels, fills PyTorch's caches
    sim = driver.make_simulation(cfg, decomposition, devices, quiet=True,
                                 **kw)
    sim.run()
    used = sim_cards(sim)
    del sim
    out = []
    for _ in range(reps):
        for d in used:
            torch.cuda.reset_peak_memory_stats(d)
        sim = driver.make_simulation(cfg, decomposition, devices, quiet=True,
                                     **kw)
        sim.run()
        phases = {}
        for m in sim.step_metrics:
            for k, v in m.phases.items():
                phases[k] = phases.get(k, 0.0) + v
        ms = sim.step_metrics
        name = " ".join([deck] + ([dtype] if dtype else [])
                        + ([f"tally {tally}"] if tally and tally != (
                            dtype or "float32") else [])
                        + ([transport] if kw else []))
        peaks = {str(d): torch.cuda.max_memory_allocated(d) / 2**30
                 for d in used}
        out.append({"deck": name,
                    "shards": shards,
                    "decomposition": decomposition if shards > 1 else None,
                    "cards": len(used) if not process else cards,
                    "processes": process[1] if process else 1,
                    "steps_s": [m.step_time for m in ms],
                    "total_s": sum(m.step_time for m in ms),
                    "phases": phases,
                    "launches": sum(m.nlaunches for m in ms),
                    "migrated": sum(m.nmigrated for m in ms),
                    "exchanged": sum(m.nexchanged for m in ms),
                    "facets": sum(m.nfacets for m in ms),
                    "collisions": sum(m.ncollisions for m in ms),
                    "tally": float(sim.host_tally().sum()),
                    "peak_gib": max(peaks.values()),
                    "peak_gib_per_card": peaks})
        del sim
    return out


PROCESS_TIMEOUT = 1800           # seconds a process of `run --processes` may take


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(argv: list, processes: int, cards: int) -> list:
    """`run` over `processes` processes that see the first `cards` cards
    (CUDA_VISIBLE_DEVICES): this file once per process with `argv` and its
    rank, joined through a coordinator on 127.0.0.1, each given
    PROCESS_TIMEOUT seconds.  Returns one record per timed run: process
    0's, with every process's peak memory per card (keyed "process r
    cuda:i") and, per process, its step times."""
    coordinator = f"127.0.0.1:{free_port()}"
    env = {**os.environ,
           "CUDA_VISIBLE_DEVICES": ",".join(map(str, range(cards)))}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *argv,
         "--coordinator", coordinator, "--process-id", str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(processes)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROCESS_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-6000:], file=sys.stderr)
            raise RuntimeError(f"run: process {r} exited {p.returncode}")
    recs = [[json.loads(line) for line in out.splitlines()
             if line.startswith("{")] for out in outs]
    merged = []
    for per_rep in zip(*recs):
        rec = dict(per_rep[0])
        rec["peak_gib_per_card"] = {
            f"process {r} {d}": v for r, x in enumerate(per_rep)
            for d, v in x["peak_gib_per_card"].items()}
        rec["peak_gib"] = max(rec["peak_gib_per_card"].values())
        rec["steps_s_per_process"] = [x["steps_s"] for x in per_rep]
        merged.append(rec)
    return merged


def tail(deck: str, decomposition: str | None, steps: bool,
         cards: int = 1) -> list:
    """Per flight-kernel launch of step 1 (every step with `steps`) of the
    full `deck`, on one device or on four shards over the first `cards`
    cards under `decomposition`: the lanes the launch covers, the lanes
    with work at its start and still working after it, and its device
    milliseconds."""
    from neutral_tpu_torch import driver

    cfg = driver.load_config(deck)
    devices = card_list(cards, 4 if decomposition else 1)
    make = functools.partial(driver.make_simulation, cfg,
                             decomposition or "replicated", devices,
                             quiet=True)
    make().step(1)                   # warm-up: builds, caches, allocates
    sim = make()
    out = []
    for tt in range(1, (cfg.niters if steps else 1) + 1):
        m = sim.step(tt)
        recs = [dict(r) for r in m.rounds]
        # Lanes with work at a launch's start: what the shard's previous
        # launch left, or for its first launch of the step the live lanes
        # (one device) or the lanes it covers (a shard).  A launch is in
        # the tail when that is below 10% of its shard's first launch's.
        last, start = {}, {}
        for r in recs:
            s = r["shard"]
            r["active"] = last.get(s, m.nprocessed if len(devices) == 1
                                   else r["lanes"])
            start.setdefault(s, r["active"])
            r["tail"] = r["active"] < 0.1 * start[s]
            last[s] = r["working"]
            r["shard"] = list(start).index(s)
        tail_recs = [r for r in recs if r.pop("tail")]
        out.append({"deck": deck, "decomposition": decomposition,
                    "step": tt, "nprocessed": m.nprocessed,
                    "launches": len(recs),
                    "flight_ms": sum(r["flight_ms"] for r in recs),
                    "launches_below_10pct": len(tail_recs),
                    "ms_below_10pct": sum(r["flight_ms"] for r in tail_recs),
                    "step_s": m.step_time, "phases": m.phases,
                    "per_launch": recs})
    return out


def compare(path: str, key: str) -> list:
    """Per (deck, shards, decomposition) and checkout, the spread of `key`
    over the `run` records in `path`; the first checkout met is the
    reference."""
    import numpy as np

    groups = {}
    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            r = json.loads(line)
            v = r
            for k in key.split("."):
                v = v.get(k) if isinstance(v, dict) else None
            if v is None or "root" not in r:
                continue
            g = groups.setdefault((r["deck"], r.get("shards"),
                                   r.get("decomposition"),
                                   r.get("cards", 1),
                                   r.get("processes", 1)), {})
            g.setdefault(r["root"], []).extend(
                v if isinstance(v, list) else [v])
    out = []
    for (deck, shards, dec, cards, procs), by_root in groups.items():
        rec = {"deck": deck, "shards": shards, "decomposition": dec,
               "cards": cards, "processes": procs, "key": key}
        for root, v in by_root.items():
            v = np.asarray(v)
            rec[root] = {"n": int(v.size), "median": float(np.median(v)),
                         "min": float(v.min()),
                         "p25": float(np.percentile(v, 25)),
                         "p75": float(np.percentile(v, 75))}
        roots = list(by_root)
        if len(roots) == 2:
            a, b = rec[roots[0]], rec[roots[1]]
            rec["ratio_median"] = b["median"] / a["median"]
            rec["ratio_min"] = b["min"] / a["min"]
        out.append(rec)
    return out


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


def _demangle(names: list[str]) -> dict:
    """Mangled -> demangled names, by the CUDA toolkit's cu++filt (or
    c++filt)."""
    import shutil
    from neutral_tpu_torch import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cu++filt")
    if not os.path.isfile(tool):
        tool = shutil.which("c++filt")
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    return dict(zip(names, out.splitlines()))


def kernel_pair(demangled: str) -> tuple | None:
    """(working type, tally type) of a kernel, from its template arguments
    (the sweep kernel's `..., float, (nt::EdgeMode)0, double>`: a float32
    state and a float64 tally; one type: the kernel's working type, and a
    tally of that type or none), or None for a kernel without one."""
    m = re.search(r"<(.*)>\(", demangled)
    types = re.findall(r"\b(float|double)\b", m[1]) if m else []
    if not types:
        return None
    names = {"float": "float32", "double": "float64"}
    return names[types[0]], names[types[-1]]


def _kernel_name(demangled: str) -> str:
    """A kernel's name with its float32 instantiation named as before the
    working type was a template parameter, a pitch-mode sweep kernel as
    before the edge mode was one, and an instantiation whose tally is of
    its working type as before the tally type was one (a state and a tally
    of different types keep their whole name: no older name to match)."""
    pair = kernel_pair(demangled)
    if pair is not None and pair[0] != pair[1]:
        return demangled
    # a tally of the working type: the kernel's last template argument
    # (after the sweep kernel's edge mode) dropped
    name = re.sub(r"(<|, )(float|double)((?:, \([\w:]+\)\d+)?), \2>\(",
                  r"\1\2\3>(", demangled)
    name = re.sub(r", \([\w:]*EdgeMode\)0>", ">", name)
    name = name.replace(", float>", ">").replace("<float>", "")
    # the parameter struct's template, however the demangler spells it
    name = re.sub(r"\b(Sweep|Begin|Flight|Raster)ParamsT(<[\w, ]+>)?",
                  r"\1Params", name)
    # a kernel left without template arguments: no return type, as before
    return re.sub(r"^void (<unnamed>|\(anonymous namespace\))(::\w+\()",
                  r"\1\2", name)


def kernels(sass_file: str | None = None, pair: tuple | None = None) -> list:
    """Per kernel of the library that build.py makes from this package's
    csrc/ (only those of the (working type, tally type) `pair`, if given):
    ptxas's registers, spills and stack, and a digest of its SASS."""
    import hashlib
    from neutral_tpu_torch import build

    path, log = build.build()
    props, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m[1]
            props[entry] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            props[entry].update(stack=int(m[1]), spill_stores=int(m[2]),
                                spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            props[entry]["registers"] = int(m[1])
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], text=True,
                          capture_output=True, check=True).stdout
    if sass_file:
        with open(sass_file, "w") as f:
            f.write(sass)
    code, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\w+)", line)
        if m:
            fn = m[1]
            code[fn] = []
            continue
        if fn and "/*" in line and ";" in line:
            text = re.sub(r"/\*[^*]*\*/", "", line).strip()
            if text:
                code[fn].append(text)
    names = _demangle(sorted(set(props) | set(code)))
    if pair is not None:
        names = {k: v for k, v in names.items() if kernel_pair(v) == pair}
    return [{"kernel": _kernel_name(names[k]),
             "sass_sha256": hashlib.sha256(
                 "\n".join(code.get(k, [])).encode()).hexdigest()[:16],
             "sass_lines": len(code.get(k, [])), **props.get(k, {})}
            for k in sorted(names, key=lambda k: _kernel_name(names[k]))]


KERNEL_KEYS = ("sass_sha256", "registers", "spill_stores", "spill_loads",
               "stack")


def kernels_diff(parent_file: str, change_file: str) -> dict:
    """The kernels of two `kernels` listings matched by name: counts, and
    the names that changed or went."""
    def load(path):
        with open(path) as f:
            return {r["kernel"]: r for r in map(json.loads, f) if r}

    par, new = load(parent_file), load(change_file)
    both = [k for k in par if k in new]
    changed = [k for k in both
               if any(par[k].get(x) != new[k].get(x) for x in KERNEL_KEYS)]
    return {"what": "kernels-diff", "parent": len(par), "change": len(new),
            "matched": len(both), "unchanged": len(both) - len(changed),
            "changed": changed, "only_parent": [k for k in par
                                                if k not in new],
            "only_change": len([k for k in new if k not in par])}


def build_times(reps: int, merge: list[str]) -> list:
    """Per rep: the wall time of a build of this package's kernel library
    from nothing (every translation unit's nvcc started together, then the
    link) and each unit's seconds, with the sources in `merge` compiled as
    one unit."""
    import threading
    from pathlib import Path
    from neutral_tpu_torch import build

    missing = [m for m in merge if not (build.CSRC_DIR / m).is_file()]
    if missing or len(merge) == 1:
        raise SystemExit(f"--merge takes two or more sources of "
                         f"{build.CSRC_DIR}, not {merge}")
    nvcc, out = build.nvcc_path(), []

    def compile_unit(unit: Path, tmp: str, secs: dict) -> None:
        t0 = time.perf_counter()
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-c", str(unit), "-o",
                        os.path.join(tmp, f"{unit.stem}.o")], check=True,
                       capture_output=True)
        secs[unit.name] = time.perf_counter() - t0

    for rep in range(reps):
        with tempfile.TemporaryDirectory() as tmp:
            units = [s for s in build.sources()
                     if s.suffix == ".cu" and s.name not in merge]
            if merge:
                unit = Path(tmp) / ("+".join(Path(m).stem for m in merge)
                                    + ".cu")
                unit.write_text("".join(f'#include "{build.CSRC_DIR / m}"\n'
                                        for m in merge))
                units.append(unit)
            secs = {}
            t0 = time.perf_counter()
            threads = [threading.Thread(target=compile_unit,
                                        args=(u, tmp, secs)) for u in units]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if len(secs) != len(units):
                raise RuntimeError("a translation unit failed to compile")
            t1 = time.perf_counter()
            subprocess.run([nvcc, *build.GENCODE, "-shared", "-o",
                            os.path.join(tmp, "lib.so"),
                            *(os.path.join(tmp, f"{u.stem}.o")
                              for u in units)], check=True,
                           capture_output=True)
            out.append({"what": "build", "rep": rep, "merge": merge,
                        "wall_s": time.perf_counter() - t0,
                        "link_s": time.perf_counter() - t1,
                        "units_s": dict(sorted(secs.items()))})
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="measure", description=__doc__.split(
        "\n\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    c = sub.add_parser("census", help="time the scatter census per mode")
    c.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package to time")
    c.add_argument("--reps", type=int, default=5)
    c.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    c.add_argument("--tally-dtype", default=None,
                   choices=["float32", "float64"])
    c.add_argument("--modes", nargs="+", default=list(CENSUS_MODES),
                   choices=[*CENSUS_MODES, *NO_PITCH_MODES])
    g = sub.add_parser("flight", help="time split's flight kernel per mode")
    g.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package to time")
    g.add_argument("--reps", type=int, default=5)
    g.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    g.add_argument("--tally-dtype", default=None,
                   choices=["float32", "float64"])
    d = sub.add_parser("deposit", help="time the segment deposit")
    d.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package to time")
    d.add_argument("--reps", type=int, default=5)
    d.add_argument("--rows", default=None,
                   help="file of the rows (torch.save), read if it exists")
    d.add_argument("--deck", default="problems/stream.params")
    d.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    d.add_argument("--tally-dtype", default=None,
                   choices=["float32", "float64"])
    r = sub.add_parser("run", help="time every step of a full deck")
    r.add_argument("deck")
    r.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package to run")
    r.add_argument("--reps", type=int, default=1)
    r.add_argument("--shards", type=int, default=1)
    r.add_argument("--decomposition", default="replicated",
                   choices=["replicated", "spatial", "spatial2d"])
    r.add_argument("--dtype", default=None, choices=["float32", "float64"])
    r.add_argument("--tally-dtype", default=None,
                   choices=["float32", "float64"])
    r.add_argument("--transport", default="auto",
                   choices=["auto", "sweep", "flight"])
    r.add_argument("--cards", type=int, nargs="+", default=[1],
                   help="spread the shards over this many cards in turn "
                        "(several counts: one after the other, in one "
                        "process); with --processes, the cards the "
                        "processes see")
    r.add_argument("--processes", type=int, default=1,
                   help="run over this many processes (their shards on "
                        "their own cards: the package's rule)")
    r.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    r.add_argument("--process-id", type=int, default=None,
                   help=argparse.SUPPRESS)
    m = sub.add_parser("compare", help="compare the records of `run`")
    m.add_argument("file")
    m.add_argument("--key", default="total_s")
    s = sub.add_parser("scaled", help="the scaled 4096^2 configuration")
    s.add_argument("--nparticles", type=int, default=100_000_000)
    t = sub.add_parser("tail", help="per-launch lanes of the flight kernel")
    t.add_argument("deck")
    t.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package to run")
    t.add_argument("--decomposition", default=None,
                   choices=["replicated", "spatial", "spatial2d"])
    t.add_argument("--steps", action="store_true",
                   help="every step of the deck, not step 1 alone")
    t.add_argument("--cards", type=int, default=1,
                   help="spread the four shards over this many cards")
    k = sub.add_parser("kernels", help="registers, spills and SASS digests")
    k.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose kernels to build")
    k.add_argument("--sass", default=None, help="write the SASS listing here")
    k.add_argument("--dtype", default=None, choices=["float32", "float64"])
    k.add_argument("--tally-dtype", default=None,
                   choices=["float32", "float64"])
    x = sub.add_parser("kernels-diff", help="two `kernels` listings")
    x.add_argument("parent")
    x.add_argument("change")
    b = sub.add_parser("build", help="time the kernel library's build")
    b.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose kernels to build")
    b.add_argument("--reps", type=int, default=2)
    b.add_argument("--merge", nargs="+", default=[],
                   help="sources of csrc/ to compile as one unit")
    args = p.parse_args(argv)

    if args.what == "compare":
        for r in compare(args.file, args.key):
            print(json.dumps(r), flush=True)
        return 0
    if args.what == "kernels-diff":
        print(json.dumps(kernels_diff(args.parent, args.change)), flush=True)
        return 0
    if (args.what == "run" and args.processes > 1
            and args.process_id is None):
        if len(args.cards) != 1:
            p.error("--processes takes one --cards count")
        rec = run_processes(argv if argv is not None else sys.argv[1:],
                            args.processes, args.cards[0])
    elif args.what in ("census", "flight", "deposit", "run", "tail",
                       "kernels", "build"):
        # This file's own directory would shadow nothing useful: the
        # package comes from the root asked for.
        rows = args.what == "deposit" and args.rows
        rows = os.path.abspath(rows) if rows else None
        sass = (os.path.abspath(args.sass)
                if args.what == "kernels" and args.sass else None)
        sys.path[0] = os.path.abspath(args.root)
        os.chdir(args.root)
        if args.what == "census":
            with tempfile.TemporaryDirectory() as tmp:
                rec = [census(args.reps, m, tmp, args.dtype,
                              args.tally_dtype) for m in args.modes]
        elif args.what == "flight":
            with tempfile.TemporaryDirectory() as tmp:
                rec = flight(args.reps, tmp, args.dtype, args.tally_dtype)
        elif args.what == "deposit":
            rec = [deposit(args.reps, args.deck, rows, args.dtype,
                           args.tally_dtype)]
        elif args.what == "tail":
            rec = tail(args.deck, args.decomposition, args.steps,
                       args.cards)
        elif args.what == "build":
            rec = build_times(args.reps, args.merge)
        elif args.what == "kernels":
            dtype = args.dtype or args.tally_dtype
            rec = kernels(sass, (dtype, args.tally_dtype or dtype)
                          if dtype else None)
        else:
            rec = [r for cards in args.cards for r in run(
                args.deck, args.shards, args.decomposition, args.reps,
                args.dtype, args.transport, args.tally_dtype, cards,
                (args.coordinator, args.processes, args.process_id)
                if args.process_id is not None else None)]
        for r in rec:
            r["root"] = args.root
    else:
        sys.path[0] = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        rec = scaled(args.nparticles)
    for r in rec:
        r["card"] = card()
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
