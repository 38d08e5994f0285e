"""Simulation driver: timestep loop, metric contract, validation, CLI.

Port of `neutral_tpu/driver.py` for one device.  The per-step print is the
reference's metric contract (main.c:118-125), so runs compare line by
line with the reference and with the JAX package:

    Iteration  <tt>
    Handled <n> particles, with <k> event sweeps
    Step time  <s>
    Wallclock  <s>
    Facets     <n>
    Collisions <n>
    Facet Events / s <rate>
    Collision Events / s <rate>
    ...
    Final global_energy_tally <sum>
    PASSED validation.        (or FAILED ..., against problems/neutral.tests)
    Final Wallclock <s>
    Elapsed Simulation Time <s>

Two choices decide how a census runs.  The transport: `sweep` steps each
particle one event (facet, collision or census) at a time (transport.py);
`flight` moves it one closed-form flight piece at a time across any number
of cells and deposits the interior cells as line segments (flight.py,
raster.py).  `auto` takes flight when the deck has a region of density
below 1.0 (a near-vacuum region, where facet events dominate: stream, csp,
split) and sweep otherwise (scatter).  The engine: `kernel` runs the
census through the transport's CUDA kernels (sweep_kernel.py, or
flight_kernel.py with raster_kernel.py), each census started by the begin
kernel (begin_kernel.py), every shard's particles injected by the inject
kernel (inject_kernel.py), and needs a CUDA device; `plain`
runs the plain PyTorch version on any device, and on CUDA only when asked
for by name; `auto` is `kernel` on CUDA and `plain` otherwise
(`pick_engine`).  Every kernel runs float32 and float64 (float64 in
global coordinates, as `neutral_tpu`'s XLA float64 engines): `auto` never
gives a float64 deck the flight transport (`neutral_tpu`'s `is_f32`
rule), and an explicit `--transport flight --dtype float64` runs the
float64 flight and segment-deposit kernels, as JAX's `engine="flight"`
runs its XLA flight engine in float64 on a GPU or CPU.
Grid decks (`density_file`) run on the sweep transport only.  Decks
without a uniform pitch, non-uniform meshes and `fast_math 0`, run on the
sweep transport, as JAX runs them on its XLA edge-array sweep: on a card
through the sweep kernel's edge-array mode and the begin kernel, in
float32 and float64 (`auto` picks `kernel` and `sweep` for them), and
`--transport flight` raises for them (closed-form flight needs a pitch).

Runs go to the card unless the caller asks for the CPU (`device="cpu"`,
`--device cpu`); without a card a CUDA run raises or exits non-zero, and
never falls back to the CPU.  With more than one shard (`--shards`, by
default one per visible card) the CLI runs one of the decompositions of
parallel/ (`--decomposition replicated|spatial|spatial2d`), several shards
may share one card; with one it runs `Simulation`, which holds one shard
over the whole mesh.  Both share `SimulationBase`: set-up, the step (the
census loop of census.py over the layout's shards, and its StepMetrics),
the step print, validation and the phase breakdown.

Around the loop: VisIt dumps (`visit_dump 1`), npz checkpoints that any
layout restores (`--checkpoint`, `--restore`: the run resumes at the step
after the checkpoint), a torch.profiler trace of set-up and the run
(`--trace-dir`: the program's `nt.*` spans, profiler.span, beside the
kernels), and `--backend native`, the history-based C++ engine on the
host (native/), which prints the same per-step contract.

A run may span processes, the counterpart of the reference's MPI launch
(main.c:62-64): `--coordinator HOST:PORT --num-processes W --process-id
r` in each of W processes, or `--distributed` under `torchrun`
(parallel/distributed.py, gloo).  `--shards N` is then the global shard
count, which W must divide; each process drives its N/W shards, on
`cuda:(r % cards)` with `--device cuda`, always through a decomposition
class (even with one shard each), and process 0 alone prints and writes
files.  The printed counts are global; the step time and the phases are
process 0's.

The JAX driver's power-of-4 compaction ladder is not ported.  Its work
is done in the card's own form: each sweep or flight launch writes the
lanes still working into a list, and the next launch runs over that list
alone (sweep_kernel.py; on the flight transport with pieces per lane that
grow as the list shrinks, flight_kernel.py).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from . import census, io_utils
from .census import StepMetrics, flight_chunk_kernel, sweep_chunk_kernel
from .config import SimConfig, load_config
from .constants import VALIDATE_TOLERANCE
from .flight import disjoint_rects, flight_chunk_plain
from .flight_kernel import launch_records
from .mesh import build_mesh, density_grid, region_cell_bounds
from .particles import ParticleState, merge_states, state_from_numpy
from .profiler import Profile, Spans, maybe_trace, span
from .sweep_kernel import MAX_EVENTS, sweep_chunk_plain
from .transport import Geometry, use_local_coords
from .xs import CrossSection, find_cs_files

ENGINES = ("auto", "plain", "kernel")
TRANSPORTS = ("auto", "sweep", "flight")
DECOMPOSITIONS = ("replicated", "spatial", "spatial2d")


def check_device(device: torch.device) -> torch.device:
    """`device` itself; raise on a CUDA device when PyTorch sees no card
    (a run never moves to the CPU by itself) or not the card it names."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was asked for, but torch.cuda.is_available() "
            'is False; pass device="cpu" to run the plain versions on the '
            "CPU")
    if (device.type == "cuda" and device.index is not None
            and device.index >= torch.cuda.device_count()):
        raise ValueError(f"device {device} was asked for, but PyTorch sees "
                         f"{torch.cuda.device_count()} card(s)")
    return device


def load_cross_sections(cfg: SimConfig, dtype: torch.dtype, device
                        ) -> tuple[CrossSection, CrossSection]:
    """(scatter, absorb) tables: user `.cs` files if present (cwd, then the
    deck's directory), else regenerated from the published formula.
    Tables on the generated grid take the analytic mode under fast_math."""
    paths = find_cs_files(cfg.params_path)
    if paths is None:
        return (CrossSection.resonance(dtype=dtype, analytic=cfg.fast_math,
                                       device=device),
                CrossSection.resonance(dtype=dtype, analytic=cfg.fast_math,
                                       device=device))
    tabs = []
    for path in paths:
        t = CrossSection.from_file(path, dtype=dtype, device=device)
        t.analytic = cfg.fast_math and t.quartic
        tabs.append(t)
    return tabs[0], tabs[1]


def make_geometry(cfg: SimConfig, dtype: torch.dtype = torch.float32,
                  device=None) -> Geometry:
    """Geometry of the whole domain, in `neutral_tpu`'s three cases
    (neutral_tpu/driver.py:183-222):

    * a region deck (fast_math) carries the problem regions as cell
      rectangles (mesh.region_cell_bounds) and, on a uniform mesh, the
      pitch and the regions' disjoint partition for the flight transport
      (flight.disjoint_rects);
    * a grid deck (`density_file`) carries its density field in `dtype` on
      `device`, with no regions and no rects, and the pitch on a uniform
      mesh;
    * fast_math 0 carries no pitch and no regions: the density of the
      region-built grid (mesh.density_grid), gathered per cell.

    Every geometry carries the edge arrays; one without a pitch (dx = dy =
    0: a non-uniform mesh, or fast_math 0) gathers its facet edges there.
    """
    if cfg.rng not in ("threefry", "pcg64si"):
        raise ValueError(f"unknown rng scheme {cfg.rng!r}")
    pitched = cfg.uniform_mesh and (cfg.fast_math or bool(cfg.density_file))
    mesh = build_mesh(cfg, dtype, device)
    base = dict(nx=cfg.nx, ny=cfg.ny,
                dx=cfg.width / cfg.nx if pitched else 0.0,
                dy=cfg.height / cfg.ny if pitched else 0.0,
                rng_scheme=cfg.rng, edgex=mesh.edgex, edgey=mesh.edgey)
    if cfg.uses_density_grid:
        return Geometry(regions=None, rects=None,
                        density=density_grid(cfg, dtype, device), **base)
    regions = region_cell_bounds(cfg)
    return Geometry(regions=regions,
                    rects=(disjoint_rects(regions, cfg.nx, cfg.ny)
                           if cfg.uniform_mesh else None), **base)


def pitch_refusal(cfg: SimConfig) -> str | None:
    """Why the deck's geometry has no uniform pitch, which the flight
    transport needs (neutral_tpu's reasons for its Pallas kernels,
    neutral_tpu/driver.py:312-327); None when it has one."""
    if not cfg.uniform_mesh:
        return ("requires a uniform mesh; this deck declares non-uniform "
                "edges (edgex_file/edgey_file/mesh_stretch_*)")
    if not (cfg.fast_math or cfg.density_file):
        return ("requires fast_math (a fast_math 0 deck gathers its edges "
                "and density per cell)")
    return None


def kernel_refusal(dtype: torch.dtype,
                   cfg: SimConfig | None = None) -> str | None:
    """Why no kernel runs this deck in `dtype` (None: the kernels run it):
    a working type, or a tally type (`cfg.tally_dtype`), other than
    float32 and float64.  Every pair of the two runs on the kernels of
    both transports: a tally of the state's type, or of the other (the
    mixed instantiations).  A deck without a pitch is no reason either:
    the sweep kernel takes it in edge-array mode, and the flight transport
    refuses it itself (pick_transport)."""
    if dtype not in (torch.float32, torch.float64):
        return f"needs float32 or float64, got {dtype}"
    if cfg is not None and cfg.tally_dtype not in ("float32", "float64"):
        return (f"needs a float32 or float64 tally, got a "
                f"{cfg.tally_dtype} tally")
    return None


def pick_engine(engine: str, device: torch.device, dtype: torch.dtype,
                cfg: SimConfig | None = None) -> str:
    """The engine that runs a deck: `auto` is `kernel` on a CUDA device
    where a kernel exists for the deck (`cfg`), its dtype and its tally's
    dtype (kernel_refusal: every float32/float64 pair on both
    transports), and `plain` everywhere else; `kernel` raises on the CPU
    and where kernel_refusal gives a reason."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine}")
    refusal = kernel_refusal(dtype, cfg)
    if engine == "auto":
        return ("kernel" if device.type == "cuda" and refusal is None
                else "plain")
    if engine == "kernel" and device.type != "cuda":
        raise ValueError(f"engine='kernel' needs a CUDA device, got {device}")
    if engine == "kernel" and refusal is not None:
        raise ValueError(f"engine='kernel' {refusal}; use --engine auto or "
                         "plain")
    return engine


def pick_transport(cfg: SimConfig, transport: str) -> str:
    """The transport that runs a deck: `auto` by auto_transport; `flight`
    raises for a deck that has no uniform pitch or no constant-density
    regions (a grid deck), which closed-form flight needs."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                         f"{transport}")
    if transport == "auto":
        return auto_transport(cfg)
    if transport == "flight":
        if not cfg.uniform_mesh:
            raise ValueError(f"transport='flight' {pitch_refusal(cfg)}; use "
                             "--transport auto or sweep")
        if cfg.uses_density_grid:
            raise ValueError("transport='flight' requires fast_math and "
                             "constant-density region rectangles; a "
                             "density_file or fast_math 0 deck runs on the "
                             "sweep transport")
    return transport


def auto_transport(cfg: SimConfig) -> str:
    """`neutral_tpu`'s rule for its free-flight engine
    (neutral_tpu/driver.py:303) without its TPU term, on every device:
    flight for a float32, uniform analytic deck with a region of density
    below 1.0 (near-vacuum regions, where facet events dominate), else
    sweep (a float64 deck always)."""
    if (cfg.fast_math and cfg.uniform_mesh and not cfg.density_file
            and cfg.dtype == "float32"
            and any(r.density < 1.0 for r in cfg.problems)):
        return "flight"
    return "sweep"


def within_tolerance(expected: float, actual: float, tol: float) -> bool:
    """Relative-tolerance check, as arch's within_tolerance."""
    if expected == 0.0:
        return abs(actual) <= tol
    return abs(actual - expected) / abs(expected) <= tol


def validation_line(expected: float | None, total: float) -> str:
    """The reference's verdict on a tally sum against its golden."""
    if expected is None:
        return "WARNING: could not find a golden result to validate against"
    if within_tolerance(expected, total, VALIDATE_TOLERANCE):
        return "PASSED validation."
    return f"FAILED validation: expected {expected:.12e}, got {total:.12e}"


class SimulationBase:
    """What every simulation shares: the deck's geometry, mesh and
    cross-sections on a device, the engine and transport, the timestep
    loop with the reference's per-step print, validation and the phase
    breakdown, and the step: the census loop (census.py) over
    `self.shards`, this process's shards.  Subclasses make the shards and
    run the census's passes (`passes`); `host_tally()` gives the global
    tally."""

    migrates = False        # lanes move between shards (spatial modes)
    read_counters = staticmethod(census.read_counters)

    def __init__(self, cfg: SimConfig, *, device="cuda", engine: str = "auto",
                 transport: str = "auto", quiet: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.quiet = quiet
        self.transport = pick_transport(cfg, transport)
        self.engine = pick_engine(engine, self.device, self.dtype, cfg)
        check_device(self.device)

        with span("setup.mesh"):
            self.geom = make_geometry(cfg, self.dtype, self.device)
            self.mesh = build_mesh(cfg, dtype=self.dtype, device=self.device)
        with span("setup.xs"):
            self.cs_scatter, self.cs_absorb = load_cross_sections(
                cfg, self.dtype, self.device)
            # The reference ships byte-identical capture/scatter tables;
            # when the loaded pair matches, one lookup serves both.
            if (torch.equal(self.cs_scatter.keys, self.cs_absorb.keys)
                    and torch.equal(self.cs_scatter.values,
                                    self.cs_absorb.values)):
                self.geom = dataclasses.replace(self.geom, same_xs=True)
        self.elapsed_sim_time = 0.0
        self.wallclock = 0.0
        self.last_step = 0          # the last step run (or restored)
        self.profile = Profile([self.device])
        from .parallel.distributed import rank, world
        # process 0 of a run over several processes alone writes files
        self.writes = rank() == 0
        self.world = world()
        self.scope = (f", process 0 of {self.world}" if self.world > 1
                      else "")
        self.step_metrics: list[StepMetrics] = []

    def coords(self) -> str:
        """Where x/y are measured from: "cell-local" on the sweep transport
        in float32 with a pitch (use_local_coords), "global" otherwise (the
        flight transport, float64, and decks without a pitch, on either
        engine: the sweep kernel's edge-array mode keeps them global)."""
        return ("cell-local" if self.transport == "sweep"
                and use_local_coords(self.geom, self.dtype) else "global")

    def source(self) -> dict:
        """inject_particles' source box and cell-local frame (coords)."""
        cfg = self.cfg
        local = self.coords() == "cell-local"
        return dict(source_x0=cfg.source.xpos * cfg.width,
                    source_y0=cfg.source.ypos * cfg.height,
                    source_width=cfg.source.width * cfg.width,
                    source_height=cfg.source.height * cfg.height,
                    rng_scheme=cfg.rng,
                    local_coords=(self.geom.dx, self.geom.dy) if local
                    else None)

    # -- the step -------------------------------------------------------------
    def step(self, tt: int) -> StepMetrics:
        """Advance one census timestep on every shard of this process
        (master_key = tt, as main.c:101); every count it returns is global,
        over every process's shards.  Its spans: nt.census, holding
        nt.begin (with nt.begin.read) and then nt.sweep around the passes
        (sweep transport) or one nt.flight.round a pass (flight
        transport), with each pass's read, the flight shards' after_round
        (nt.flight.host), and nt.migrate and nt.exchange (census.passes)."""
        flight = self.transport == "flight"
        self.profile.start()
        spans = Spans()
        with span("census", spans):
            begun = census.begin(self.shards, self.engine, self.cfg.dt, tt,
                                 spans, self.read_counters)
            # The sweep phase runs from here to the clock's stop.
            with contextlib.nullcontext() if flight else span("sweep",
                                                              spans):
                m = self.passes(tt, begun[:, 1] > 0, spans)
                step_time = self.profile.stop(f"step{tt}")
        wall = spans.seconds
        t_migrate = wall.get("migrate", 0.0)
        phases = {"begin": wall["begin"]}
        if flight:
            phases.update(m.phases)
            phases["loop"] = (wall["census"] - wall["begin"]
                              - m.phases["flight"] - m.phases["raster"]
                              - t_migrate)
        else:
            phases["sweep"] = wall["sweep"] - t_migrate
        if self.migrates:
            phases["migrate"] = t_migrate
            if self.world > 1:
                phases["exchange"] = wall.get("exchange", 0.0)
        m.step, m.step_time, m.phases = tt, step_time, phases
        m.nprocessed = int(begun[:, 0].sum())
        m.rounds = launch_records(m.rounds)
        m.nwaits = spans.waits()
        self.step_metrics.append(m)
        return m

    # -- what subclasses provide -------------------------------------------
    def passes(self, tt: int, work: np.ndarray,
               spans: Spans) -> StepMetrics:
        """The census's passes after its begin (census.passes), over the
        global shards that start with lanes (`work`)."""
        raise NotImplementedError

    def host_tally(self) -> np.ndarray:
        raise NotImplementedError

    def states(self) -> list[ParticleState]:
        """The particle states that hold every live lane once."""
        return [sh.state for sh in self.shards]

    def set_state(self, fields: dict, tally: np.ndarray) -> None:
        """Put a checkpoint's lanes and global tally in place."""
        raise NotImplementedError

    # -- checkpoints and dumps ------------------------------------------------
    def checkpoint(self, path: str, step: int) -> None:
        """Write an npz checkpoint (io_utils.save_checkpoint) after `step`:
        one lane per particle in pid order (particles.merge_states).  Every
        process of a run calls it; process 0 writes."""
        fields, tally = merge_states(self.states()), self.host_tally()
        if self.writes:
            io_utils.save_checkpoint(path, fields, tally, step,
                                     self.elapsed_sim_time,
                                     coords=self.coords())

    def restore(self, path: str) -> int:
        """Load an npz checkpoint written by any layout (or by neutral_tpu)
        whose coordinates match this run's; returns its step.  The run
        goes on with `run(start=step + 1)`."""
        fields, tally, step, t = io_utils.load_checkpoint(
            path, expect_coords=self.coords())
        self.set_state(fields, tally)
        self.elapsed_sim_time = t
        self.last_step = step
        return step

    def dump_density(self, tt: int) -> None:
        """density<tt>.bov/.dat: live particles per cell."""
        dens = sum(io_utils.particle_density(s, self.cfg.nx, self.cfg.ny)
                   for s in self.states())
        if self.writes:
            io_utils.write_bov(f"density{tt}", dens, variable="density",
                               time=self.elapsed_sim_time)

    def run(self, start: int = 1) -> float:
        """The timestep loop from step `start` to the deck's last.  Returns
        the global tally sum.  With `visit_dump`, it writes neutral_tpu's
        files into the working directory: density<tt> before step tt,
        energy<tt> (the tally) after it, and density<niters + 1> at the
        end."""
        out = self._print
        dump = self.cfg.visit_dump
        for tt in range(start, self.cfg.niters + 1):
            out(f"\nIteration  {tt}")
            if dump:
                self.dump_density(tt)
            m = self.step(tt)
            self.last_step = tt
            self.wallclock += m.step_time
            if self.engine == "kernel" and self.transport == "flight":
                # As below, with flight pieces: a piece is one collision,
                # rect exit or census, crossing any number of cells; the
                # count is the pieces the launches granted each lane.
                lanes = sorted(r["lanes"] for r in m.rounds)
                out(f"Handled {m.nprocessed} particles, with {m.nsweeps} "
                    f"event sweeps ({m.nlaunches} flight kernel launches "
                    "granting that many flight pieces per lane)")
                if m.rounds:
                    out(f"Flight launch lanes: first {m.rounds[0]['lanes']}, "
                        f"median {lanes[len(lanes) // 2]}, last "
                        f"{m.rounds[-1]['lanes']}; segment rows "
                        f"{sum(r['rows'] for r in m.rounds)}{self.scope}")
            elif self.engine == "kernel":
                # No sweeps exist here: each lane runs its events in one
                # thread.  The count printed in their place is kernel
                # launches x events per lane per launch, a bound on the
                # events any lane ran.
                out(f"Handled {m.nprocessed} particles, with "
                    f"{m.nlaunches * MAX_EVENTS} event sweeps "
                    f"({m.nlaunches} kernel launches x {MAX_EVENTS} "
                    "events)")
            elif self.transport == "flight":
                out(f"Handled {m.nprocessed} particles, with {m.nsweeps} "
                    "event sweeps (flight sweeps: one flight piece per "
                    "lane each)")
            else:
                out(f"Handled {m.nprocessed} particles, "
                    f"with {m.nsweeps} event sweeps")
            if "exchange" in m.phases:
                out(f"Migrated {m.nmigrated} particles between shards, "
                    f"{m.nexchanged} of them between processes")
            elif "migrate" in m.phases:
                out(f"Migrated {m.nmigrated} particles between shards")
            waits = f"Host waits {m.nwaits} (reads that waited for the device)"
            if self.engine == "kernel" and self.transport == "flight":
                # the segment deposits re-run after a piece-buffer overflow
                waits += f"; deposit re-runs {m.noverflows}"
            out(waits)
            out(f"Step time  {m.step_time:.4f}s")
            out(f"Wallclock  {self.wallclock:.4f}s")
            out(f"Facets     {m.nfacets}")
            out(f"Collisions {m.ncollisions}")
            out(f"Facet Events / s {m.nfacets / m.step_time:.2e}")
            out(f"Collision Events / s {m.ncollisions / m.step_time:.2e}")
            self.elapsed_sim_time += self.cfg.dt
            if dump:
                tally = self.host_tally().reshape(self.cfg.ny, self.cfg.nx)
                if self.writes:
                    io_utils.write_bov(f"energy{tt}", tally,
                                       variable="energy",
                                       time=self.elapsed_sim_time)
            if self.elapsed_sim_time >= self.cfg.sim_end:
                out("Reached end of simulation time")
                break
        if dump:
            self.dump_density(self.cfg.niters + 1)
        result = self.validate()
        out(f"Final Wallclock {self.wallclock:.9f}s")
        out(f"Elapsed Simulation Time {self.elapsed_sim_time:.6f}s")
        out(self.profile.summary())
        agg = {}
        for sm in self.step_metrics:
            for k, v in sm.phases.items():
                agg[k] = agg.get(k, 0.0) + v
        out(f"PHASE BREAKDOWN (cumulative{self.scope}): "
            + "  ".join(f"{k}={v:.4f}s" for k, v in agg.items()))
        return result

    def validate(self) -> float:
        """Global tally sum + golden comparison (omp3/neutral.c:520-557)."""
        total = float(self.host_tally().sum())
        out = self._print
        out(f"Final global_energy_tally {total:.15e}")
        out(validation_line(self.cfg.expected_tally, total))
        return total

    def _print(self, msg: str) -> None:
        if not self.quiet:
            print(msg, flush=True)


class Simulation(SimulationBase):
    """Single-device simulation, on the card unless `device` says
    otherwise: one shard over the whole mesh (census.new_shard), holding
    every pid."""

    def __init__(self, cfg: SimConfig, *, device="cuda", engine: str = "auto",
                 transport: str = "auto", quiet: bool = False):
        super().__init__(cfg, device=device, engine=engine,
                         transport=transport, quiet=quiet)
        self.shards = [census.new_shard(self, self.device, self.geom)]
        # Injection belongs to set-up, not to step 1's time.
        with span("setup.wait"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    @property
    def state(self) -> ParticleState:
        return self.shards[0].state

    @state.setter
    def state(self, state: ParticleState) -> None:
        self.shards[0].state = state

    @property
    def tally(self) -> torch.Tensor:
        return self.shards[0].tally

    def passes(self, tt: int, work: np.ndarray,
               spans: Spans) -> StepMetrics:
        """The one shard's census through this module's names
        sweep_chunk_kernel, flight_chunk_kernel, sweep_chunk_plain and
        flight_chunk_plain, looked up as the step runs (the benchmark's
        fault checks replace them, portbench/control.py)."""
        sh, out = self.shards[0], StepMetrics()
        args = (sh.state, sh.tally, sh.geom, *sh.tables, tt,
                1.0 / self.cfg.nparticles)
        kernel = self.engine == "kernel"
        if self.transport == "flight":
            sh.state, nf, nc, n, out.phases = (flight_chunk_kernel(
                *args, buffers=sh.buffers, rounds=out.rounds, spans=spans)
                if kernel else flight_chunk_plain(*args))
        else:
            sh.state, nf, nc, n = (sweep_chunk_kernel(
                *args, buffers=sh.buffers, spans=spans)
                if kernel else sweep_chunk_plain(*args))
        out.nfacets, out.ncollisions = nf, nc
        out.nlaunches, out.nsweeps = (
            (n, sum(r["pieces"] for r in out.rounds)) if kernel else (0, n))
        return out

    def host_tally(self) -> np.ndarray:
        """Flat (ny*nx,) tally as float64 on the host (one wait for the
        card), a copy that a later step leaves as it is, in a pinned block
        on a card (census.read_tallies)."""
        return census.read_tallies([self.tally])[0]

    def set_state(self, fields: dict, tally: np.ndarray) -> None:
        sh = self.shards[0]
        sh.state = state_from_numpy(fields, self.device, self.dtype)
        sh.tally = torch.as_tensor(np.asarray(tally),
                                   device=self.device).to(sh.tally.dtype)


def make_simulation(cfg: SimConfig, decomposition: str, devices: list,
                    **kw) -> SimulationBase:
    """`Simulation` on one device, or the decomposition's class over
    `devices` (parallel/) when there are several or the run spans
    processes."""
    from . import parallel
    with span("setup"):
        if len(devices) == 1 and parallel.distributed.world() == 1:
            return Simulation(cfg, device=devices[0], **kw)
        cls = {"replicated": parallel.ShardedSimulation,
               "spatial": parallel.SpatialSimulation,
               "spatial2d": parallel.Spatial2DSimulation}[decomposition]
        return cls(cfg, devices=devices, **kw)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="neutral_tpu_torch",
        description="Monte Carlo neutral-particle transport in PyTorch, "
                    "with CUDA sweep, flight and segment-deposit kernels")
    p.add_argument("params", help="problem deck (.params file)")
    p.add_argument("--dtype", default=None, choices=["float32", "float64"],
                   help="compute and tally dtype (default: float32)")
    p.add_argument("--nparticles", type=int, default=None,
                   help="override the deck's particle count")
    p.add_argument("--iterations", type=int, default=None,
                   help="override the deck's timestep count")
    p.add_argument("--mesh-scale", type=int, default=None,
                   help="divide nx/ny by this factor (quick runs)")
    p.add_argument("--engine", default="auto", choices=ENGINES,
                   help="kernel = the transport's CUDA kernels (float32 "
                        "and float64); plain = their plain PyTorch "
                        "versions; auto = kernel on CUDA where one exists, "
                        "else plain")
    p.add_argument("--transport", default="auto", choices=TRANSPORTS,
                   help="sweep = one event per step; flight = closed-form "
                        "flight pieces and segment deposits; auto = flight "
                        "when a float32 deck has a region of density below "
                        "1.0, else sweep")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; --device cpu runs "
                        "the plain versions on the CPU)")
    p.add_argument("--decomposition", default="replicated",
                   choices=DECOMPOSITIONS,
                   help="with more than one shard: replicated mesh with "
                        "particles split by pid, spatial y-slabs, or 2D "
                        "(x, y) blocks, both with particle migration")
    p.add_argument("--shards", type=int, default=None,
                   help="shards of a decomposed run (default: one per "
                        "visible card, torch.cuda.device_count(), or one "
                        "per process over several processes; 1 on the "
                        "CPU); shards take the cards in turn, so several "
                        "may share one (--device cuda:K puts them all on "
                        "card K).  Over several processes each takes its "
                        "block of shards onto its own cards: processes "
                        "that see the same cards split them in contiguous "
                        "blocks (4 processes on 4 cards: one each; 2 "
                        "processes: two each), a process that sees cards "
                        "of its own (CUDA_VISIBLE_DEVICES) takes them all, "
                        "more processes than cards share them in turn; "
                        "NCCL joins processes whose cards are their own, "
                        "gloo the rest")
    p.add_argument("--checkpoint", default=None, metavar="PATH.npz",
                   help="write an npz checkpoint after the final step")
    p.add_argument("--restore", default=None, metavar="PATH.npz",
                   help="resume from an npz checkpoint (of any layout, or "
                        "of neutral_tpu): the run starts at the step after "
                        "it")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace (CPU and CUDA "
                        "activity, Chrome format) of the run here, from "
                        "set-up on: the program's nt.* spans (set-up, "
                        "census, begin, sweep or flight rounds, each host "
                        "read of the card, the tally read) beside the "
                        "kernels, copies and sets")
    p.add_argument("--backend", default="torch", choices=["torch", "native"],
                   help="torch = this package (default); native = the "
                        "history-based C++/OpenMP engine on the host")
    p.add_argument("--distributed", action="store_true",
                   help="a run over several processes, its rendezvous from "
                        "the environment that torchrun sets (MASTER_ADDR, "
                        "MASTER_PORT, RANK, WORLD_SIZE); the counterpart of "
                        "the reference's MPI launch (main.c:62-64)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="explicit rendezvous address, where process 0 "
                        "listens (implies --distributed; requires "
                        "--num-processes and --process-id)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)
    if args.coordinator and (args.num_processes is None
                             or args.process_id is None):
        p.error("--coordinator requires --num-processes and --process-id")

    cfg = load_config(args.params)
    if args.nparticles:
        cfg = cfg.with_(nparticles=args.nparticles, expected_tally=None)
    if args.iterations:
        cfg = cfg.with_(niters=args.iterations, expected_tally=None)
    if args.mesh_scale:
        cfg = cfg.with_(nx=cfg.nx // args.mesh_scale,
                        ny=cfg.ny // args.mesh_scale, expected_tally=None)
    if args.dtype:
        cfg = cfg.with_(dtype=args.dtype, tally_dtype=args.dtype)
    if args.backend == "native":
        # The host engine has no checkpoint, trace or decomposition; reject
        # rather than ignore them.
        unsupported = {"--checkpoint": args.checkpoint,
                       "--restore": args.restore,
                       "--trace-dir": args.trace_dir,
                       "--shards": args.shards not in (None, 1),
                       "--decomposition": args.decomposition != "replicated",
                       "--distributed": args.distributed,
                       "--coordinator": args.coordinator,
                       "--num-processes": args.num_processes is not None,
                       "--process-id": args.process_id is not None}
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            p.error(f"--backend native does not support: {', '.join(bad)}")
        return run_native(cfg)
    device = torch.device(args.device)
    # Refuse an engine or transport the deck cannot take before touching
    # the device.
    pick_transport(cfg, args.transport)
    pick_engine(args.engine, device, getattr(torch, cfg.dtype), cfg)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"neutral_tpu_torch: --device {args.device}, but "
              "torch.cuda.is_available() is False; pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return 2

    from .parallel import distributed, shard_devices
    if args.distributed or args.coordinator:
        distributed.initialise_distributed(
            args.coordinator, args.num_processes, args.process_id,
            device=device)
    nprocs, main_process = distributed.world(), distributed.rank() == 0
    out = print if main_process else (lambda *a, **k: None)
    trace_dir = args.trace_dir
    # every global shard's device; this process drives its own block
    devices = shard_devices(args.shards or (nprocs if nprocs > 1 else None),
                            device)
    if nprocs > 1 and trace_dir:
        trace_dir = os.path.join(trace_dir, f"process{distributed.rank()}")
    name = (torch.cuda.get_device_name(devices[0])
            if device.type == "cuda" else "cpu")
    if nprocs > 1:
        out(f"Distributed: {nprocs} processes, {len(devices)} shards.")
        out(f"Process group: {distributed.backend()}, "
            + ("exchange on the cards." if distributed.backend() == "nccl"
               else "host-staged exchange."))
    out(f"Starting up on device {devices[0]} ({name}).")
    out(f"Loading problem from {args.params}.")
    with maybe_trace(trace_dir):
        sim = make_simulation(cfg, args.decomposition, devices,
                              engine=args.engine, transport=args.transport,
                              quiet=not main_process)
        out(f"Engine: {sim.engine}.")
        out(f"Transport: {sim.transport}.")
        out(f"Decomposition: {getattr(sim, 'layout', 'none (1 device)')}.")
        start = 1
        if args.restore:
            t0 = time.perf_counter()
            start = sim.restore(args.restore) + 1
            out(f"Restored checkpoint at step {start - 1} in "
                f"{time.perf_counter() - t0:.3f} s")
        sim.run(start)
    if args.checkpoint:
        t0 = time.perf_counter()
        sim.checkpoint(args.checkpoint, sim.last_step)
        out(f"Wrote checkpoint {args.checkpoint} at step {sim.last_step} "
            f"in {time.perf_counter() - t0:.3f} s")
    return 0


def run_native(cfg: SimConfig) -> int:
    """Run the deck on the native engine (native/) with the same per-step
    print and validation."""
    from . import native

    sim = native.NativeSimulation(cfg)
    print(f"Native engine with {native.load().nt_num_threads()} threads.")
    wallclock = elapsed = 0.0
    for tt in range(1, cfg.niters + 1):
        print(f"\nIteration  {tt}")
        t0 = time.perf_counter()
        nf, nc, nproc = sim.step(tt)
        step_time = time.perf_counter() - t0
        wallclock += step_time
        print(f"Handled {nproc} particles")
        print(f"Step time  {step_time:.4f}s")
        print(f"Wallclock  {wallclock:.4f}s")
        print(f"Facets     {nf}")
        print(f"Collisions {nc}")
        print(f"Facet Events / s {nf / step_time:.2e}")
        print(f"Collision Events / s {nc / step_time:.2e}")
        elapsed += cfg.dt
        if elapsed >= cfg.sim_end:
            print("Reached end of simulation time")
            break
    total = float(sim.tally.sum())
    print(f"Final global_energy_tally {total:.15e}")
    print(validation_line(cfg.expected_tally, total))
    print(f"Final Wallclock {wallclock:.9f}s")
    print(f"Elapsed Simulation Time {elapsed:.6f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
