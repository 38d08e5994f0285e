"""The census loop: one shard set-up, one loop of passes, one tally read.

`driver.Simulation` holds one shard over the whole mesh, a decomposition
(parallel/) one shard a block of the mesh or a range of pids; each shard
(`Shard`, made by `new_shard` and nowhere else) holds its particles,
tally, geometry, window, cross-sections and, on the kernel engine, the
sweep or flight loop's buffers.  A census over the shards
(`driver.SimulationBase.step`):

1. `begin`: the census start on every shard, then one read of every
   shard's [live lanes, lanes];
2. `passes` until no shard has work.  A pass is one chunk on every shard
   with work (a `sweep_kernel.sweep_round` launch, a `flight_kernel.
   flight_round`, or on the plain engine the plain census in the shard's
   window), then one read of every shard's counters (facets and
   collisions so far, lanes still working and, after a flight round, the
   segment rows reserved, the deposit's pieces and its overflow flag),
   each flight shard's `flight_kernel.after_round` and the caller's
   migration, if any.  A shard's launch parameters are built once a
   census, and again only when migration replaced its state.  The last
   pass's read gives the census's facets and collisions.

`sweep_chunk_kernel` and `flight_chunk_kernel` are the loop over one
state.  Their `.launches` and `.cards` count the kernel's launches from
every caller (in total, by card index), `flight_chunk_kernel.refusals`
the rounds that refused segment rows; callers may reset them.
`passes` fills the counts of the step's `StepMetrics`; `read_tallies`
reads a process's tallies to the host.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from .begin_kernel import begin_census
from .flight import flight_chunk_plain
from .flight_kernel import (FlightBuffers, after_round, event_phases,
                            flight_params, flight_round)
from .inject_kernel import inject_particles_kernel
from .particles import ParticleState, inject_particles
from .profiler import TALLY_READS, Spans, span
from .sweep_kernel import (MAX_EVENTS, SweepBuffers, kernel_rects,
                           sweep_chunk_plain, sweep_params, sweep_round)
from .transport import Geometry


@dataclass
class Shard:
    """One shard on `device`.  `geom` has its extent (the whole mesh, or
    a window's block with a grid deck's density block) and `x_off`/
    `y_off` place the window (None: none on that axis); `tables` are the
    cross-sections; `buffers` the kernel loop's (FlightBuffers or
    SweepBuffers; None on the plain engine); `dest` each lane's
    destination shard (spatial modes)."""
    device: torch.device
    geom: Geometry
    state: ParticleState
    tally: torch.Tensor
    tables: tuple
    x_off: int | None = None
    y_off: int | None = None
    buffers: FlightBuffers | SweepBuffers | None = None
    dest: torch.Tensor | None = None


def to_device(obj, device):
    """Dataclass `obj` with every tensor field on `device` (itself when
    they all are there already)."""
    moved = {f.name: getattr(obj, f.name).to(device)
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)
             and getattr(obj, f.name).device != device}
    return dataclasses.replace(obj, **moved) if moved else obj


def new_shard(sim, device, geom: Geometry, pid: torch.Tensor | None = None,
              x_off=None, y_off=None) -> Shard:
    """A shard of `sim` (a driver.SimulationBase) on `device` over `geom`,
    holding the injected particles `pid` (None: 0..n-1): one launch of the
    inject kernel on the kernel engine, particles.inject_particles on the
    plain one."""
    cfg = sim.cfg
    kernel = sim.engine == "kernel"
    inject = inject_particles_kernel if kernel else inject_particles
    with span("setup.inject"):
        state = inject(
            to_device(sim.mesh, device),
            nparticles=cfg.nparticles if pid is None else pid.numel(),
            pid=None if pid is None else pid.to(device),
            initial_energy=cfg.initial_energy, dt=cfg.dt, dtype=sim.dtype,
            device=device, **sim.source())
    with span("setup.buffers"):
        geom = to_device(geom, device)
        tally = torch.zeros(geom.nx * geom.ny,
                            dtype=getattr(torch, cfg.tally_dtype),
                            device=device)
        sh = Shard(device, geom, state, tally,
                   (to_device(sim.cs_scatter, device),
                    to_device(sim.cs_absorb, device)), x_off, y_off)
        if kernel:
            sh.buffers = (FlightBuffers(geom.nx, geom.ny, device,
                                        dtype=sim.dtype,
                                        tally_dtype=tally.dtype)
                          if sim.transport == "flight"
                          else SweepBuffers(device))
    return sh


def read_counters(rows: list[torch.Tensor], host) -> np.ndarray:
    """This process's counters as one (k, len + m) int64 host array: its
    rows (1-d int64 tensors of one length, one a shard, on any devices),
    each read once, beside its (k, m) `host` columns."""
    return np.concatenate(
        [np.stack([r.cpu().numpy() for r in rows]),
         np.asarray(host, dtype=np.int64).reshape(len(rows), -1)], 1)


def read_tallies(tallies: list[torch.Tensor]) -> list[np.ndarray]:
    """The flat tallies as float64 host arrays, copies that a later step
    leaves as they are.  On a card each is converted to float64 there
    (exact) and all are copied into one page-locked block of torch's
    caching host allocator, which the arrays hold until all are dropped;
    then it goes back to the cache for the next read."""
    on_card = tallies[0].device.type == "cuda"
    sizes = [t.numel() for t in tallies]
    with span("tally_read"):
        with span("tally_read.convert"):
            wide = [t.to(torch.float64) if on_card else t for t in tallies]
        with span("tally_read.copy"):
            host = torch.empty(sum(sizes), dtype=torch.float64,
                               pin_memory=on_card)
            for part, t in zip(host.split(sizes), wide):
                part.copy_(t)
        TALLY_READS.add(host.data_ptr() if on_card else None)
        return [part.numpy() for part in host.split(sizes)]


def begin(shards: list[Shard], engine: str, dt: float, master_key: int,
          spans: Spans | None = None, read=read_counters) -> np.ndarray:
    """The census start on every shard, in the span nt.begin, then one
    read of every global shard's [live lanes, lanes] (nt.begin.read)."""
    with span("begin", spans):
        rows = []
        for sh in shards:
            sh.state, live = begin_census(engine, sh.state, sh.geom,
                                          sh.tables[0], dt, master_key,
                                          sh.x_off, sh.y_off)
            rows.append(live)
        with span("begin.read", spans):
            return read(rows, [[sh.state.n] for sh in shards])


@dataclass
class StepMetrics:
    """A census step's metrics, global over every process's shards:
    `passes` fills the counts, driver.SimulationBase.step the rest."""
    step: int = 0
    step_time: float = 0.0
    nfacets: int = 0
    ncollisions: int = 0
    nprocessed: int = 0
    # plain engine: sweeps run (events or pieces); flight kernel: flight
    # pieces granted per lane over the step's launches (a decomposed run:
    # the most any shard granted in each round, summed)
    nsweeps: int = 0
    nlaunches: int = 0    # kernel engine: sweep or flight kernel launches
    # Split of the step, in seconds: "begin" (the census start,
    # begin_kernel.begin_census: the begin kernel or, on the plain engine,
    # transport.begin_timestep; up to the host read of the live count;
    # wall clock), then for the sweep transport
    # "sweep" (the census; wall clock), for the flight transport "flight"
    # and "raster" (the pieces and the segment deposits: device time from
    # CUDA events with the kernel engine, wall clock with the plain one)
    # and "loop" (the rest of the census's wall time: the host loop); the
    # kernel engine's flight transport adds, from the same events,
    # "raster_bins" and "raster_tiles" (the deposits' two stages, which
    # add up to "raster") and "raster_overflow" (of "raster", the
    # deposit launches whose piece buffer overflowed and which deposited
    # nothing before their re-run; flight_kernel.event_phases); a
    # spatial decomposition adds "migrate" (wall clock), and over several
    # processes "exchange", its part from packing the lanes bound for
    # other processes to unpacking theirs (wall clock, waits included).
    # The wall-clock phases are read from the step's spans
    # (profiler.span): "begin" is nt.begin's wall time, "sweep" nt.sweep's
    # less "migrate", and "migrate" nt.migrate's; "loop" is nt.census's
    # less nt.begin's, "flight", "raster" and "migrate" (SimulationBase.
    # step builds them for every layout).
    phases: dict = field(default_factory=dict)
    nmigrated: int = 0    # lanes moved between shards (spatial runs)
    nexchanged: int = 0   # of those, lanes moved between processes
    # flight kernel: one record per launch (flight_kernel.launch_records):
    # its shard, lanes launched, pieces per lane, lanes still working after
    # it, segment rows written, whether rows were refused, the deposit's
    # pieces ("deposit_pieces"), whether it overflowed, device ms
    rounds: list = field(default_factory=list)
    # host reads in the census that waited for the card: its `*.read`
    # spans (the live counts, each pass's counters, whose last holds the
    # event counts); printed as the step's "Host waits" line
    nwaits: int = 0

    @property
    def noverflows(self) -> int:
        """Segment deposits re-run after their piece buffer overflowed (the
        rounds' "overflow"); printed on the "Host waits" line of the
        flight kernel's steps."""
        return sum(r["overflow"] for r in self.rounds)


def passes(shards: list[Shard], master_key: int, inv_ntotal: float,
           work: np.ndarray, *, transport: str, engine: str = "kernel",
           spans: Spans | None = None, read=read_counters,
           local: range | None = None, migration=None,
           max_events: int = MAX_EVENTS, max_pieces: int | None = None,
           segments: list | None = None) -> StepMetrics:
    """The census after `begin`: passes until no shard has work.

    `work[s]`: global shard s starts with lanes; `local`: the global
    indices of `shards` (None: 0..k-1); `read` reads every global shard's
    counters.  `migration` (spatial modes) gives a shard's departures
    (`departures(shard)`, read with the counters) and moves them after
    the read (`migrate(columns, spans)`: the lanes each global shard
    received, the lanes moved, those that crossed between processes), in
    the span nt.migrate.  `max_events`, `max_pieces` and `segments` go to
    each launch.  Spans: nt.sweep.read a pass, or nt.flight.round a pass
    holding nt.flight.read and nt.flight.host (after_round)."""
    local = range(len(shards)) if local is None else local
    flight, kernel = transport == "flight", engine == "kernel"
    nctrl = 6 if flight and kernel else 3
    counter = flight_chunk_kernel if flight else sweep_chunk_kernel
    out, marks = StepMetrics(), []
    plain = [[0, 0] for _ in shards]      # plain facets, collisions so far
    params, built = [None] * len(shards), [None] * len(shards)
    walls = {"flight": 0.0, "raster": 0.0}
    for sh in shards:
        if sh.buffers is not None:
            sh.buffers.start_census()
    ctrl = None
    while work.any():
        with (span("flight.round", spans) if flight
              else contextlib.nullcontext()):
            rows, host, recs = [], [], {}
            for i, (s, sh) in enumerate(zip(local, shards)):
                sweeps = 0
                if work[s] and not kernel:
                    sh.state, f, c, sweeps, *t = (
                        flight_chunk_plain if flight else sweep_chunk_plain)(
                        sh.state, sh.tally, sh.geom, *sh.tables, master_key,
                        inv_ntotal, x_off=sh.x_off, y_off=sh.y_off)
                    for k in walls if flight else ():
                        walls[k] += t[0][k]
                    plain[i] = [plain[i][0] + f, plain[i][1] + c]
                elif work[s]:
                    if built[i] is not sh.state:   # new census or migrated
                        make = flight_params if flight else sweep_params
                        params[i] = make(
                            sh.state, sh.tally, kernel_rects(
                                sh.geom.rects if flight else sh.geom.regions,
                                sh.device, sh.state.dtype),
                            sh.geom, *sh.tables, master_key, inv_ntotal,
                            sh.x_off, sh.y_off)
                        built[i] = sh.state
                    if flight:
                        recs[i] = rec = {"shard": s} | flight_round(
                            params[i], sh.buffers, sh.tally, sh.geom,
                            max_pieces, segments)
                        marks.append(rec["marks"])
                        sweeps, launched = rec["pieces"], True
                    else:
                        launched = sweep_round(params[i], sh.buffers,
                                               max_events)
                    if launched:
                        counter.launches += 1
                        counter.cards[sh.device.index] += 1
                row = (sh.buffers.counts[:nctrl] if kernel else
                       torch.tensor([*plain[i], 0], device=sh.device))
                if migration is not None:
                    row = torch.cat([row, migration.departures(sh)])
                rows.append(row)
                host.append([int(bool(work[s]) and kernel), sweeps])
            # One read of every global shard's counters and [launched,
            # sweeps]: it waits for every launch of the pass.
            with span("flight.read" if flight else "sweep.read", spans):
                ctrl = read(rows, host)
            if recs:
                with span("flight.host", spans):
                    for i, rec in recs.items():
                        sh = shards[i]
                        after_round(sh.buffers, sh.tally, sh.geom, rec,
                                    ctrl[local[i], 2:6], marks)
                        flight_chunk_kernel.refusals += rec["refused"]
                        out.rounds.append(rec)
            for s, sh in zip(local, shards):
                if work[s] and kernel:       # the next launch's list
                    sh.buffers.n_active = int(ctrl[s, 2])
            received = 0
            if migration is not None:
                with span("migrate", spans):
                    received, moved, crossed = migration.migrate(
                        ctrl[:, nctrl:-2], spans)
                out.nmigrated += moved
                out.nexchanged += crossed
                # a shard that received lanes covers all of them next
                for s, sh in zip(local, shards):
                    if received[s] and kernel:
                        sh.buffers.n_active = None
        out.nlaunches += int(ctrl[:, -2].sum())
        out.nsweeps += int(ctrl[:, -1].max())
        work = (ctrl[:, 2] > 0) | (received > 0)
    if ctrl is not None:
        out.nfacets, out.ncollisions = (int(v) for v in ctrl[:, :2].sum(0))
    if flight:
        out.phases = event_phases(marks) if kernel else walls
    return out


def sweep_chunk_kernel(state: ParticleState, tally: torch.Tensor,
                       geom: Geometry, scatter_tab, absorb_tab,
                       master_key: int, inv_ntotal: float,
                       max_events: int = MAX_EVENTS, x_off=None, y_off=None,
                       buffers: SweepBuffers | None = None,
                       spans: Spans | None = None):
    """Run every lane to census or death (or, under the window `x_off`/
    `y_off`, until it leaves it) with the CUDA sweep kernel, updating
    `state`'s tensors and `tally` in place.  `buffers` are kept between
    calls (None: new ones); the reads' spans go to `spans`.  Returns
    (state, nfacets, ncollisions, nlaunches)."""
    sh = Shard(state.device, geom, state, tally, (scatter_tab, absorb_tab),
               x_off, y_off, SweepBuffers(state.device) if buffers is None
               else buffers)
    out = passes([sh], master_key, inv_ntotal, np.array([state.n > 0]),
                 transport="sweep", spans=spans, max_events=max_events)
    return sh.state, out.nfacets, out.ncollisions, out.nlaunches


sweep_chunk_kernel.launches = 0
sweep_chunk_kernel.cards = collections.Counter()   # launches by card index


def flight_chunk_kernel(state: ParticleState, tally: torch.Tensor,
                        geom: Geometry, scatter_tab, absorb_tab,
                        master_key: int, inv_ntotal: float,
                        max_pieces: int | None = None,
                        segments: list | None = None, x_off=None,
                        y_off=None, buffers: FlightBuffers | None = None,
                        rounds: list | None = None,
                        spans: Spans | None = None):
    """sweep_chunk_kernel's census with the CUDA flight kernel in rounds.
    `max_pieces` fixes every launch's pieces per lane (None: flight_kernel.
    pieces_for); each round's segment rows are appended to the list
    `segments`, and its record (with its shard, 0) to `rounds`.  Returns
    (state, nfacets, ncollisions, nlaunches, phases), `phases` event_phases'
    device seconds."""
    if buffers is None:
        buffers = FlightBuffers(geom.nx, geom.ny, state.device,
                                dtype=state.dtype, tally_dtype=tally.dtype)
    sh = Shard(state.device, geom, state, tally, (scatter_tab, absorb_tab),
               x_off, y_off, buffers)
    out = passes([sh], master_key, inv_ntotal, np.array([state.n > 0]),
                 transport="flight", spans=spans, max_pieces=max_pieces,
                 segments=segments)
    if rounds is not None:
        rounds.extend(out.rounds)
    return sh.state, out.nfacets, out.ncollisions, out.nlaunches, out.phases


flight_chunk_kernel.launches = 0
flight_chunk_kernel.cards = collections.Counter()  # launches by card index
flight_chunk_kernel.refusals = 0
