"""The decomposed runs' shared machinery: shards, one loop, one read.

Port of `neutral_tpu/parallel/`.  A run is split into shards, each with
its own device (several shards may share one card), its own particles and
its own tally.  The JAX package built each decomposition from `shard_map`
programs with collectives; here one Python loop drives every shard of a
process (`DecomposedSimulation.step`), and a run over several processes
(distributed.py) splits the global shards into contiguous blocks, one per
process, each driven by the same loop.  A step starts every shard's
census (`begin_kernel.begin_census`: one begin kernel launch a shard with
the kernel engine) and reads all shards' live counts at once; then:

1. every shard with work runs one chunk: one kernel launch over the
   shard's list of working lanes (the sweep kernel, bounded by
   `MAX_EVENTS` per lane, or a flight round: flight kernel and segment
   deposit, with its own pieces per lane, `flight_kernel.pieces_for`);
   with the plain engine, the plain version until no lane in its window
   has work;
2. one host read of every shard's counters at once
   (`distributed.gather_counters`): facets, collisions, lanes still
   working, the segment rows reserved, the segment deposit's piece count
   and overflow flag and, in the spatial modes, how many lanes leave for
   each other shard and how many slots are free; with several processes
   the same call gathers those rows from every process (on the card under
   NCCL, then one read), so that every process holds the same global
   counters, from which all of them take the same decisions (which shard
   works next, what moves where), and so make the same collective calls;
   then each flight shard's host part of the round
   (`flight_kernel.after_round`: a re-run of an overflowed deposit, the
   growth of a segment buffer that refused rows, the next list's length)
   and each sweep shard's next list length, which need no read;
3. migration (spatial modes): each lane that left its shard's window goes
   straight to its owner shard, into a dead slot, and the owner's tensors
   grow when dead slots run out.  The counts of step 2 size every gather,
   so migration itself waits for nothing.  A shard that received lanes
   covers all of its lanes in its next launch, which rebuilds its list.
   Lanes bound for another process's shard are packed into one buffer
   per pair of processes and swapped by one all-to-all (`exchange`: card
   to card under NCCL, staged on the host under gloo), sized from the
   gathered counters; arrivals land in source-shard order, so every shard
   holds bitwise the lanes of the single-process run with the same
   shards.

The shards of one process may lie on several cards (one process driving
four cards, or two cards in each of two processes): every launch runs
under its card's device guard on that card's current stream, the loop
launches every shard's chunk before its one read, so the cards work at
the same time, and the step's clock waits for every card of the process
(`Profile`).  Lanes move between cards of one process by device-to-device
copies, always in the order of the host's decisions.

No shard is waited for on its own.  Histories are keyed by pid, so the
decomposition changes nothing physical: a replicated run equals the
single-device run history by history, a spatial sweep run too, and a
spatial flight run equals a single-device run over
`flight.split_rects` (the window's walls act as rect walls).  No particle
is lost or duplicated, and every live lane sits on its owner shard when a
step ends.

A checkpoint holds one lane per particle in pid order whatever the layout
(particles.merge_states), and a restore puts each live lane of any
checkpoint on its owner shard (`restore_owner`, the counterpart of JAX's
`_partition_by_owner`) and each shard's part of the tally in place: a
checkpoint of one layout restores into any other.  With several processes
the states and tallies are gathered to every process (as JAX's
`process_allgather` does), and process 0 alone writes files.

JAX's flight_sharded.py has no module of its own here: its decomposed
flight step is the flight branch of the same loop, whose lists of working
lanes do the work of JAX's flight compaction.  Not ported, as TPU
mechanisms: the u32-pair control vector (one int64 read replaces it), the
pending-flush rings, the sweep transport's compaction ladder, and the
fixed `cap_xfer` budgets of the neighbour-only `ppermute` exchange with
its overflow, repartition and abort path (growth replaces them).
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..begin_kernel import begin_census
from ..driver import SimulationBase, StepMetrics, check_device
from ..flight import flight_chunk_plain
from ..flight_kernel import (FlightBuffers, after_round, event_phases,
                             flight_params, flight_round, launch_records)
from ..particles import STATE_FIELDS, ParticleState, state_from_numpy
from ..profiler import Spans, span
from ..sweep_kernel import (MAX_EVENTS, SweepBuffers, rect_arrays,
                            sweep_chunk_plain, sweep_params, sweep_round)
from ..transport import Geometry, window_cells
from . import distributed
from .distributed import (all_gather_arrays, exchange, gather_counters,
                          local_shards, process_of, rank, world)


def shard_devices(n: int | None = None, device="cuda") -> list:
    """The devices of `n` global shards on `device`'s type (the
    counterpart of `make_device_mesh`): the visible cards in turn for
    "cuda", so that several shards may share one card, the named device
    alone for an indexed one ("cuda:1"), and the CPU for "cpu".  `n`
    None: one shard per visible card (torch.cuda.device_count()), or 1 on
    the CPU.  In a run over several processes on CUDA, each process's
    block of shards takes that process's cards in turn
    (`distributed.shard_devices`; `n` None: one shard per process)."""
    device = torch.device(device)
    if device.type == "cuda" and distributed.world() > 1:
        return distributed.shard_devices(n or distributed.world())
    if device.type == "cuda" and device.index is None:
        check_device(device)
        ncards = torch.cuda.device_count()
        return [torch.device("cuda", i % ncards) for i in range(n or ncards)]
    return [check_device(device)] * (n or 1)


def to_device(obj, device):
    """Dataclass `obj` with every tensor field on `device` (itself when
    they all are there already)."""
    moved = {f.name: getattr(obj, f.name).to(device)
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)
             and getattr(obj, f.name).device != device}
    return dataclasses.replace(obj, **moved) if moved else obj


def first_true(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first `k` True lanes of `mask`, in order, where the
    caller knows that there are at least `k` (no host read)."""
    pos = torch.cumsum(mask, 0) - 1
    keep = mask & (pos < k)
    out = torch.empty(k + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, torch.where(keep, pos, k),
                 torch.arange(mask.shape[0], device=mask.device))
    return out[:k]


def grow(state: ParticleState, n: int) -> ParticleState:
    """`state` with n >= state.n lanes: its own first, dead ones after."""
    out = {}
    for f in STATE_FIELDS:
        old = getattr(state, f)
        new = torch.zeros(n, dtype=old.dtype, device=old.device)
        new[:old.shape[0]] = old
        out[f] = new
    out["dead"][state.n:] = True
    return ParticleState(**out)


def packed_bytes(like: ParticleState, k: int) -> int:
    """The bytes of `k` lanes in pack_lanes' buffer (fields as in `like`)."""
    return sum(-(-k * getattr(like, f).dtype.itemsize // 8) * 8
               for f in STATE_FIELDS)


def pack_lanes(blocks: list, device) -> torch.Tensor:
    """Blocks of lanes (each the STATE_FIELDS tensors of some lanes, on any
    devices) as one uint8 buffer on `device`: each field's values over all
    the blocks in turn, as bytes, padded to 8 bytes so that every field
    starts aligned."""
    parts = []
    for i in range(len(STATE_FIELDS)):
        b = torch.cat([blk[i].to(device) for blk in blocks]).view(torch.uint8)
        parts += [b, b.new_zeros(-b.numel() % 8)]
    return torch.cat(parts)


def unpack_lanes(buf: torch.Tensor, counts: list, like: ParticleState
                 ) -> list:
    """The blocks of counts[i] lanes that pack_lanes packed into `buf` (on
    any device), each a list of STATE_FIELDS tensors with `like`'s
    dtypes."""
    k, off, fields = sum(counts), 0, []
    for f in STATE_FIELDS:
        dtype = getattr(like, f).dtype
        nbytes = k * dtype.itemsize
        fields.append(torch.split(buf[off:off + nbytes].view(dtype), counts))
        off += nbytes + (-nbytes % 8)
    return [list(blk) for blk in zip(*fields)]


@dataclass
class Shard:
    """One shard: its device, particles, tally and geometry.

    `geom` has the shard's extent (the whole mesh in the replicated mode,
    the window's block in the spatial ones, with a grid deck's density
    block) and `x_off`/`y_off` place the window (None: no window on that
    axis).  `tables` are the cross-sections on `device`.  The kernel
    engine keeps its counters and region or rect arrays here, and the
    sweep or flight loop's buffers (whose counters `counts` is); the
    spatial modes keep each lane's destination shard."""
    device: torch.device
    geom: Geometry
    state: ParticleState
    tally: torch.Tensor
    tables: tuple
    x_off: int | None = None
    y_off: int | None = None
    counts: torch.Tensor | None = None
    rects: tuple | None = None
    flight: FlightBuffers | None = None
    sweep: SweepBuffers | None = None
    dest: torch.Tensor | None = None


class DecomposedSimulation(SimulationBase):
    """A run over shards on `devices` (default: one per visible card).

    `devices` has one entry per global shard.  In a run over several
    processes (distributed.initialise_distributed) each process builds and
    drives only its own block of shards (`local`, global indices), on its
    entries of `devices`; the shard count must split evenly over the
    processes.  Subclasses build those shards (`make_shards`) and assemble
    the tally (`host_tally`, from `shard_tallies`); the spatial ones set
    `migrates` and name each cell's owner shard (`owner`)."""

    decomposition = ""
    migrates = False

    def __init__(self, cfg, *, devices=None, engine: str = "auto",
                 transport: str = "auto", quiet: bool = False):
        devices = (shard_devices() if devices is None
                   else [torch.device(d) for d in devices])
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"shards on devices of one type only: {devices}")
        self.local = local_shards(len(devices))
        self.world = world()
        super().__init__(cfg, device=devices[self.local.start], engine=engine,
                         transport=transport, quiet=quiet)
        mine = devices[self.local.start:self.local.stop]
        for d in mine:
            check_device(d)
        # a step's clock waits for every card of this process's shards
        self.profile.devices = sorted(set(mine), key=str)
        self.devices = devices
        self.nshards = len(devices)
        # the rank of the process that owns each global shard, and the
        # pairs of shards that lie in different processes
        self.process = np.array([process_of(s, self.nshards)
                                 for s in range(self.nshards)])
        self.crossing = self.process[:, None] != self.process[None, :]
        # A chunk's counters: [facets, collisions, lanes still working], and
        # with the flight kernel its three more (segment rows reserved, the
        # deposit's pieces, its overflow flag); the spatial modes append
        # departures per shard and dead lanes when they read them.
        self.deposits = self.engine == "kernel" and self.transport == "flight"
        self.nctrl = 6 if self.deposits else 3
        self.shards = self.make_shards()
        # each shard's device in shard order, or the one they all share
        names = [str(d) for d in devices]
        on = names[0] if len(set(names)) == 1 else ", ".join(names)
        self.layout = (f"{self.decomposition}, {self.nshards} shards on "
                       f"{on}{self.grid_note()}")
        with span("setup.wait"):          # set-up, not step 1's time
            for d in {sh.device for sh in self.shards
                      if sh.device.type == "cuda"}:
                torch.cuda.synchronize(d)

    # -- hooks ------------------------------------------------------------
    def make_shards(self) -> list:
        raise NotImplementedError

    def grid_note(self) -> str:
        return ""

    def owner(self, cellx: torch.Tensor, celly: torch.Tensor) -> torch.Tensor:
        """The int64 owner shard of each cell (spatial modes)."""
        raise NotImplementedError

    def restore_owner(self, fields: dict) -> np.ndarray:
        """The shard that takes each lane of a checkpoint's field dict."""
        return self.owner(torch.from_numpy(fields["cellx"]),
                          torch.from_numpy(fields["celly"])).numpy()

    def tally_part(self, tally: np.ndarray, s: int) -> np.ndarray:
        """Shard s's part of a flat global tally."""
        raise NotImplementedError

    # -- gathers and checkpoints -----------------------------------------------
    def shard_tallies(self) -> list[np.ndarray]:
        """Every global shard's tally as a host array, in shard order
        (gathered from every process: a collective)."""
        return all_gather_arrays([sh.tally for sh in self.shards])

    def states(self) -> list[ParticleState]:
        """Every global shard's particles: with several processes gathered
        to the host of every process (a collective)."""
        if self.world == 1:
            return [sh.state for sh in self.shards]
        arrays = all_gather_arrays([getattr(sh.state, f)
                                    for sh in self.shards
                                    for f in STATE_FIELDS])
        k = len(STATE_FIELDS)
        return [ParticleState(**{f: torch.from_numpy(a) for f, a in
                                 zip(STATE_FIELDS, arrays[i:i + k])})
                for i in range(0, len(arrays), k)]

    def set_state(self, fields: dict, tally: np.ndarray) -> None:
        """Each live lane of `fields` onto its owner shard (restore_owner),
        each shard's part of `tally` onto its tally (this process's shards
        only)."""
        owner = self.restore_owner(fields)
        live = ~np.asarray(fields["dead"], dtype=bool)
        for s, sh in zip(self.local, self.shards):
            sel = np.flatnonzero((owner == s) & live)
            sh.state = state_from_numpy({f: np.asarray(fields[f])[sel]
                                         for f in STATE_FIELDS},
                                        sh.device, self.dtype)
            sh.tally = torch.as_tensor(self.tally_part(tally, s),
                                       device=sh.device).to(sh.tally.dtype)

    # -- set-up helpers ---------------------------------------------------
    def new_shard(self, device, geom: Geometry, pid: torch.Tensor,
                  x_off=None, y_off=None) -> Shard:
        """A shard on `device` holding the injected particles `pid`."""
        from ..particles import inject_fields
        cfg = self.cfg
        with span("setup.inject"):
            state = inject_fields(
                to_device(self.mesh, device), pid.to(device),
                torch.ones(pid.shape, dtype=torch.bool, device=device),
                initial_energy=cfg.initial_energy, dt=cfg.dt,
                dtype=self.dtype, **self.source())
        geom = to_device(geom, device)
        tally = torch.zeros(geom.nx * geom.ny,
                            dtype=getattr(torch, cfg.tally_dtype),
                            device=device)
        tables = (to_device(self.cs_scatter, device),
                  to_device(self.cs_absorb, device))
        sh = Shard(device, geom, state, tally, tables, x_off, y_off)
        if self.engine == "kernel":
            rects = geom.rects if self.deposits else geom.regions
            sh.rects = (None if rects is None
                        else rect_arrays(rects, device, self.dtype))
            if self.deposits:
                sh.flight = FlightBuffers(geom.nx, geom.ny, device,
                                          dtype=self.dtype,
                                          tally_dtype=tally.dtype)
                sh.counts = sh.flight.counts
            else:
                sh.sweep = SweepBuffers(device)
                sh.counts = sh.sweep.counts
        return sh

    # -- the step -----------------------------------------------------------
    def step(self, tt: int) -> StepMetrics:
        """Advance one census timestep on every shard (master_key = tt).
        Every count it returns is global: over every process's shards.
        Its spans are Simulation.step's: nt.census, nt.begin with
        nt.begin.read, then nt.sweep around the loop (sweep transport) or
        one nt.flight.round a pass of the loop (flight transport), each
        pass's read (nt.sweep.read, nt.flight.read), the flight shards'
        after_round (nt.flight.host), and nt.migrate and nt.exchange."""
        cfg = self.cfg
        flight = self.transport == "flight"
        self.profile.start()
        spans = Spans()
        with span("census", spans):
            with span("begin", spans):
                rows = []
                for sh in self.shards:
                    sh.state, live = begin_census(self.engine, sh.state,
                                                  sh.geom, sh.tables[0],
                                                  cfg.dt, tt, sh.x_off,
                                                  sh.y_off)
                    rows.append(live)
                    if sh.flight is not None:
                        sh.flight.start_census()
                    if sh.sweep is not None:
                        sh.sweep.start_census()
                # Every global shard's [live lanes, lanes]: one read, one
                # gather.
                with span("begin.read", spans):
                    begun = gather_counters(rows, [[sh.state.n]
                                                   for sh in self.shards])
                nprocessed = int(begun[:, 0].sum())
            # The sweep phase runs from here to the clock's stop.
            with contextlib.nullcontext() if flight else span("sweep",
                                                              spans):
                n = self.nshards
                work = begun[:, 1] > 0
                nf = nc = nsweeps = nlaunches = nmigrated = nexchanged = 0
                marks, parts = [], {"flight": 0.0, "raster": 0.0}
                rounds = []
                while work.any():
                    with (span("flight.round", spans) if flight
                          else contextlib.nullcontext()):
                        ctrl, received = self._pass(tt, work, marks, parts,
                                                    rounds, spans)
                    nf += int(ctrl[:, 0].sum())
                    nc += int(ctrl[:, 1].sum())
                    nlaunches += int(ctrl[:, -2].sum())
                    nsweeps += int(ctrl[:, -1].max())
                    if self.migrates:
                        sends = ctrl[:, self.nctrl:self.nctrl + n]
                        nmigrated += int(sends.sum())
                        nexchanged += int(sends[self.crossing].sum())
                    work = (ctrl[:, 2] > 0) | (received > 0)
                step_time = self.profile.stop(f"step{tt}")
        wall = spans.seconds
        t_migrate = wall.get("migrate", 0.0)
        phases = {"begin": wall["begin"]}
        if flight:
            if self.engine == "kernel":
                parts = event_phases(marks)
            phases.update(parts)
            phases["loop"] = (wall["census"] - wall["begin"]
                              - parts["flight"] - parts["raster"]
                              - t_migrate)
        else:
            phases["sweep"] = wall["sweep"] - t_migrate
        if self.migrates:
            phases["migrate"] = t_migrate
            if self.world > 1:
                phases["exchange"] = wall.get("exchange", 0.0)
        m = StepMetrics(step=tt, step_time=step_time, nfacets=nf,
                        ncollisions=nc, nprocessed=nprocessed,
                        nsweeps=nsweeps, nlaunches=nlaunches, phases=phases,
                        nmigrated=nmigrated, nexchanged=nexchanged,
                        rounds=launch_records(rounds), nwaits=spans.waits())
        self.step_metrics.append(m)
        return m

    def _pass(self, tt: int, work: np.ndarray, marks: list, parts: dict,
              rounds: list, spans: Spans) -> tuple:
        """One pass of the step's loop: a chunk on every shard with work,
        the one read of every shard's counters, the flight shards' host
        part of the round and, in the spatial modes, migration.  Returns
        (every global shard's counters as read, the lanes each global
        shard received)."""
        n = self.nshards
        rows, host, chunk = [], [], {}
        for s, sh in zip(self.local, self.shards):
            w = bool(work[s])
            ctrl, sweeps = (self._chunk(sh, tt, marks, parts) if w
                            else (torch.zeros(self.nctrl, dtype=torch.int64,
                                              device=sh.device), 0))
            if w and self.deposits:
                chunk[s] = {"shard": s} | sweeps
                sweeps = sweeps["pieces"]
            host.append([int(w and self.engine == "kernel"), sweeps])
            rows.append(torch.cat([ctrl, self._departures(sh)])
                        if self.migrates else ctrl)
        # Every global shard's counters, then [launched, sweeps]: one read
        # and one gather for the chunk.
        read = "flight.read" if self.transport == "flight" else "sweep.read"
        with span(read, spans):
            ctrl = gather_counters(rows, host)
        if chunk:
            with span("flight.host", spans):
                for s, rec in chunk.items():
                    sh = self.shards[s - self.local.start]
                    after_round(sh.flight, sh.tally, sh.geom, rec,
                                ctrl[s, 2:6], marks)
                    rounds.append(rec)
        for s, sh in zip(self.local, self.shards):
            if work[s] and sh.sweep is not None:
                sh.sweep.n_active = int(ctrl[s, 2])
        received = np.zeros(n, dtype=np.int64)
        if self.migrates:
            with span("migrate", spans):
                sends = ctrl[:, self.nctrl:self.nctrl + n]
                self._migrate(sends, ctrl[:, self.nctrl + n], spans)
                received = sends.sum(axis=0)
                for s, sh in zip(self.local, self.shards):
                    for b in (sh.flight, sh.sweep):
                        if received[s] and b is not None:
                            b.n_active = None
        return ctrl, received

    def _chunk(self, sh: Shard, tt: int, marks: list, parts: dict):
        """One chunk on shard `sh`: (its nctrl counters as an int64
        tensor on its device, sweeps run), or with the flight kernel
        (the counters, the round's record; flight_round's)."""
        scatter, absorb = sh.tables
        args = (sh.state, sh.tally, sh.geom, scatter, absorb, tt,
                1.0 / self.cfg.nparticles)
        win = dict(x_off=sh.x_off, y_off=sh.y_off)
        if self.engine == "plain":
            if self.transport == "flight":
                sh.state, f, c, sweeps, t = flight_chunk_plain(*args, **win)
                parts["flight"] += t["flight"]
                parts["raster"] += t["raster"]
            else:
                sh.state, f, c, sweeps = sweep_chunk_plain(*args, **win)
            return torch.tensor([f, c, 0], device=sh.device), sweeps
        sh.counts.zero_()
        if self.transport == "flight":
            params = flight_params(sh.state, sh.tally, sh.rects, *args[2:],
                                   **win)
            rec = flight_round(params, sh.flight, sh.tally, sh.geom)
            marks.append(rec["marks"])
            return sh.counts, rec
        params = sweep_params(sh.state, sh.tally, sh.rects, *args[2:], **win)
        sweep_round(params, sh.sweep, MAX_EVENTS)
        return sh.counts[:3], 0

    # -- migration (spatial modes) -----------------------------------------
    def _departures(self, sh: Shard) -> torch.Tensor:
        """[lanes leaving for each shard..., dead lanes] of shard `sh`, as
        an int64 tensor on its device; records each lane's destination
        (nshards: it stays)."""
        n = self.nshards
        state = sh.state
        _, _, in_window = window_cells(state, sh.geom, sh.x_off, sh.y_off)
        leaving = ~state.dead & ~in_window
        sh.dest = torch.where(leaving, self.owner(state.cellx, state.celly),
                              n)
        # One comparison and sum per destination: a scatter_add_ of every
        # lane into n + 1 counters serialises on their atomics (PERF.md).
        shards = torch.arange(n, device=sh.device)[:, None]
        return torch.cat([(sh.dest[None] == shards).sum(1),
                          state.dead.sum().reshape(1)])

    def _migrate(self, sends: np.ndarray, free: np.ndarray,
                 spans: Spans | None = None) -> None:
        """Move every departing lane to its owner shard: sends[s, d] lanes
        from s to d (read with the counters), free[s] dead slots on s.
        The exchange between processes, when a lane crosses one, is the
        span nt.exchange, added to `spans`."""
        out = {}
        for s, sh in zip(self.local, self.shards):
            gone = []
            for d in np.flatnonzero(sends[s]):
                idx = first_true(sh.dest == int(d), int(sends[s, d]))
                out[s, int(d)] = [getattr(sh.state, f)[idx]
                                  for f in STATE_FIELDS]
                gone.append(idx)
            if gone:
                sh.state.dead[torch.cat(gone)] = True
        if sends[self.crossing].any():
            with span("exchange", spans):
                out.update(self._exchange(sends, out))
        for r, sh in zip(self.local, self.shards):
            k = int(sends[:, r].sum())
            if k == 0:
                continue
            avail = int(free[r] + sends[r].sum())
            if k > avail:
                sh.state = grow(sh.state,
                                sh.state.n + max(k - avail, sh.state.n))
            slots = first_true(sh.state.dead, k)
            arrivals = [out[s, r] for s in range(self.nshards)
                        if (s, r) in out]
            for i, f in enumerate(STATE_FIELDS):
                getattr(sh.state, f)[slots] = torch.cat(
                    [a[i].to(sh.device) for a in arrivals])

    def _exchange(self, sends: np.ndarray, out: dict) -> dict:
        """Swap the lanes that cross between processes: this process packs
        the lanes of `out` (keyed (source, destination)) bound for each
        other process into one buffer on its first card (pack_lanes), one
        all-to-all swaps the buffers, whose sizes both sides know from
        `sends`, and the arrivals come back keyed as in `out`.  Pairs go
        in (source, destination) order on both sides."""
        me, like = rank(), self.shards[0].state
        mine = self.process == me
        send, recv_bytes = [], []
        for p in range(self.world):
            theirs = self.process == p
            pairs = ([] if p == me else
                     [(s, int(d)) for s in self.local
                      for d in np.flatnonzero(sends[s] * theirs)])
            send.append(pack_lanes([out[pair] for pair in pairs],
                                   self.device) if pairs
                        else torch.empty(0, dtype=torch.uint8,
                                         device=self.device))
            recv_bytes.append(0 if p == me else packed_bytes(
                like, int(sends[np.ix_(theirs, mine)].sum())))
        got = {}
        for p, buf in enumerate(exchange(send, recv_bytes)):
            if buf.numel() == 0:
                continue
            pairs = [(int(s), r) for s in np.flatnonzero(self.process == p)
                     for r in self.local if sends[s, r]]
            blocks = unpack_lanes(buf.to(self.device),
                                  [int(sends[pair]) for pair in pairs], like)
            got.update(zip(pairs, blocks))
        return got
