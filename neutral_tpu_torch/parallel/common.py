"""The decomposed runs' shared machinery: shards, migration, gathers.

Port of `neutral_tpu/parallel/`.  A run is split into shards, each with
its own device (several shards may share one card), its own particles and
its own tally.  The JAX package built each decomposition from `shard_map`
programs with collectives; here the census loop of census.py, the one
that `Simulation` runs over its one shard, drives every shard of a
process, and a run over several processes (distributed.py) splits the
global shards into contiguous blocks, one per process, each driven by the
same loop.  Each pass reads every global shard's counters at once
(`distributed.gather_counters`; with several processes on the card under
NCCL, then one read), so that every process takes the same decisions and
makes the same collective calls.  This module adds migration (spatial
modes, `departures` and `migrate`): each lane that left its shard's
window goes straight to its owner shard, into a dead slot, the owner's
tensors growing when dead slots run out; the departures read with the
counters size every gather, so migration waits for nothing, and a shard
that received lanes covers all of its lanes in its next launch.  Lanes
bound for another process's shard are packed into one buffer per pair of
processes and swapped by one all-to-all (`exchange`: card to card under
NCCL, staged on the host under gloo); arrivals land in source-shard
order, so every shard holds bitwise the lanes of the single-process run
with the same shards.

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
`process_allgather` does), and process 0 alone writes files; in one
process the tallies are read as `Simulation`'s is (census.read_tallies).

JAX's flight_sharded.py has no module of its own here: its decomposed
flight step is the flight branch of the same loop, whose lists of working
lanes do the work of JAX's flight compaction.  Not ported, as TPU
mechanisms: the u32-pair control vector (one int64 read replaces it), the
pending-flush rings, the sweep transport's compaction ladder, and the
fixed `cap_xfer` budgets of the neighbour-only `ppermute` exchange with
its overflow, repartition and abort path (growth replaces them).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import census
from ..census import Shard
from ..driver import SimulationBase, check_device
from ..particles import STATE_FIELDS, ParticleState, state_from_numpy
from ..profiler import Spans, span
from ..transport import window_cells
from . import distributed
from .distributed import (all_gather_arrays, exchange, gather_counters,
                          local_shards, process_of, rank)


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
    read_counters = staticmethod(gather_counters)

    def __init__(self, cfg, *, devices=None, engine: str = "auto",
                 transport: str = "auto", quiet: bool = False):
        devices = (shard_devices() if devices is None
                   else [torch.device(d) for d in devices])
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"shards on devices of one type only: {devices}")
        self.local = local_shards(len(devices))
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
        """Every global shard's tally as a host array, in shard order: in
        one process float64, read as Simulation's is (census.read_tallies),
        and over several gathered from every process (a collective)."""
        tallies = [sh.tally for sh in self.shards]
        if self.world == 1:
            return census.read_tallies(tallies)
        return all_gather_arrays(tallies)

    def states(self) -> list[ParticleState]:
        """Every global shard's particles: with several processes gathered
        to the host of every process (a collective)."""
        if self.world == 1:
            return super().states()
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

    # -- the census -----------------------------------------------------------
    def passes(self, tt: int, work: np.ndarray,
               spans: Spans) -> census.StepMetrics:
        return census.passes(
            self.shards, tt, 1.0 / self.cfg.nparticles, work,
            transport=self.transport, engine=self.engine, spans=spans,
            read=self.read_counters, local=self.local,
            migration=self if self.migrates else None)

    # -- migration (spatial modes) -----------------------------------------
    def departures(self, sh: Shard) -> torch.Tensor:
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

    def migrate(self, columns: np.ndarray,
                spans: Spans | None = None) -> tuple:
        """Move every departing lane to its owner shard, from `columns`,
        every global shard's departures as read with the counters:
        sends[s, d] lanes from s to d and free[s] dead slots on s.  The
        exchange between processes, when a lane crosses one, is the span
        nt.exchange, added to `spans`.  Returns (the lanes each global
        shard received, the lanes moved, those that crossed between
        processes)."""
        n = self.nshards
        sends, free = columns[:, :n], columns[:, n]
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
        return (sends.sum(axis=0), int(sends.sum()),
                int(sends[self.crossing].sum()))

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
