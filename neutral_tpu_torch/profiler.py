"""Step-level wall-clock timers and an opt-in trace (port of
`neutral_tpu/profiler.py`).

The counterpart of the reference harness's profiler entries (main.c:54-59,
82, 99, 115-116).  PyTorch returns before the device finishes, so every
start and stop first waits with `torch.cuda.synchronize()` for each card
the profile holds (every card of a process's shards): a step's time
covers its device work on all of them.
`maybe_trace` records a torch.profiler trace (CPU, and CUDA when a card is
there: the kernels of csrc/ show under their own names) in place of
neutral_tpu's jax.profiler trace.

`span` marks a layer boundary of the program: under a running profiler it
opens `record_function("nt." + name)`, which lands on the trace's host
clock beside the card's kernels, copies and sets; with none running it
only checks that none is.  Given a `Spans`, it also adds its wall time and
one entry to it: `StepMetrics.phases` and `StepMetrics.nwaits` are read
from the spans of the step.  The spans, nested as they open:

    nt.setup          make_simulation
      nt.setup.mesh     make_geometry, build_mesh
      nt.setup.xs       load_cross_sections, the same-table compare
      nt.setup.inject   a shard's injection (census.new_shard, once a
                        shard): one launch of the inject kernel
                        (inject_kernel.py) on the kernel engine,
                        particles.inject_particles on the plain engine
      nt.setup.buffers  a shard's tally, FlightBuffers, SweepBuffers
      nt.setup.wait     the closing synchronize
    nt.census         SimulationBase.step, the census loop (census.py)
      nt.begin          begin_census on every shard
        nt.begin.read     the host read of the live counts
      nt.sweep          the sweep transport's passes
        nt.sweep.read     each pass's read of the counters (facets and
                          collisions so far, lanes still working)
      nt.flight.round   one pass of flight rounds (flight transport),
                        each with
        nt.flight.read    the pass's read of the counters
        nt.flight.host    after_round: re-deposit, segment buffer growth
          nt.flight.redeposit  a deposit's re-run after its piece buffer
                               overflowed: the buffer's growth and launch
      nt.migrate        migration between shards (spatial decompositions)
        nt.exchange       the lanes' exchange between processes
    nt.tally_read     host_tally (census.read_tallies)
      nt.tally_read.convert  on a card, the tally's conversion to float64
                             there (exact; empty for a float64 tally)
      nt.tally_read.copy     the blocking copy into a float64 host block:
                             pinned from torch's caching host allocator
                             on a card, pageable (and converting) on the
                             CPU

Every `*.read` span, `nt.setup.wait` and `nt.tally_read` is a host wait
for the card.

`TALLY_READS` (a `TallyReads`) counts the process's tally reads and, of
them, those whose pinned block had an address not seen before: `fresh`
counts the host allocations (`cudaHostAlloc`), `reads - fresh` on a card
the blocks reused from the cache.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class ProfileEntry:
    name: str
    time: float


@dataclass
class Profile:
    """Ordered named wall-clock entries, like arch's profiler_entries,
    timed over `devices` (the CUDA ones are waited for)."""
    devices: list = field(default_factory=lambda: [torch.device("cpu")])
    entries: list[ProfileEntry] = field(default_factory=list)
    _t0: float = 0.0

    def _sync(self) -> None:
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self, name: str) -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        self.entries.append(ProfileEntry(name, dt))
        return dt

    def total(self) -> float:
        return sum(e.time for e in self.entries)

    def summary(self) -> str:
        lines = ["PROFILING RESULTS:"]
        for e in self.entries:
            lines.append(f"  {e.name:<24s} {e.time:.6f}s")
        lines.append(f"  {'TOTAL':<24s} {self.total():.6f}s")
        return "\n".join(lines)


PREFIX = "nt."


@dataclass
class Spans:
    """Wall seconds and entries of the spans opened with it, by name
    (without PREFIX)."""
    seconds: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def waits(self) -> int:
        """Entries of the `*.read` spans: host reads that wait for the
        card."""
        return sum(n for k, n in self.counts.items() if k.endswith(".read"))


@dataclass
class TallyReads:
    """Tally reads (`host_tally`) and, of them, those into a pinned block
    at an address not seen before (no pinned block on the CPU: `address`
    None)."""
    reads: int = 0
    fresh: int = 0
    seen: set = field(default_factory=set)

    def add(self, address: int | None) -> None:
        self.reads += 1
        if address is not None and address not in self.seen:
            self.seen.add(address)
            self.fresh += 1


TALLY_READS = TallyReads()


@contextlib.contextmanager
def span(name: str, spans: Spans | None = None):
    """The span PREFIX + `name` on a running profiler's trace (nothing
    when none runs), and, given `spans`, its wall time and one entry
    added to it."""
    scope = (torch.profiler.record_function(PREFIX + name)
             if torch.autograd.profiler._is_profiler_enabled
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    try:
        with scope:
            yield
    finally:
        if spans is not None:
            spans.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """Trace the region with torch.profiler into `trace_dir`/trace.json (a
    Chrome trace, which holds the `nt.*` spans beside the kernels); nothing
    when `trace_dir` is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
