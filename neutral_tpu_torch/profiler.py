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


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """Trace the region with torch.profiler into `trace_dir`/trace.json (a
    Chrome trace); nothing when `trace_dir` is None."""
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
