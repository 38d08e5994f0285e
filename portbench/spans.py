"""The program's own spans in a torch.profiler trace of solves.

`neutral_tpu_torch.profiler.span` marks the port's layer boundaries with
`record_function("nt." + name)` (set-up and its parts, the census, begin,
the sweep or each flight round, each host read of the card, the tally
read and its copy and conversion; the list is in that module).  They land
on the trace's host clock beside the benchmark's own spans (trace.py) and
the cards' operations.  `table` reads them:

- for each `nt.*` name: `count`; `host_s`, the sum of its durations;
  `self_s`, those durations less what its child spans cover; `device_s`,
  the device time of the operations launched while it was the innermost
  span open (each operation matched to the CUDA runtime or driver call
  that launched it by their correlation id, CUPTI's; its
  `linked_correlation_id` is the id of the torch operator that made the
  call, of another count, and 0 for the kernels launched through ctypes,
  in torch 2.11); `idle_s`, the idle
  gaps whose middle falls while it is the innermost span open, meaned
  over the cards;
- `unlinked_device_s`: device time, inside the window, of operations whose
  launch the trace does not hold;
- `idle`: the cards' idle seconds (meaned over the cards) named
  `<benchmark span>/<innermost nt span>` (`tally_read/nt.tally_read.convert`),
  or by the benchmark span alone where no program span is open, so that
  summed by the name before the slash they are trace.summarise's.

Spans nest by a stack: the innermost open span at a time is the latest
opened of those that hold it.

Run as a command on a card, it solves replicas of a cell under the
profiler as the benchmark's traced window does, and prints one line of
JSON: the table, the per-solve readings (`readings`) and, for
comparison, the benchmark's own figures of the same window:

    python3 portbench/spans.py --workload csp.f32 --seed 12345 --seconds 10

That command's window is its own, not `run.py`'s: the harness's traced
window keeps only `trace.summarise`'s summary, so no metric reads the
spans yet.  Once `trace.summarise` calls `table` and the metrics read
`readings`, `main` and its window go.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import trace  # noqa: E402

NT = "nt."
RUNTIME = ("cuda_runtime", "cuda_driver")
# the benchmark spans whose idle time the program's spans should name
SOLVE = tuple(s[len(trace.PREFIX):] for s in trace.SPANS)


def launch_call(e) -> bool:
    """Whether host event `e` is a CUDA runtime or driver call, the launch
    that a device operation links to (by its activity type; by its name
    where the event has none)."""
    kind = getattr(e, "activity_type", None)
    if kind is None:
        return e.name().startswith("cu")
    return kind() in RUNTIME


def nest(spans: list) -> list:
    """Sorted, disjoint segments (start, end, i) of the time that `spans`
    [(name, start, end)] cover, each with the index of the innermost span
    open over it: a stack of the open spans, the latest opened on top,
    each leaving it at its end."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    segs, stack, at = [], [], None

    def upto(t):
        nonlocal at
        if stack and t > at:
            segs.append((at, t, stack[-1]))
        at = t if at is None else max(at, t)

    for i in order:
        start = spans[i][1]
        while stack and spans[stack[-1]][2] <= start:
            upto(spans[stack[-1]][2])
            stack.pop()
        upto(start)
        stack.append(i)
    while stack:
        upto(spans[stack[-1]][2])
        stack.pop()
    return segs


def innermost(t: float, segs: list, starts: list) -> int | None:
    """The index of the innermost span open at time t (nest's segments and
    their starts), None where none is."""
    k = bisect.bisect_right(starts, t) - 1
    if k >= 0 and segs[k][1] >= t:
        return segs[k][2]
    return None


def table(events) -> dict:
    """The program's spans of a trace (the profiler's raw events,
    `prof.profiler.kineto_results.events()`, timed in nanoseconds, with
    the benchmark's window span), as the module's docstring says."""
    from torch.autograd import DeviceType

    window, bench, nt, launched, device = None, [], [], {}, []
    for e in events:
        name = e.name()
        cpu = e.device_type() == DeviceType.CPU
        if (name.startswith((trace.PREFIX, NT))
                or e.is_user_annotation()):
            if cpu and name == trace.WINDOW:
                window = (e.start_ns(), e.end_ns())
            elif cpu and name in trace.SPANS:
                bench.append((name, e.start_ns(), e.end_ns()))
            elif cpu and name.startswith(NT):
                nt.append((name, e.start_ns(), e.end_ns()))
            continue
        if cpu:
            if launch_call(e):
                launched[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA:
            device.append((e.device_index(), e.correlation_id(),
                           e.start_ns(), e.end_ns()))
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    t0, t1 = window
    segs = nest(nt)
    starts = [a for a, _, _ in segs]
    spans = {}
    for name, a, b in nt:
        row = spans.setdefault(name, {"count": 0, "host_s": 0.0,
                                      "self_s": 0.0, "device_s": 0.0,
                                      "idle_s": 0.0})
        row["count"] += 1
        row["host_s"] += (b - a) * 1e-9
    for a, b, i in segs:
        spans[nt[i][0]]["self_s"] += (b - a) * 1e-9
    unlinked, cards = 0.0, {}
    for dev, corr, a, b in device:
        cards.setdefault(dev, []).append((a, b))
        at = launched.get(corr)
        if at is None:
            unlinked += max(0, min(b, t1) - max(a, t0)) * 1e-9
            continue
        i = innermost(at, segs, starts)
        if i is not None:
            spans[nt[i][0]]["device_s"] += (b - a) * 1e-9
    bench.sort(key=lambda sp: sp[1])
    bench_starts = [a for _, a, _ in bench]
    idle, busy = {}, 0.0
    n = max(len(cards), 1)
    for intervals in cards.values():
        merged = trace.union([(max(a, t0), min(b, t1))
                              for a, b in intervals if b > t0 and a < t1])
        busy += sum(b - a for a, b in merged) * 1e-9 / n
        for a, b in trace.gaps(merged, t0, t1):
            mid, secs = 0.5 * (a + b), (b - a) * 1e-9 / n
            key = trace.open_span(mid, bench, bench_starts)
            i = innermost(mid, segs, starts)
            if i is not None:
                spans[nt[i][0]]["idle_s"] += secs
                key = f"{key}/{nt[i][0]}"
            idle[key] = idle.get(key, 0.0) + secs
    return {"window_s": (t1 - t0) * 1e-9, "busy_s": busy, "spans": spans,
            "unlinked_device_s": unlinked, "idle": idle}


def readings(tab: dict, solves: int) -> dict:
    """Per solve of a window of `solves` solves: the tally read and its
    copy and conversion (host ms), injection's device ms, the host waits
    for the card (the `*.read` spans, set-up's closing wait and the tally
    read); and the share of the idle time inside the benchmark's solve
    spans that a program span names, in %."""
    sp = tab["spans"]

    def per(name, key):
        return 1e3 * sp[name][key] / solves if name in sp else None

    waits = sum(r["count"] for k, r in sp.items()
                if k.endswith(".read") or k in ("nt.setup.wait",
                                                "nt.tally_read"))
    inside = {k: v for k, v in tab["idle"].items()
              if k.split("/")[0] in SOLVE}
    total = sum(inside.values())
    named = sum(v for k, v in inside.items() if "/" in k)
    return {"tally_read_ms": per("nt.tally_read", "host_s"),
            "tally_copy_ms": per("nt.tally_read.copy", "host_s"),
            "tally_convert_ms": per("nt.tally_read.convert", "host_s"),
            "inject_ms": per("nt.setup.inject", "device_s"),
            "host_waits": waits / solves if sp else None,
            "idle_named_pct": 100.0 * named / total if total else None}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="portbench/spans.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    from portbench import harness
    harness.cache_dirs()
    cell = harness.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench/spans.py: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function
    from neutral_tpu_torch import build
    build.load()
    dev = torch.device("cuda")
    traffic = cell["traffic"]
    cfg = harness.sim_config(cell["config"], traffic)
    harness.solve(dev, cfg, traffic, args.seed, -1)          # warm-up
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    solves, t0 = [], time.perf_counter()
    with record_function(trace.WINDOW):
        while not solves or time.perf_counter() - t0 < args.seconds:
            solves.append(harness.solve(dev, cfg, traffic, args.seed,
                                        len(solves)))
    window_s = time.perf_counter() - t0
    prof.stop()
    events = prof.profiler.kineto_results.events()
    summary = trace.summarise(events)
    tab = table(events)
    del prof
    card = next(iter(summary["cards"].values()), {})
    print(json.dumps({
        "cell": cell["name"], "seed": args.seed, "solves": len(solves),
        "events_per_s": sum(st["facets"] + st["collisions"]
                            for s in solves for st in s["steps"]) / window_s,
        "tally_ms_median": statistics.median(s["tally_ms"] for s in solves),
        "tally_ms_mean": statistics.mean(s["tally_ms"] for s in solves),
        "setup_ms_mean": statistics.mean(s["setup_ms"] for s in solves),
        "launches_per_solve": statistics.mean(
            sum(st["launches"] for st in s["steps"]) for s in solves),
        "idle_share": (100.0 * (1.0 - card["busy_s"] / summary["window_s"])
                       if card else None),
        "idle_by_benchmark_span": card.get("idle", {}),
        "readings": readings(tab, len(solves)), **tab,
        "cards": harness.power_limits()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
