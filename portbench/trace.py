"""What a torch.profiler trace of the window says about each card.

The benchmark marks its own spans with `torch.profiler.record_function`
("portbench.window", "portbench.solve_setup", "portbench.census",
"portbench.tally_read"); they land in the trace on the host's clock
beside the cards' kernels, copies and sets.  The busy time of a card is
the union of its device intervals (the arithmetic of the program's
`measure.busy_shares`, copied), an idle gap is a stretch of the window
with none, and each gap is named by the innermost benchmark span open at
its middle ("between solves" where none is).
"""

from __future__ import annotations

import bisect

PREFIX = "portbench."
WINDOW = PREFIX + "window"
CENSUS = PREFIX + "census"
SPANS = (PREFIX + "solve_setup", CENSUS, PREFIX + "tally_read")
TOP = 10


def union(intervals: list) -> list:
    """Sorted, disjoint intervals covering the same time."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(merged: list, spans: list) -> float:
    """Length of `merged` (sorted, disjoint) inside the union of `spans`."""
    total, i = 0.0, 0
    for s0, s1 in union(spans):
        while i < len(merged) and merged[i][1] <= s0:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < s1:
            total += min(merged[j][1], s1) - max(merged[j][0], s0)
            j += 1
    return total


def gaps(merged: list, t0: float, t1: float) -> list:
    """The stretches of [t0, t1] that `merged` leaves uncovered."""
    out, at = [], t0
    for a, b in merged:
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


def open_span(t: float, spans: list, starts: list) -> str:
    """The span that holds time t: the benchmark's spans follow each other
    without overlap, so the last one that starts before t, if it has not
    ended.  `starts` are the spans' sorted starts."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][2] >= t:
        return spans[i][0][len(PREFIX):]
    return "between solves"


def summarise(events) -> dict:
    """Per card of the trace: busy and census-busy seconds, the window's
    length, seconds by device operation and idle seconds by open span.
    `events` are the profiler's raw events
    (`prof.profiler.kineto_results.events()`), timed in nanoseconds."""
    from torch.autograd import DeviceType

    window, spans, device = None, [], {}
    for e in events:
        name = e.name()
        if name.startswith(PREFIX) or e.is_user_annotation():
            if e.device_type() == DeviceType.CPU:
                if name == WINDOW:
                    window = (e.start_ns(), e.end_ns())
                elif name in SPANS:
                    spans.append((name, e.start_ns(), e.end_ns()))
            continue
        if e.device_type() == DeviceType.CUDA:
            device.setdefault(e.device_index(), []).append(
                (name, e.start_ns(), e.end_ns()))
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    t0, t1 = window
    spans.sort(key=lambda sp: sp[1])
    starts = [a for _, a, _ in spans]
    census = [(a, b) for n, a, b in spans if n == CENSUS]
    cards = {}
    for dev, evs in sorted(device.items()):
        inside = [(n, max(a, t0), min(b, t1)) for n, a, b in evs
                  if b > t0 and a < t1]
        merged = union([(a, b) for _, a, b in inside])
        ops = {}
        for n, a, b in inside:
            ops[n] = ops.get(n, 0.0) + (b - a) * 1e-9
        idle = {}
        for a, b in gaps(merged, t0, t1):
            k = open_span(0.5 * (a + b), spans, starts)
            idle[k] = idle.get(k, 0.0) + (b - a) * 1e-9
        cards[f"cuda:{dev}"] = {
            "busy_s": sum(b - a for a, b in merged) * 1e-9,
            "census_busy_s": covered(merged, census) * 1e-9,
            "ops": ops, "idle": idle}
    return {"window_s": (t1 - t0) * 1e-9, "cards": cards}


def top(totals: dict, n: int = TOP) -> list:
    """The n largest entries of {name: seconds} as [[name, seconds]]."""
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:n]]
