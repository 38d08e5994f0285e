"""The port's spans (neutral_tpu_torch.profiler.span) on the CPU.

Each layer boundary of a solve opens `nt.<name>` on a running
torch.profiler's trace: set-up and its parts, the census, begin, the sweep
or each flight round, each host read of the card, the tally read and its
parts.  These tests run the plain engine on small decks under the
profiler with CPU activity, and the kernel engine's host loops on the CPU
with their launches replaced by stand-ins that set the counters as a
launch would (the loops' reads, spans and records are the real ones).
They hold the spans' nesting, `StepMetrics.phases` (its keys, and its
wall times from the spans, over the interval of the step's clock),
`StepMetrics.nwaits` (the read spans, printed as "Host waits"), that no
profiler means no `record_function`, and the `--trace-dir` trace.
"""

import contextlib
import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import neutral_tpu_torch as tt
from neutral_tpu_torch import (driver, flight_kernel, parallel, profiler,
                               sweep_kernel)

# each span's parent, as profiler.py lists them
PARENT = {
    "nt.setup.mesh": "nt.setup", "nt.setup.xs": "nt.setup",
    "nt.setup.inject": "nt.setup", "nt.setup.buffers": "nt.setup",
    "nt.setup.wait": "nt.setup",
    "nt.begin": "nt.census", "nt.begin.read": "nt.begin",
    "nt.sweep": "nt.census", "nt.sweep.read": "nt.sweep",
    "nt.census.read": "nt.census",
    "nt.flight.round": "nt.census", "nt.flight.read": "nt.flight.round",
    "nt.flight.host": "nt.flight.round",
    "nt.flight.redeposit": "nt.flight.host",
    "nt.migrate": "nt.census",
    "nt.tally_read.copy": "nt.tally_read",
    "nt.tally_read.convert": "nt.tally_read",
}
TOP = {"nt.setup", "nt.census", "nt.tally_read"}
SETUP = {"nt.setup", "nt.setup.mesh", "nt.setup.xs", "nt.setup.inject",
         "nt.setup.buffers", "nt.setup.wait"}
TALLY = {"nt.tally_read", "nt.tally_read.copy", "nt.tally_read.convert"}


def small_cfg(kind, n=200, nx=32, iters=2):
    """A small deck: thin (sweep transport, lanes crossing the middle of
    the mesh) or stream (flight)."""
    P, S = tt.ProblemRegion, tt.SourceBox
    problems, e0, src = {
        "thin": ((P(1.0, 0, 0, 1, 1),), 1.0e3, S(0.3, 0.3, 0.4, 0.4)),
        "stream": ((P(1.0e-30, 0, 0, 1, 1),), 1.0e6,
                   S(0.45, 0.45, 0.1, 0.1)),
    }[kind]
    return tt.SimConfig(nx=nx, ny=nx, width=1.0, height=1.0, dt=1e-7,
                        niters=iters, nparticles=n, initial_energy=e0,
                        source=src, problems=problems)


def traced(fn):
    """fn()'s result and the `nt.*` spans it opened under the profiler,
    as sorted (name, start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("nt.")), key=lambda s: s[1])
    return out, spans


def check_nesting(spans):
    """Every span lies inside a span of its parent's name; the top spans
    inside no other program span."""
    for name, a, b in spans:
        holders = {n for n, pa, pb in spans
                   if (pa, pb) != (a, b) and pa <= a and b <= pb}
        if name in TOP:
            assert not holders, (name, holders)
        else:
            assert PARENT[name] in holders, (name, holders)


class Recorded(profiler.Spans):
    """profiler.Spans that keeps every instance made, to read a step's."""
    made = []

    def __init__(self):
        super().__init__()
        Recorded.made.append(self)


@pytest.fixture
def recorded(monkeypatch):
    Recorded.made = []
    for mod in (driver, parallel.common):
        monkeypatch.setattr(mod, "Spans", Recorded)
    return Recorded.made


def solve(cfg, transport="auto"):
    sim = driver.make_simulation(cfg, "replicated", ["cpu"], quiet=True,
                                 transport=transport)
    steps = [sim.step(t) for t in range(1, cfg.niters + 1)]
    sim.host_tally()
    return sim, steps


@pytest.mark.parametrize("kind", ["thin", "stream"])
def test_plain_solve_opens_nested_spans(kind, recorded):
    (sim, steps), spans = traced(lambda: solve(small_cfg(kind)))
    names = [n for n, _, _ in spans]
    check_nesting(spans)
    assert SETUP | TALLY <= set(names)
    for name in ("nt.census", "nt.begin", "nt.begin.read"):
        assert names.count(name) == 2
    assert names.count("nt.sweep") == (2 if kind == "thin" else 0)
    assert names.count("nt.setup.inject") == 1
    # phases keep their keys; begin and sweep are the spans' wall times
    keys = {"thin": {"begin", "sweep"},
            "stream": {"begin", "flight", "raster", "loop"}}[kind]
    for m, wall in zip(steps, recorded):
        assert set(m.phases) == keys
        assert m.phases["begin"] == wall.seconds["begin"]
        if kind == "thin":
            assert m.phases["sweep"] == wall.seconds["sweep"]
        else:
            assert m.phases["loop"] == pytest.approx(
                wall.seconds["census"] - wall.seconds["begin"]
                - m.phases["flight"] - m.phases["raster"], abs=1e-12)
        # the plain engine's one host read: the live count
        assert m.nwaits == wall.waits() == 1


def test_spatial_step_opens_the_same_spans(recorded):
    cfg = small_cfg("thin", n=300)

    def run():
        sim = driver.make_simulation(cfg, "spatial", ["cpu"] * 2,
                                     quiet=True)
        return [sim.step(t) for t in range(1, cfg.niters + 1)]

    steps, spans = traced(run)
    check_nesting(spans)
    names = [n for n, _, _ in spans]
    reads = names.count("nt.begin.read") + names.count("nt.sweep.read")
    assert {"nt.migrate", "nt.sweep.read"} <= set(names)
    assert sum(m.nwaits for m in steps) == reads
    for m, wall in zip(steps, recorded):
        assert set(m.phases) == {"begin", "sweep", "migrate"}
        assert m.phases["migrate"] == wall.seconds["migrate"]
        assert m.phases["sweep"] == pytest.approx(
            wall.seconds["sweep"] - wall.seconds["migrate"], abs=1e-12)
    assert sum(m.nmigrated for m in steps) > 0


@pytest.mark.parametrize("kind,decomposition", [
    ("thin", "none"), ("stream", "none"), ("thin", "spatial"),
    ("stream", "replicated")])
def test_phases_keep_the_step_clocks_interval(kind, decomposition,
                                              monkeypatch):
    """The step's clock starts before nt.census opens; it stops inside
    nt.sweep (sweep transport) and inside nt.census: "begin", "sweep" and
    "loop" cover what the clock's perf_counter differences covered."""
    cfg = small_cfg(kind, n=300)
    sim = (driver.Simulation(cfg, device="cpu", quiet=True)
           if decomposition == "none" else
           driver.make_simulation(cfg, decomposition, ["cpu"] * 2,
                                  quiet=True))
    log = []
    start, stop = sim.profile.start, sim.profile.stop
    monkeypatch.setattr(sim.profile, "start",
                        lambda: (log.append("start"), start())[1])
    monkeypatch.setattr(sim.profile, "stop",
                        lambda name: (log.append("stop"), stop(name))[1])
    inner = profiler.span

    @contextlib.contextmanager
    def logged(name, spans=None):
        log.append("open " + name)
        with inner(name, spans):
            yield
        log.append("close " + name)

    for mod in (driver, parallel.common):
        monkeypatch.setattr(mod, "span", logged)
    sim.step(1)
    assert log[0] == "start" and log[1] == "open census"
    if kind == "thin":
        assert log.index("close begin") + 1 == log.index("open sweep")
        assert log[-3:] == ["stop", "close sweep", "close census"]
    else:
        assert log[-2:] == ["stop", "close census"]


# -- the kernel engine's host loops, launches replaced ------------------------

WORKING = [7, 3, 0]          # lanes still working after each launch


class Mark:
    """A CUDA event's stand-in, recorded at `ms` milliseconds."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


# A round's marks: flight 0.5 ms, then the deposit's bins 0.1 and tiles
# 0.4 ms.
MARKS = (Mark(0.0), Mark(0.5), Mark(0.6), Mark(1.0))


def as_kernel_engine(monkeypatch, sim):
    """`sim` (plain, CPU) run through the kernel engine's host loops: begin
    on the plain path, and each launch a stand-in that counts 10 facets
    and 4 collisions and leaves WORKING's next count working."""
    begin = driver.begin_census
    monkeypatch.setattr(driver, "begin_census",
                        lambda engine, *a, **k: begin("plain", *a, **k))
    left = iter(WORKING * sim.cfg.niters)

    def launched(counts):
        counts[0] += 10
        counts[1] += 4
        counts[2] = next(left)

    def sweep_round(params, buffers, max_events=None):
        launched(buffers.counts)

    def flight_round(params, buffers, tally, geom, max_pieces=None,
                     segments=None):
        launched(buffers.counts)
        buffers.counts[3] = 1            # a row reserved, none refused
        buffers.counts[4] = 5            # the deposit's pieces
        buffers.round += 1
        start, flown, bins, done = MARKS
        return {"lanes": params.n, "pieces": 2,
                "marks": {"flight": (start, flown),
                          "deposit": (flown, bins, done),
                          "overflow": False}}

    params = lambda state, *a, **k: types.SimpleNamespace(n=state.n)  # noqa
    monkeypatch.setattr(sweep_kernel, "sweep_params", params)
    monkeypatch.setattr(sweep_kernel, "sweep_round", sweep_round)
    monkeypatch.setattr(flight_kernel, "flight_params", params)
    monkeypatch.setattr(flight_kernel, "flight_round", flight_round)
    sim.engine = "kernel"
    if sim.transport == "flight":
        sim.flight = flight_kernel.FlightBuffers(
            sim.cfg.nx, sim.cfg.ny, sim.device, dtype=sim.dtype,
            tally_dtype=sim.tally.dtype)
    else:
        sim.sweep = sweep_kernel.SweepBuffers(sim.device)
    return sim


@pytest.mark.parametrize("kind", ["thin", "stream"])
def test_kernel_loops_read_in_spans(kind, monkeypatch, recorded):
    cfg = small_cfg(kind)
    sim = driver.Simulation(cfg, device="cpu", quiet=True)
    as_kernel_engine(monkeypatch, sim)
    steps, spans = traced(
        lambda: [sim.step(t) for t in range(1, cfg.niters + 1)])
    check_nesting(spans)
    names = [n for n, _, _ in spans]
    launches = len(WORKING) * cfg.niters
    assert names.count("nt.census.read") == cfg.niters
    flight = kind == "stream"
    read = "nt.flight.read" if flight else "nt.sweep.read"
    assert names.count(read) == launches
    if flight:
        assert names.count("nt.flight.round") == launches
        assert names.count("nt.flight.host") == launches
    for m, wall in zip(steps, recorded):
        assert (m.nfacets, m.ncollisions) == (30, 12)
        assert m.nlaunches == len(WORKING)
        # the live count, one read a launch, the event counts
        assert m.nwaits == wall.waits() == 1 + len(WORKING) + 1
        assert m.phases["begin"] == wall.seconds["begin"]
        if flight:
            assert set(m.phases) == {"begin", "flight", "raster", "loop",
                                     "raster_bins", "raster_tiles",
                                     "raster_overflow"}
            assert m.phases["flight"] == pytest.approx(1.5e-3)
            assert m.phases["raster"] == pytest.approx(1.5e-3)
            assert m.phases["raster_bins"] == pytest.approx(0.3e-3)
            assert m.phases["raster_tiles"] == pytest.approx(1.2e-3)
            assert m.phases["raster_overflow"] == 0.0
            assert m.noverflows == 0
            assert m.phases["loop"] == pytest.approx(
                wall.seconds["census"] - wall.seconds["begin"] - 3e-3,
                abs=1e-12)
            assert [r["working"] for r in m.rounds] == WORKING
            assert [r["overflow"] for r in m.rounds] == [False] * 3
            assert [r["deposit_pieces"] for r in m.rounds] == [5] * 3
            assert [r["refused"] for r in m.rounds] == [False] * 3
        else:
            assert set(m.phases) == {"begin", "sweep"}
            assert m.phases["sweep"] == wall.seconds["sweep"]


# -- the helper ---------------------------------------------------------------

def test_span_without_a_profiler_opens_no_record_function(monkeypatch):
    opened = []

    class Scope:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Scope)
    wall = profiler.Spans()
    with profiler.span("x.read", wall):
        pass
    assert opened == []
    assert wall.counts == {"x.read": 1} and wall.waits() == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("x"):
            pass
    assert opened == ["nt.x"]


def test_span_records_its_time_when_its_body_raises():
    wall = profiler.Spans()
    with pytest.raises(ValueError):
        with profiler.span("x", wall):
            raise ValueError
    assert wall.counts == {"x": 1} and wall.seconds["x"] >= 0.0


def test_trace_dir_holds_the_program_spans(tmp_path, capsys):
    trace = tmp_path / "trace"
    assert driver.main(["problems/stream.params", "--device", "cpu",
                        "--nparticles", "20", "--mesh-scale", "250",
                        "--iterations", "1", "--trace-dir", str(trace)]) == 0
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert SETUP | TALLY | {"nt.census", "nt.begin", "nt.begin.read"} <= names
    # the step's output prints its waits: the plain engine's live count
    assert "Host waits 1 (reads that waited for the device)\nStep time" in (
        capsys.readouterr().out)
