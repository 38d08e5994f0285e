"""The port's spans (neutral_tpu_torch.profiler.span) on the CPU.

Each layer boundary of a solve opens `nt.<name>` on a running
torch.profiler's trace: set-up and its parts, the census, begin, the sweep
or each flight round, each host read of the card, the tally read and its
parts.  These tests run the plain engine on small decks under the
profiler with CPU activity, and the kernel engine's census loop
(census.py) on the CPU with its launches replaced by stand-ins that set
the counters as a launch would (the loop's reads, spans and records are
the real ones), through `Simulation`, two replicated shards and two
y-slabs alike.  They hold the spans' nesting, `StepMetrics.phases` (its
keys, and its wall times from the spans, over the interval of the step's
clock), `StepMetrics.nwaits` (the read spans, printed as "Host waits"),
the names through which `Simulation.step` runs its census and reads its
tally (where the benchmark plants its faults), that no profiler means no
`record_function`, and the `--trace-dir` trace.
"""

import contextlib
import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import neutral_tpu_torch as tt
from neutral_tpu_torch import (census, driver, flight_kernel, parallel,
                               profiler, sweep_kernel)

# each span's parent, as profiler.py lists them
PARENT = {
    "nt.setup.mesh": "nt.setup", "nt.setup.xs": "nt.setup",
    "nt.setup.inject": "nt.setup", "nt.setup.buffers": "nt.setup",
    "nt.setup.wait": "nt.setup",
    "nt.begin": "nt.census", "nt.begin.read": "nt.begin",
    "nt.sweep": "nt.census", "nt.sweep.read": "nt.sweep",
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
    monkeypatch.setattr(driver, "Spans", Recorded)
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

    for mod in (driver, census, parallel.common):
        monkeypatch.setattr(mod, "span", logged)
    sim.step(1)
    assert log[0] == "start" and log[1] == "open census"
    if kind == "thin":
        assert log.index("close begin") + 1 == log.index("open sweep")
        assert log[-3:] == ["stop", "close sweep", "close census"]
    else:
        assert log[-2:] == ["stop", "close census"]


# -- the kernel engine's census loop, launches replaced ----------------------

WORKING = [7, 3, 0]          # lanes still working after each launch
LAYOUTS = {"none": None, "replicated": 2, "spatial": 2}   # shards


class Mark:
    """A CUDA event's stand-in, recorded at `ms` milliseconds."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms

    def synchronize(self):
        """Recorded already: nothing to wait for."""


# A round's marks: flight 0.5 ms, then the deposit's bins 0.1 and tiles
# 0.4 ms.
MARKS = (Mark(0.0), Mark(0.5), Mark(0.6), Mark(1.0))


def layout_sim(cfg, layout):
    """`Simulation` (layout "none") or a decomposition over CPU shards."""
    if LAYOUTS[layout] is None:
        return driver.Simulation(cfg, device="cpu", quiet=True)
    return driver.make_simulation(cfg, layout, ["cpu"] * LAYOUTS[layout],
                                  quiet=True)


def as_kernel_engine(monkeypatch, sim):
    """`sim` (plain, CPU) run through the kernel engine's census loop:
    begin on the plain path, and each launch a stand-in that counts 10
    facets and 4 collisions and leaves WORKING's next count working, on
    every shard in turn.  A flight round reserves one row of a one-row
    segment buffer, and the last round of a census two: refused in the
    first census, which grows the buffer, and taken in the second."""
    begin = census.begin_census
    monkeypatch.setattr(census, "begin_census",
                        lambda engine, *a, **k: begin("plain", *a, **k))
    left = {}

    def launched(buffers):
        counts = buffers.counts
        working = left.setdefault(id(buffers),
                                  iter(WORKING * sim.cfg.niters))
        counts[0] += 10
        counts[1] += 4
        counts[2] = next(working)
        return True

    def sweep_round(params, buffers, max_events=None):
        return launched(buffers)

    def flight_round(params, buffers, tally, geom, max_pieces=None,
                     segments=None):
        launched(buffers)
        # a row reserved, or two (refused) when no lane works on
        buffers.counts[3] = 1 if buffers.counts[2] else 2
        buffers.counts[4] = 5            # the deposit's pieces
        buffers.round += 1
        start, flown, bins, done = MARKS
        return {"lanes": params.n, "pieces": 2,
                "marks": {"flight": (start, flown),
                          "deposit": (flown, bins, done),
                          "overflow": False}}

    params = lambda state, *a, **k: types.SimpleNamespace(n=state.n)  # noqa
    monkeypatch.setattr(census, "sweep_params", params)
    monkeypatch.setattr(census, "sweep_round", sweep_round)
    monkeypatch.setattr(census, "flight_params", params)
    monkeypatch.setattr(census, "flight_round", flight_round)
    sim.engine = "kernel"
    for sh in sim.shards:
        sh.buffers = (flight_kernel.FlightBuffers(
            sh.geom.nx, sh.geom.ny, sh.device, rows=1, dtype=sim.dtype,
            tally_dtype=sh.tally.dtype) if sim.transport == "flight"
            else sweep_kernel.SweepBuffers(sh.device))
    return sim


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", ["thin", "stream"])
def test_kernel_loops_read_in_spans(kind, layout, monkeypatch, recorded):
    """One loop for every layout: the same spans, reads and phase keys
    (a spatial run adds "migrate"), with every count summed over the
    shards; one read a pass, whose last holds the event counts."""
    cfg = small_cfg(kind)
    sim = as_kernel_engine(monkeypatch, layout_sim(cfg, layout))
    k = len(sim.shards)
    flight = kind == "stream"
    counter = census.flight_chunk_kernel if flight else (
        census.sweep_chunk_kernel)
    launches0 = counter.launches
    refusals0 = census.flight_chunk_kernel.refusals
    steps, spans = traced(
        lambda: [sim.step(t) for t in range(1, cfg.niters + 1)])
    check_nesting(spans)
    names = [n for n, _, _ in spans]
    passes = len(WORKING) * cfg.niters
    assert "nt.census.read" not in names
    read = "nt.flight.read" if flight else "nt.sweep.read"
    assert names.count(read) == passes
    assert counter.launches - launches0 == k * passes
    if flight:
        assert names.count("nt.flight.round") == passes
        assert names.count("nt.flight.host") == passes
        assert census.flight_chunk_kernel.refusals - refusals0 == k
    migrate = {"migrate"} if layout == "spatial" else set()
    assert names.count("nt.migrate") == (passes if migrate else 0)
    for first, m, wall in zip((True, False), steps, recorded):
        assert (m.nfacets, m.ncollisions) == (30 * k, 12 * k)
        assert m.nlaunches == len(WORKING) * k
        # the live counts, then one read a pass
        assert m.nwaits == wall.waits() == 1 + len(WORKING)
        assert m.phases["begin"] == wall.seconds["begin"]
        t_migrate = wall.seconds.get("migrate", 0.0)
        if flight:
            assert set(m.phases) == {"begin", "flight", "raster", "loop",
                                     "raster_bins", "raster_tiles",
                                     "raster_overflow"} | migrate
            assert m.phases["flight"] == pytest.approx(1.5e-3 * k)
            assert m.phases["raster"] == pytest.approx(1.5e-3 * k)
            assert m.phases["raster_bins"] == pytest.approx(0.3e-3 * k)
            assert m.phases["raster_tiles"] == pytest.approx(1.2e-3 * k)
            assert m.phases["raster_overflow"] == 0.0
            assert m.noverflows == 0
            assert m.phases["loop"] == pytest.approx(
                wall.seconds["census"] - wall.seconds["begin"] - 3e-3 * k
                - t_migrate, abs=1e-12)
            assert m.nsweeps == 2 * len(WORKING)
            assert len(m.rounds) == k * len(WORKING)
            for s in range(k):
                mine = [r for r in m.rounds if r["shard"] == s]
                assert [r["working"] for r in mine] == WORKING
                assert [r["refused"] for r in mine] == [False, False, first]
                assert [r["rows"] for r in mine] == [1, 1, 1 if first else 2]
            assert [r["overflow"] for r in m.rounds] == [False] * (3 * k)
            assert [r["deposit_pieces"] for r in m.rounds] == [5] * (3 * k)
        else:
            assert set(m.phases) == {"begin", "sweep"} | migrate
            assert m.phases["sweep"] == wall.seconds["sweep"] - t_migrate
        if migrate:
            assert m.phases["migrate"] == t_migrate


# The names of driver.py through which Simulation.step runs its census,
# as the benchmark's fault checks replace them (portbench/control.py).
SEAM = ("sweep_chunk_kernel", "flight_chunk_kernel", "sweep_chunk_plain",
        "flight_chunk_plain")


@pytest.mark.parametrize("engine", ["plain", "kernel"])
@pytest.mark.parametrize("kind", ["thin", "stream"])
def test_simulation_runs_its_census_through_the_seam(kind, engine,
                                                     monkeypatch):
    """Simulation.step runs its census through driver's names, looked up
    when it runs: replaced there, the replacement runs (once a step, the
    one of the step's engine and transport) and what it returns is the
    step's.  The object make_simulation returns for one device reads its
    tally through driver.Simulation.host_tally."""
    cfg = small_cfg(kind)
    sim = driver.make_simulation(cfg, "replicated", ["cpu"], quiet=True)
    assert type(sim) is driver.Simulation
    if engine == "kernel":
        as_kernel_engine(monkeypatch, sim)
    calls = []

    def wrap(name):
        orig = getattr(driver, name)

        def census_of(state, tally, *args, **kw):
            calls.append(name)
            out = orig(state, tally, *args, **kw)
            return (out[0], 1000 + out[1], *out[2:])
        return census_of

    for name in SEAM:
        monkeypatch.setattr(driver, name, wrap(name))
    m = sim.step(1)
    want = ("flight" if kind == "stream" else "sweep") + "_chunk_" + engine
    assert calls == [want]
    assert m.nfacets >= 1000
    host = driver.Simulation.host_tally
    read = []
    monkeypatch.setattr(driver.Simulation, "host_tally",
                        lambda self: read.append(self) or host(self) * 1.1)
    total = sim.validate()
    assert read == [sim]
    assert total == pytest.approx(1.1 * float(host(sim).sum()), rel=1e-12)


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
