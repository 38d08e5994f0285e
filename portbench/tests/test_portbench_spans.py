"""spans.table on a hand-made trace: one solve's benchmark spans, the
program's nested spans inside them, device operations with the
correlation ids of their launches (and, as torch 2.11 gives them, linked
ids of another count: their torch operators'), one with no launch, a
torch operator whose correlation id is a launch's, and the program's spans
as the card's annotations (which are no work)."""

import pytest
from torch.autograd import DeviceType

from portbench import spans, trace


class Event:
    """The part of a profiler event (torch's _KinetoEvent) that the
    readers call."""

    def __init__(self, name, start, end, device="cpu", kind="cpu_op",
                 corr=0, link=0):
        self._name, self._start, self._end = name, start, end
        self._device = DeviceType.CUDA if device == "cuda" else DeviceType.CPU
        self._kind, self._corr, self._link = kind, corr, link

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return self._device

    def device_index(self):
        return 0 if self._device == DeviceType.CUDA else -1

    def activity_type(self):
        return self._kind

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._link

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")


def span(name, a, b):
    return Event(name, a, b, kind="user_annotation")


def launch(corr, at):
    return Event("cudaLaunchKernel", at, at + 1, kind="cuda_runtime",
                 corr=corr)


def op(name, a, b, corr, link=0):
    return Event(name, a, b, device="cuda", kind="kernel", corr=corr,
                 link=link)


# One solve in a window of [0, 1000] ns.
EVENTS = [
    span("portbench.window", 0, 1000),
    span("portbench.solve_setup", 0, 100),
    span("nt.setup", 5, 95),
    span("nt.setup.inject", 10, 40),
    span("nt.setup.wait", 50, 90),
    span("portbench.census", 100, 600),
    span("nt.census", 105, 595),
    span("nt.begin", 110, 150),
    span("nt.begin.read", 130, 150),
    span("nt.sweep", 150, 590),
    span("nt.sweep.read", 300, 320),
    span("nt.sweep.read", 500, 520),
    span("nt.census.read", 580, 590),
    span("portbench.tally_read", 600, 900),
    span("nt.tally_read", 605, 895),
    span("nt.tally_read.copy", 610, 700),
    span("nt.tally_read.convert", 700, 890),
    launch(101, 15), op("threefry", 12, 45, 101, link=104),
    launch(102, 42), op("memset", 46, 48, 102, link=7),
    launch(103, 155), op("sweep_kernel", 160, 300, 103),
    launch(104, 322), op("sweep_kernel", 325, 500, 104),
    launch(105, 612), op("Memcpy DtoH", 615, 690, 105, link=101),
    op("unlaunched", 920, 950, 999),
    launch(106, 955), op("between", 960, 970, 106),
    # a torch operator whose id is a launch's: no launch itself
    Event("aten::add", 700, 710, corr=103),
    # the card's copy of a program span: an annotation, no work
    Event("nt.sweep", 150, 590, device="cuda", kind="gpu_user_annotation"),
]


def test_a_launch_is_a_runtime_call():
    assert spans.launch_call(launch(1, 0))
    assert not spans.launch_call(Event("aten::copy_", 0, 1))

    class Bare:                     # an event without activity_type
        def __init__(self, name):
            self.name = lambda: name

    assert spans.launch_call(Bare("cudaMemcpyAsync"))
    assert not spans.launch_call(Bare("aten::copy_"))


def test_spans_nest_by_a_stack():
    got = spans.nest([("p", 0, 10), ("c", 2, 4), ("d", 4, 6),
                      ("g", 5, 6), ("q", 12, 13)])
    assert got == [(0, 2, 0), (2, 4, 1), (4, 5, 2), (5, 6, 3), (6, 10, 0),
                   (12, 13, 4)]
    starts = [a for a, _, _ in got]
    assert spans.innermost(5.5, got, starts) == 3
    assert spans.innermost(8, got, starts) == 0
    assert spans.innermost(11, got, starts) is None


def test_each_gap_is_named_by_its_innermost_program_span():
    idle = spans.table(EVENTS)["idle"]
    assert idle == pytest.approx({
        "solve_setup/nt.setup": 13e-9,
        "census": 112e-9,
        "census/nt.sweep.read": 25e-9,
        "census/nt.sweep": 115e-9,
        "tally_read/nt.tally_read.convert": 230e-9,
        "between solves": 40e-9})


def test_device_time_goes_to_the_span_that_launched_it():
    """By the correlation id of the launch, never the linked id (a torch
    operator's, which may equal another launch's correlation id)."""
    tab = spans.table(EVENTS)
    sp = tab["spans"]
    assert sp["nt.setup.inject"]["device_s"] == pytest.approx(33e-9)
    assert sp["nt.setup"]["device_s"] == pytest.approx(2e-9)
    assert sp["nt.sweep"]["device_s"] == pytest.approx(315e-9)
    assert sp["nt.tally_read.copy"]["device_s"] == pytest.approx(75e-9)
    assert sp["nt.tally_read.convert"]["device_s"] == 0.0
    assert tab["unlinked_device_s"] == pytest.approx(30e-9)
    # the kernel launched between solves is in no span, but is busy time
    assert sum(r["device_s"] for r in sp.values()) == pytest.approx(
        (33 + 2 + 315 + 75) * 1e-9)
    assert tab["busy_s"] == pytest.approx(
        (33 + 2 + 140 + 175 + 75 + 30 + 10) * 1e-9)


def test_self_time_leaves_out_the_child_spans():
    sp = spans.table(EVENTS)["spans"]
    assert sp["nt.setup"]["host_s"] == pytest.approx(90e-9)
    assert sp["nt.setup"]["self_s"] == pytest.approx(20e-9)
    assert sp["nt.census"]["self_s"] == pytest.approx(10e-9)
    assert sp["nt.sweep"]["self_s"] == pytest.approx(390e-9)
    assert sp["nt.sweep.read"]["count"] == 2
    assert sp["nt.sweep.read"]["self_s"] == pytest.approx(40e-9)
    assert sp["nt.tally_read"]["self_s"] == pytest.approx(10e-9)
    assert sp["nt.sweep"]["idle_s"] == pytest.approx(115e-9)


def test_the_benchmark_readers_read_the_same_trace_as_before():
    """trace.summarise (what idle_share and census_roofline read) on the
    trace with the program's spans in it, and spans.table's idle summed by
    benchmark span: the figures of the trace without them."""
    bare = [e for e in EVENTS if not e.name().startswith("nt.")]
    before, after = trace.summarise(bare), trace.summarise(EVENTS)
    assert after == before
    card = after["cards"]["cuda:0"]
    assert card["busy_s"] == pytest.approx(465e-9)
    assert card["census_busy_s"] == pytest.approx(315e-9)
    assert 1.0 - card["busy_s"] / after["window_s"] == pytest.approx(0.535)
    totals = {}
    for k, v in spans.table(EVENTS)["idle"].items():
        totals[k.split("/")[0]] = totals.get(k.split("/")[0], 0.0) + v
    assert totals == pytest.approx(card["idle"])
    assert spans.table(EVENTS)["busy_s"] == pytest.approx(card["busy_s"])


def test_readings_per_solve():
    got = spans.readings(spans.table(EVENTS), solves=1)
    assert got["tally_read_ms"] == pytest.approx(290e-6)
    assert got["tally_copy_ms"] == pytest.approx(90e-6)
    assert got["tally_convert_ms"] == pytest.approx(190e-6)
    assert got["inject_ms"] == pytest.approx(33e-6)
    # begin.read, two sweep.read, census.read, setup.wait, tally_read
    assert got["host_waits"] == 6
    # 13 + 25 + 115 + 230 of 13 + 252 + 230 ns inside the solve spans
    assert got["idle_named_pct"] == pytest.approx(100 * 383 / 495)
