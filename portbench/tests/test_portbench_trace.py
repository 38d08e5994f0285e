"""The trace's interval arithmetic on hand-made intervals."""

from portbench import trace


def test_union_covered_and_gaps():
    merged = trace.union([(0, 2), (1, 3), (5, 6), (8, 12)])
    assert merged == [[0, 3], [5, 6], [8, 12]]
    assert trace.covered(merged, [(2.5, 5.5), (9, 10)]) == 2.0
    assert trace.gaps(merged, -1, 13) == [(-1, 0), (3, 5), (6, 8), (12, 13)]


def test_each_gap_is_named_by_its_open_span():
    spans = [("portbench.census", 0, 4), ("portbench.tally_read", 6, 7)]
    starts = [0, 6]
    assert trace.open_span(3, spans, starts) == "census"
    assert trace.open_span(5, spans, starts) == "between solves"
    assert trace.open_span(6.5, spans, starts) == "tally_read"


def test_top_keeps_the_largest():
    got = trace.top({str(i): float(i) for i in range(20)}, 3)
    assert got == [["19", 19.0], ["18", 18.0], ["17", 17.0]]
