"""The segment deposit's metrics (deposit_bins_ms, deposit_tiles_ms,
deposit_overflow_ms, deposit_roofline) on synthetic records, its bound on
hand-counted inputs, and the stream.f32 cell found by name."""

import pytest

from portbench import check, deposit_bound, harness

READERS = ("deposit_bins_ms", "deposit_tiles_ms", "deposit_overflow_ms",
           "deposit_roofline")
FLIGHT = {"flight": 0.002, "raster": 0.040, "raster_bins": 0.008,
          "raster_tiles": 0.032, "raster_overflow": 0.006, "loop": 0.001,
          "begin": 0.0005}


def context(steps_by_solve, config=None, traffic=None):
    """A harness.Context over solves whose censuses have these phases and
    facets: each solve a list of (phases, facets)."""
    rec = harness.Record(window_s=1.0, solves=[
        {"steps": [{"live": 10, "facets": f, "collisions": 0, "phases": ph}
                   for ph, f in steps]} for steps in steps_by_solve])
    cell = {"name": "x", "config": config or {"nx": 4000, "ny": 4000},
            "traffic": traffic or {"dtype": "float32",
                                   "tally_dtype": "float32"}}
    return harness.Context(cell, rec)


def read(name, ctx):
    return harness.load_reader(name)(ctx)


def test_readers_read_nothing_where_no_census_deposits():
    ctx = context([[({"begin": 0.001, "sweep": 0.2}, 0)]] * 3)
    for name in READERS:
        assert read(name, ctx) is None, name


def test_readers_read_nothing_from_a_program_without_the_stage_phases():
    """A program whose phases have "raster" alone (no stage split) gives
    the three stage metrics nothing; the roofline reads "raster"."""
    ph = {"begin": 0.001, "flight": 0.002, "raster": 0.040, "loop": 0.001}
    ctx = context([[(ph, 7 * 10**9)]])
    for name in READERS[:3]:
        assert read(name, ctx) is None, name
    assert read("deposit_roofline", ctx) is not None


def test_stage_readers_sum_censuses_and_mean_solves():
    other = {**FLIGHT, "raster_bins": 0.010, "raster_tiles": 0.030,
             "raster_overflow": 0.0}
    ctx = context([[(FLIGHT, 1), (other, 1)], [(other, 1), (other, 1)]])
    assert read("deposit_bins_ms", ctx) == pytest.approx((18 + 20) / 2)
    assert read("deposit_tiles_ms", ctx) == pytest.approx((62 + 60) / 2)
    assert read("deposit_overflow_ms", ctx) == pytest.approx(6 / 2)


def test_overflow_reads_zero_where_no_deposit_overflowed():
    ph = {**FLIGHT, "raster_overflow": 0.0}
    assert read("deposit_overflow_ms", context([[(ph, 5)], [(ph, 5)]])) == 0.0


def test_deposit_bound_by_floats_and_by_bytes():
    # 7.04e9 cell visits of 15 float operations over 67 TFLOP/s: 1.576 ms,
    # above the 16M float32 cells written once (19.1 us).
    t = deposit_bound.deposit_seconds(7_040_000_000, 16_000_000, "float32",
                                      "float32")
    assert t == pytest.approx(7.04e9 * 15 / 67e12)
    assert t == pytest.approx(1.5761e-3, rel=1e-4)
    # 1,000 visits in float64 into a float64 tally of 16M cells: the
    # tally's 128 MB over 3.35 TB/s.
    t = deposit_bound.deposit_seconds(1000, 16_000_000, "float64", "float64")
    assert t == pytest.approx(16e6 * 8 / 3.35e12)
    # a float32 state into a float64 tally: the state's float peak, the
    # tally's bytes
    assert deposit_bound.deposit_seconds(
        10**12, 1, "float32", "float64") == pytest.approx(15e12 / 67e12)


def test_deposit_roofline_over_the_raster_phase():
    """Two solves of one census each (7e9 and 1e3 facets) over 36 ms and
    0.5 ms of "raster": the bound of each census summed over the two."""
    small = {**FLIGHT, "raster": 0.0005}
    ctx = context([[({**FLIGHT, "raster": 0.036}, 7 * 10**9)],
                   [(small, 1000)]])
    want = (7e9 * 15 / 67e12 + 16e6 * 4 / 3.35e12) / 0.0365
    assert read("deposit_roofline", ctx) == pytest.approx(100 * want)
    # censuses with no deposit are left out of both sides
    ctx = context([[({**FLIGHT, "raster": 0.036}, 7 * 10**9),
                    ({"begin": 0.001, "sweep": 0.2}, 10**12)]])
    assert read("deposit_roofline", ctx) == pytest.approx(
        100 * 7e9 * 15 / 67e12 / 0.036)


def test_stream_cell_is_found_with_its_limits():
    cell = harness.find_cell("stream.f32")
    assert cell["chips"] == 1
    assert cell["config"]["nparticles"] == 1_000_000
    assert (cell["config"]["nx"], cell["config"]["ny"]) == (4000, 4000)
    assert cell["config"]["iterations"] == 1
    assert cell["traffic"]["dtype"] == "float32"
    per_layer = [m["name"] for m in cell["per_layer"]]
    assert set(READERS) <= set(per_layer)
    assert "raster_ms" not in per_layer
    limits = check.load_limits("stream.f32")
    assert limits["sample"] == "all" and "tally_gap" in limits
    assert set(READERS) <= {m["name"] for m in
                            harness.find_cell("csp.f32")["per_layer"]}
