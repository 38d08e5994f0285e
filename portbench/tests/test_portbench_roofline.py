"""The census roofline's counts on hand-counted inputs."""

import pytest

from portbench import roofline


def test_a_draw_bound_census():
    # 1000 live lanes, 10 facets, 10,000 collisions, 100 deaths, threefry:
    # draws 1000 + 20,000 - 100 = 20,900 of 150 operations each.
    t = roofline.census_seconds(1000, 10, 10_000, 100, 1000, "float32",
                                "threefry")
    assert t == pytest.approx(20_900 * 150 / (132 * 64 * 1.98e9))


def test_a_byte_bound_census():
    # 1e6 live of 2e6 lanes, no events: (61 + 53) bytes a live lane, one a
    # dead one; the draws' 1e6 x 150 operations take less.
    t = roofline.census_seconds(10**6, 0, 0, 0, 2 * 10**6, "float32",
                                "threefry")
    assert roofline.LANE_READ["float32"] == 61
    assert roofline.LANE_WRITE["float32"] == 53
    assert t == pytest.approx(max((114e6 + 1e6) / 3.35e12,
                                  150e6 / (132 * 64 * 1.98e9)))


def test_a_float_bound_census_in_float64():
    # 1e9 facets a census at 15 operations over 34 TFLOP/s, each float64
    # operation counted once; no draw beyond the lanes'.
    t = roofline.census_seconds(1, 10**9, 0, 0, 1, "float64", "pcg64si")
    assert t == pytest.approx(15e9 / 34e12)


def test_a_solve_takes_deaths_from_the_next_census_and_writes_the_tally():
    steps = [(100, 0, 1000), (60, 0, 500)]
    want = (16 * 4 / 3.35e12
            + roofline.census_seconds(100, 0, 1000, 40, 100, "float32",
                                      "threefry")
            + roofline.census_seconds(60, 0, 500, 60, 100, "float32",
                                      "threefry"))
    assert roofline.solve_seconds(steps, 100, 16, "float32", "float32",
                                  "threefry") == pytest.approx(want)
