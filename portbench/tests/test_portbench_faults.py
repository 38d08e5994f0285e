"""The check comes out false where it must: the control (the reference in
bfloat16 in the program's place, or the program's float32 path for a
float64 cell) and a run of a cell with its timed path broken underneath,
once for each fault the cell can have.  CPU, tiny sizes."""

import pytest

from portbench import check, control, harness

TINY = dict(nx=40, ny=40, nparticles=300)
SEED = 2**31 + 7


def run(cell: dict, **over) -> dict:
    return harness.run_cell(cell, SEED, 0.2, False, device="cpu",
                            config_override={**TINY, **over})


@pytest.mark.parametrize("name,over", [("scatter.f32", {}),
                                       ("csp.f32", {"iterations": 3}),
                                       ("csp.f64", {"iterations": 3})])
def test_the_control_fails_and_the_program_passes(name, over):
    cell = harness.find_cell(name)
    limits = check.load_limits(name)
    rows = control.readings([cell], [SEED], "cpu",
                            config_override={**TINY, **over})
    program, ctrl = rows
    assert program["kind"] == "program" and ctrl["kind"] == "control"
    names = check.compared(limits)
    assert all(program[k] <= limits[k] for k in names), program
    assert any(not ctrl[k] <= limits[k] for k in names), ctrl


@pytest.mark.parametrize("name", ["scatter.f32", "csp.f32"])
@pytest.mark.parametrize("fault", control.FAULTS)
def test_a_broken_census_is_caught(name, fault):
    undo = control.plant(fault)
    try:
        over = {"iterations": 3} if name.startswith("csp") else {}
        assert run(harness.find_cell(name), **over)["correct"] is False
    finally:
        control.unplant(undo)


@pytest.mark.parametrize("name", ["csp.f32", "csp.f64"])
def test_faults_read_above_the_limits(name):
    cell = harness.find_cell(name)
    limits = check.load_limits(name)
    rows = control.fault_readings([cell], [SEED], "cpu",
                                  config_override={**TINY, "iterations": 3})
    assert [r["kind"] for r in rows] == list(control.FAULTS)
    for r in rows:
        assert any(not r[k] <= limits[k] for k in check.compared(limits)), r
    tally = rows[control.FAULTS.index("altered_tally")]
    assert tally["tally_gap"] == pytest.approx(0.1, rel=1e-3)


def test_cells_of_one_deck_share_the_reference():
    cells = [harness.find_cell(n) for n in ("csp.f32", "csp.f64")]
    rows = control.readings(cells, [SEED, SEED + 1], "cpu", controls=1,
                            config_override={**TINY, "iterations": 2})
    assert [(r["cell"], r["kind"]) for r in rows] == [
        ("csp.f32", "program"), ("csp.f32", "control"),
        ("csp.f64", "program"), ("csp.f64", "control"),
        ("csp.f32", "program"), ("csp.f64", "program")]
    with pytest.raises(AssertionError):
        control.readings([cells[0], harness.find_cell("scatter.f32")],
                         [SEED], "cpu", config_override=TINY)


def test_a_tally_altered_by_a_hundredth_is_caught():
    """With every particle compared, the whole tally's gap reads the
    alteration itself, far below the 10% that control.py plants."""
    cell = harness.find_cell("csp.f64")
    limits = check.load_limits("csp.f64")
    over = {**TINY, "iterations": 3}
    deck, ref = control.reference(cell, SEED, "cpu", config_override=over)
    kept = control.solve_once(cell, SEED, "cpu", over)
    kept["tally"] = kept["tally"] * 1.01
    got = control.numbers(cell, deck, kept, ref)
    assert got["tally_gap"] == pytest.approx(0.01, rel=1e-3)
    assert got["tally_gap"] > limits["tally_gap"]

