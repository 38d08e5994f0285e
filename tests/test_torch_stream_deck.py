"""The upstream stream deck as the benchmark runs it (portbench's `stream`
configuration), and the segment deposit's accounting that its cell reads.

On the CPU: the port's `Simulation` (the plain flight transport) against
the benchmark's plain reference (`portbench/reference/engine.py`) on the
deck shrunk to a 48 x 48 mesh and 2,000 particles, with the deck's
energy, density and dt: ~84 facets a history, reflecting at the edges.
The counts agree exactly, the lanes to `check.TOLERANCES`, the tally cell
by cell; the float32 tally's sum stays within float32's floor of the
float64 reference's, so the deck's 1e-30 density does not underflow.  The
configuration file is the upstream's deck key by key.  The deposit's
device phases (`flight_kernel.event_phases`) and the overflow's re-run
(`flight_kernel.after_round`) are checked with stand-in events.  On the
card only: the deposit's stages add up to its phase, and a deposit forced
to overflow is timed and counted as a re-run.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neutral_tpu_torch import driver, flight_kernel
from neutral_tpu_torch.params import parse_params
from neutral_tpu_torch.raster_kernel import SegmentDeposit
from portbench import check, harness
from portbench.reference import engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "portbench", "configs", "stream.json")
SHRUNK = dict(nx=48, ny=48, nparticles=2000)
SEED = 2**33 + 7


def deck_config(**over) -> dict:
    with open(CONFIG) as f:
        return {**json.load(f), **over}


def solve_both(dtype: str, seed: int = SEED):
    """The shrunk deck's replica 0 of `seed` through the port on the CPU
    (harness.solve, every particle and the whole tally kept) and through
    the float64 reference."""
    config = deck_config(**SHRUNK)
    traffic = {"dtype": dtype, "tally_dtype": dtype, "transport": "flight"}
    cfg = harness.sim_config(config, traffic)
    pids = np.arange(cfg.nparticles, dtype=np.int64)
    port = harness.solve(torch.device("cpu"), cfg, traffic, seed, 0,
                         keep={"pids": pids, "grid": True})
    deck = engine.Deck.from_dict(config)
    ref = engine.solve(deck, torch.as_tensor(pids),
                       [check.master_key(seed, 0, 1)], grid=True)
    return port, ref


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_shrunk_stream_matches_the_reference(dtype):
    port, ref = solve_both(dtype)
    assert (port["transport"], port["engine"]) == ("flight", "plain")
    kept = port["kept"]
    # one census: every lane live, ~84 facets each, no collision
    live, facets, collisions = kept["steps"][0]
    assert (live, facets, collisions) == (int(ref.live[0].sum()),
                                          int(ref.facets[0].sum()),
                                          int(ref.collisions[0].sum()))
    assert collisions == 0 and 60 * live < facets < 120 * live
    lanes = ref.lanes.numpy()
    rows, once = check.align(kept["rows"], lanes["pid"])
    assert once.all()
    off = check.departs(rows, {f: lanes[f] for f in check.FIELDS},
                        check.TOLERANCES[dtype], 1.0)
    assert not off.any()
    got, want = kept["tally"], ref.tally.numpy()
    total = want.sum()
    assert total > 0
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * total)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=check.TALLY_FLOOR[dtype] * total)


def test_float32_tally_of_the_near_vacuum_does_not_underflow():
    """The deck's density of 1e-30 leaves each cell a tally of ~2.5e-27
    here (~3.6e-31 on the 4000 x 4000 mesh): the float32 tally's cells are
    nonzero where the reference's are, and its sum and its cell-by-cell
    gap lie within float32's tally floor of the float64 reference's."""
    port, ref = solve_both("float32", SEED + 1)
    got, want = port["kept"]["tally"], ref.tally.numpy()
    assert got.sum() > 0 and (got > 0).sum() == (want > 0).sum()
    assert abs(got.sum() - want.sum()) <= (check.TALLY_FLOOR["float32"]
                                           * want.sum())
    assert np.abs(got - want).sum() <= check.TALLY_FLOOR["float32"] * (
        want.sum())


def test_config_is_the_upstream_deck():
    deck = parse_params(os.path.join(ROOT, "problems", "stream.params"))
    config = deck_config()
    for key in ("nparticles", "nx", "ny", "iterations"):
        assert config[key] == deck.get_int(key), key
    for key in ("initial_energy", "dt"):
        assert config[key] == deck.get_double(key), key
    assert dict(deck.get_key_value("source")) == config["source_box"]
    problems = deck.problem_entries()
    assert len(problems) == len(config["problems"]) == 1
    for entry, region in zip(problems, config["problems"]):
        entry = dict(entry)
        assert {k: entry[k] for k in region} == region
    assert (config["width"], config["height"]) == (1.0, 1.0)
    assert (config["rng"], config["fast_math"]) == ("threefry", 1)
    assert config["reduced"] == [] and config["assumed"] == {}
    # the SimConfig the benchmark builds is the CLI's for the deck
    cli = driver.load_config(os.path.join(ROOT, "problems", "stream.params"))
    bench = harness.sim_config(config, {"dtype": cli.dtype,
                                        "tally_dtype": cli.tally_dtype})
    for f in ("nx", "ny", "dt", "niters", "nparticles", "initial_energy",
              "width", "height", "source", "problems", "rng", "fast_math"):
        assert getattr(bench, f) == getattr(cli, f), f


# -- the deposit's accounting, with stand-in events ---------------------------

class Mark:
    """A CUDA event's stand-in, recorded at `ms` milliseconds."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms

    def synchronize(self):
        """Recorded already: nothing to wait for."""


def round_marks(t0, flight, bins, tiles, overflow=False):
    """A flight round's marks: the flight launch, then the deposit's bins
    and tiles, each lasting the milliseconds given."""
    a, b = Mark(t0), Mark(t0 + flight)
    c, d = Mark(t0 + flight + bins), Mark(t0 + flight + bins + tiles)
    return {"flight": (a, b), "deposit": (b, c, d), "overflow": overflow}


def test_event_phases_split_the_deposit_and_its_overflow():
    """Two rounds, the first of whose deposits overflowed (its bins ran,
    its tiles returned at once) and was re-run: "raster" holds all three
    deposit launches, its bins and tiles add up to it, and
    "raster_overflow" holds the overflowed launch alone."""
    rerun = round_marks(10.0, 0.0, 2.0, 7.0)
    del rerun["flight"]
    marks = [round_marks(0.0, 0.5, 1.5, 0.25, overflow=True), rerun,
             round_marks(20.0, 0.25, 0.5, 1.0)]
    ph = flight_kernel.event_phases(marks)
    assert ph["flight"] == pytest.approx(0.75e-3)
    assert ph["raster"] == pytest.approx(12.25e-3)
    assert ph["raster_bins"] == pytest.approx(4.0e-3)
    assert ph["raster_tiles"] == pytest.approx(8.25e-3)
    assert ph["raster_bins"] + ph["raster_tiles"] == pytest.approx(
        ph["raster"])
    assert ph["raster_overflow"] == pytest.approx(1.75e-3)
    records = flight_kernel.launch_records([{"lanes": 3, "marks": marks[0]}])
    assert records == [{"lanes": 3, "flight_ms": 0.5}]


def test_after_round_reruns_an_overflowed_deposit_in_its_span(monkeypatch):
    """A round whose deposit overflowed: its marks are flagged, the
    re-run's marks follow in `marks`, inside nt.flight.redeposit, and the
    record carries the deposit's pieces and the overflow."""
    reruns = []

    def redeposit(tally, buffers, geom, need):
        reruns.append(need)
        rerun = round_marks(5.0, 0.0, 1.0, 1.0)
        del rerun["flight"]
        return rerun

    monkeypatch.setattr(flight_kernel, "redeposit", redeposit)
    buffers = flight_kernel.FlightBuffers(64, 64, "cpu")
    first = round_marks(0.0, 0.5, 1.0, 0.0)
    rec, marks = {"marks": first}, [first]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        flight_kernel.after_round(buffers, torch.zeros(64 * 64), None, rec,
                                  [4, 10, 3000, 1], marks)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("nt.flight.redeposit") == 1
    assert reruns == [3000] and len(marks) == 2 and first["overflow"]
    assert {k: rec[k] for k in ("working", "deposit_pieces", "overflow")} == {
        "working": 4, "deposit_pieces": 3000, "overflow": True}
    rec = {"marks": round_marks(0.0, 0.5, 1.0, 1.0)}
    flight_kernel.after_round(buffers, torch.zeros(64 * 64), None, rec,
                              [0, 10, 200, 0], marks)
    assert len(marks) == 2 and reruns == [3000]
    assert (rec["deposit_pieces"], rec["overflow"]) == (200, False)
    assert not rec["marks"]["overflow"]


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_deposit_stages_and_a_forced_overflow_on_card():
    """Stream at 100,000 particles on its 4000 x 4000 mesh through the
    flight kernel, twice on the same key: with the deposit's own piece
    buffer, and with one of 64 pieces, so that the deposit overflows and
    is re-run.  In each, the bins and tiles add up to "raster"; the forced
    run counts its re-run(s) in `noverflows`, times the overflowed launches
    in "raster_overflow" (more than zero, less than "raster") and ends
    with the same counts and, to float32 rounding, the same tally."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    traffic = {"dtype": "float32", "tally_dtype": "float32",
               "transport": "flight"}
    cfg = harness.sim_config(deck_config(nparticles=100_000), traffic)
    out = []
    for pieces in (None, 64):
        sim = driver.Simulation(cfg, device="cuda", quiet=True)
        assert (sim.engine, sim.transport) == ("kernel", "flight")
        if pieces is not None:
            sim.shards[0].buffers.deposit = SegmentDeposit(
                cfg.nx, cfg.ny, sim.device, pieces=pieces,
                dtype=torch.float32, tally_dtype=torch.float32)
        m = sim.step(check.master_key(SEED, 0, 1))
        ph = m.phases
        assert ph["raster_bins"] > 0 and ph["raster_tiles"] > 0
        assert ph["raster_bins"] + ph["raster_tiles"] == pytest.approx(
            ph["raster"], rel=1e-5)
        assert m.noverflows == sum(r["overflow"] for r in m.rounds)
        assert all(r["deposit_pieces"] > 0 for r in m.rounds)
        out.append((m, sim.host_tally()))
    (plain, t0), (forced, t1) = out
    assert forced.noverflows >= 1
    assert 0 < forced.phases["raster_overflow"] < forced.phases["raster"]
    assert forced.rounds[0]["overflow"]
    assert (forced.nfacets, forced.ncollisions) == (plain.nfacets,
                                                     plain.ncollisions)
    np.testing.assert_allclose(t1, t0, rtol=0, atol=1e-5 * np.abs(t0).max())
