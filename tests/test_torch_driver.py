"""The port's driver and CLI (neutral_tpu_torch.driver) end to end.

On the CPU the driver runs the plain engine; the CUDA kernels against
their plain versions are checked by the `cuda` tests below, which need a
card and skip without one (they mirror chip_smoke.py's comparisons).
`kernel_matches_plain_on_card` is their shared check, which the other
test_torch_*.py files import.  JAX is imported only inside the test that
compares with it, so that on a machine with a card and without JAX the
`cuda` tests run on their own:

    python -m pytest tests/test_torch_driver.py -q -m cuda --noconftest
"""

import dataclasses
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver, flight, transport
from neutral_tpu_torch.census import flight_chunk_kernel, sweep_chunk_kernel
from neutral_tpu_torch.particles import STATE_FIELDS
from neutral_tpu_torch.sweep_kernel import sweep_chunk_plain

DECK = "problems/scatter.params"
SMALL = ["--nparticles", "2000", "--mesh-scale", "62"]


def _sorted_rows(segs):
    rows = torch.cat(segs).cpu().numpy()
    return rows[np.lexsort(rows.T[::-1])]


def kernel_matches_plain_on_card(cfg, transport_name="auto", window=None):
    """The transport's kernel and its plain version from one begin_timestep
    state of `cfg` on the card: equal facet and collision counts, all 14
    per-lane fields (bitwise in float64) and (flight) the sorted segment
    rows; tally sums to 1e-5 in float32 and 1e-12 in float64 (the kernels'
    atomics add in another order).  `window` = (x_off,
    y_off, nx, ny) runs both in that spatial window, with window-local
    tallies and segments; the lanes outside it must come out untouched.
    Skips without a card.  Returns the simulation and the (facets,
    collisions) counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim = driver.Simulation(cfg, device="cuda", engine="plain",
                            transport=transport_name, quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    geom, win = sim.geom, {}
    if window is not None:
        x_off, y_off, nx, ny = window
        geom = dataclasses.replace(geom, nx=nx, ny=ny)
        win = {"x_off": x_off, "y_off": y_off}
    args = (geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    kt = torch.zeros(geom.nx * geom.ny, dtype=sim.tally.dtype, device="cuda")
    pt = torch.zeros_like(kt)
    f64 = sim.dtype == torch.float64
    if sim.transport == "flight":
        ksegs, psegs = [], []
        ks, knf, knc, _, _ = flight_chunk_kernel(start.clone(), kt, *args,
                                                 segments=ksegs, **win)
        ps, pnf, pnc, _, _ = flight.flight_chunk_plain(
            start.clone(), pt, *args, segments=psegs, **win)
        np.testing.assert_array_equal(_sorted_rows(ksegs),
                                      _sorted_rows(psegs))
    else:
        ks, knf, knc, _ = sweep_chunk_kernel(start.clone(), kt, *args, **win)
        ps, pnf, pnc, _ = sweep_chunk_plain(start.clone(), pt, *args, **win)
    assert (knf, knc) == (pnf, pnc) and knf > 0
    for f in STATE_FIELDS:
        a, b = getattr(ks, f), getattr(ps, f)
        if a.dtype == torch.float64:          # bitwise
            a, b = a.view(torch.int64), b.view(torch.int64)
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(), f)
    if window is not None:
        _, _, inside = transport.window_cells(start, geom, **win)
        outside = ~inside
        assert bool(outside.any()) and bool(inside.any())
        for f in STATE_FIELDS:
            assert torch.equal(getattr(ks, f)[outside],
                               getattr(start, f)[outside]), f
    ksum, psum = float(kt.double().sum()), float(pt.double().sum())
    assert abs(ksum - psum) <= (1e-12 if f64 else 1e-5) * abs(psum)
    return sim, (knf, knc)


def test_cli_scatter_prints_contract_and_matches_jax():
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver

    out = subprocess.run(
        [sys.executable, "-m", "neutral_tpu_torch", DECK, *SMALL,
         "--device", "cpu"],
        capture_output=True, text=True, check=True, timeout=300).stdout
    for line in ("Iteration  1", "Iteration  2", "Step time", "Wallclock",
                 "Facets", "Collisions", "Facet Events / s",
                 "Collision Events / s", "Final Wallclock",
                 "Elapsed Simulation Time", "PROFILING RESULTS:"):
        assert line in out, line
    assert "Engine: plain." in out
    assert "event sweeps" in out
    total = float(re.search(r"Final global_energy_tally (\S+)", out)[1])

    # The same cut-down deck on the JAX XLA engine.  float64 is the
    # yardstick: JAX's own float32 tally sits ~2e-4 from it on this deck
    # (tests/test_torch_transport.py), the port's float32 within 1e-4.
    cfg = nt.load_config(DECK).with_(
        nparticles=2000, nx=64, ny=64, expected_tally=None, engine="xla",
        dtype="float64", tally_dtype="float64")
    ref = jdriver.Simulation(cfg, quiet=True).run()
    assert total == pytest.approx(3.41e-2, rel=0.05)
    assert abs(total - ref) <= 1e-4 * abs(ref)


def test_engine_kernel_on_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        driver.main([DECK, *SMALL, "--engine", "kernel", "--device", "cpu"])


def test_pcg64si_deck_raises(tmp_path):
    """A pcg64si deck runs (its geometry carries the scheme); a deck with
    an unknown scheme raises before any state is built."""
    deck = tmp_path / "scatter_pcg.params"
    deck.write_text(open(DECK).read() + "rng pcg64si\n")
    cfg = tt.load_config(str(deck)).with_(nparticles=10, nx=16, ny=16)
    assert driver.Simulation(cfg, device="cpu",
                             quiet=True).geom.rng_scheme == "pcg64si"
    with pytest.raises(ValueError, match="unknown rng scheme"):
        driver.Simulation(cfg.with_(rng="mt19937"), device="cpu", quiet=True)


@pytest.mark.parametrize("engine,device,dtype,want", [
    ("auto", "cuda", torch.float32, "kernel"),
    ("auto", "cuda", torch.float64, "kernel"),
    ("auto", "cpu", torch.float32, "plain"),
    ("auto", "cpu", torch.float64, "plain"),
    ("plain", "cuda", torch.float32, "plain"),
    ("kernel", "cuda", torch.float32, "kernel"),
])
def test_pick_engine_routes_by_device_and_dtype(engine, device, dtype, want):
    """`auto` takes the kernels on CUDA, in float32 and in float64 (the
    sweep and begin kernels' float64 instantiations); the CPU runs the
    plain engine."""
    assert driver.pick_engine(engine, torch.device(device), dtype) == want


@pytest.mark.parametrize("device,match", [("cuda", "float32"),
                                          ("cpu", "CUDA")])
def test_engine_kernel_float64_raises_before_state(device, match):
    """--engine kernel with float64 on the flight transport raises in
    Simulation.__init__, before any tensor is made on the device, where
    no kernel runs it: on the CPU.  On CUDA the kernel engine takes it,
    as `auto` does, with a float64 tally (the flight and segment-deposit
    kernels' float64 instantiations) and beside a float32 tally (`match`:
    their mixed instantiations)."""
    cfg = tt.load_config(DECK).with_(dtype="float64", tally_dtype="float64")
    if device == "cuda":
        for tally in ("float64", match):
            for engine in ("kernel", "auto"):
                assert driver.pick_engine(
                    engine, torch.device("cuda"), torch.float64,
                    cfg.with_(tally_dtype=tally)) == "kernel"
        return
    with pytest.raises(ValueError, match=match):
        driver.Simulation(cfg, device=device, engine="kernel",
                          transport="flight")
    with pytest.raises(ValueError, match=match):
        driver.main([DECK, "--dtype", "float64", "--engine", "kernel",
                     "--transport", "flight", "--device", device])


def test_kernel_wrapper_on_cpu_runs_plain_version():
    """The kernel's wrapper does not run the plain version for a CPU state:
    it raises and launches nothing.  Choosing the plain version is the
    driver's (`engine`), and on the CPU the driver runs it itself."""
    cfg = tt.load_config(DECK).with_(nparticles=500, nx=64, ny=64)
    sim = driver.Simulation(cfg, device="cpu", quiet=True)
    assert sim.engine == "plain"
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    args = (sim.geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    kt = torch.zeros_like(sim.tally)
    launches0 = sweep_chunk_kernel.launches
    calls0 = sweep_chunk_plain.calls
    with pytest.raises(ValueError, match="CUDA"):
        sweep_chunk_kernel(start.clone(), kt, *args)
    assert sweep_chunk_kernel.launches == launches0
    assert sweep_chunk_plain.calls == calls0
    assert not kt.any()


@pytest.mark.cuda
@pytest.mark.parametrize("max_events", [4096, 64])
def test_kernel_matches_plain_on_card(max_events):
    """Kernel and plain version from one begin_timestep state, on CUDA:
    equal event counts and all 14 per-lane state fields, tally sums to 1e-5 (the
    kernel's atomics add in another order).  max_events=64 splits each
    census over many launches, which must change nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tt.load_config(DECK).with_(nparticles=65536)
    sim = driver.Simulation(cfg, device="cuda", engine="plain", quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    args = (sim.geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    kt, pt = torch.zeros_like(sim.tally), torch.zeros_like(sim.tally)
    ks, knf, knc, launches = sweep_chunk_kernel(start.clone(), kt, *args,
                                                max_events=max_events)
    ps, pnf, pnc, _ = sweep_chunk_plain(start.clone(), pt, *args)
    assert (knf, knc) == (pnf, pnc)
    assert launches > 1 if max_events == 64 else launches == 1
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ks, f).cpu().numpy(),
                                      getattr(ps, f).cpu().numpy())
    ksum, psum = float(kt.double().sum()), float(pt.double().sum())
    assert abs(ksum - psum) <= 1e-5 * abs(psum)


@pytest.mark.cuda
def test_float64_deck_auto_runs_plain_on_card(capsys):
    """A float64 deck under --engine auto on a CUDA device runs the float64
    sweep and begin kernels (no plain sweep or begin) and prints a finite
    tally."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from neutral_tpu_torch.begin_kernel import begin_timestep_kernel

    sweep0, plain0 = sweep_chunk_kernel.launches, sweep_chunk_plain.calls
    begin0 = begin_timestep_kernel.launches
    calls0 = transport.begin_timestep.calls
    assert driver.main([DECK, "--dtype", "float64", "--nparticles",
                        "65536"]) == 0
    out = capsys.readouterr().out
    assert "Engine: kernel." in out and "Transport: sweep." in out
    assert sweep_chunk_kernel.launches > sweep0
    assert begin_timestep_kernel.launches == begin0 + 2
    assert (sweep_chunk_plain.calls, transport.begin_timestep.calls) == (
        plain0, calls0)
    total = float(re.search(r"Final global_energy_tally (\S+)", out)[1])
    assert np.isfinite(total) and total > 0.0


def strips_cfg(n=65536):
    """The stream deck's geometry cut into 20 vertical strips of
    alternating near-vacuum and dense material: 20 regions and 20 rects,
    past the former 16-region limit of the kernels."""
    strips = tuple(tt.ProblemRegion(1.0e-30 if i % 2 else 1.0e3 * (i + 1),
                                    i / 20, 0.0, 1 / 20, 1.0)
                   for i in range(20))
    return tt.load_config("problems/stream.params").with_(
        nparticles=n, problems=strips, expected_tally=None,
        initial_energy=1.0e4)


@pytest.mark.cuda
@pytest.mark.parametrize("transport_name", ["sweep", "flight"])
def test_20_strip_deck_kernel_matches_plain_on_card(transport_name):
    sim, _ = kernel_matches_plain_on_card(strips_cfg(), transport_name)
    assert len(sim.geom.regions) == 20 and len(sim.geom.rects) == 20
