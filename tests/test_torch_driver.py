"""The port's driver and CLI (neutral_tpu_torch.driver) end to end.

On the CPU the driver runs the plain engine; the CUDA kernel against its
plain version is checked by the `cuda` test below, which needs a card and
skips without one (it mirrors phase 3 of chip_smoke.py).  JAX is imported
only inside the test that compares with it, so that on a machine with a
card and without JAX the `cuda` test runs on its own:

    python -m pytest tests/test_torch_driver.py -q -m cuda --noconftest
"""

import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver, transport
from neutral_tpu_torch.particles import STATE_FIELDS
from neutral_tpu_torch.sweep_kernel import (sweep_chunk_kernel,
                                            sweep_chunk_plain)

DECK = "problems/scatter.params"
SMALL = ["--nparticles", "2000", "--mesh-scale", "62"]


def test_cli_scatter_prints_contract_and_matches_jax():
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver

    out = subprocess.run(
        [sys.executable, "-m", "neutral_tpu_torch", DECK, *SMALL],
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
    deck = tmp_path / "scatter_pcg.params"
    deck.write_text(open(DECK).read() + "rng pcg64si\n")
    with pytest.raises(NotImplementedError, match="pcg64si"):
        driver.Simulation(tt.load_config(str(deck)).with_(nparticles=10))


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
