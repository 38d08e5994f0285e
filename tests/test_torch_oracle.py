"""The port's sequential oracle (neutral_tpu_torch.oracle) and its
pure-Python draws, against the JAX package's, and the port's plain engine
against it.

The oracle tracks one history at a time in float64 with the reference's
control flow.  The port's copy must give JAX's `neutral_tpu.oracle` the
same counts and bitwise the same tally on the four deck families of
tests/test_transport.py, and the port's plain engine in float64 must
reproduce it as tests/test_transport.py holds JAX's engine: per-step
facet, collision and processed counts exactly, the tally to 1e-9, the
dead flags equal.  The flight transport deposits whole segments, so its
tally is held to JAX's flight-against-stepping tolerances
(tests/test_flight.py: the sum to 1e-11, each cell to 1e-7).  The card
runs the same comparison without JAX in chip_smoke.py's phase 22.
"""

import dataclasses
import functools

import numpy as np
import pytest

import neutral_tpu.rng as jrng
import neutral_tpu_torch as tt
from neutral_tpu_torch import driver, oracle
from neutral_tpu_torch import rng as trng

from test_pcg import VECS
from test_rng import KAT
from test_transport import make_problem, run_oracle

FAMILIES = ["scatter", "stream", "csp", "split"]


def port_problem(kind: str) -> tt.SimConfig:
    """tests/test_transport.py's deck family as the port's SimConfig."""
    j = make_problem(kind)
    return tt.SimConfig(
        nx=j.nx, ny=j.ny, width=j.width, height=j.height, dt=j.dt,
        niters=j.niters, nparticles=j.nparticles,
        initial_energy=j.initial_energy,
        source=tt.SourceBox(*dataclasses.astuple(j.source)),
        problems=tuple(tt.ProblemRegion(*dataclasses.astuple(p))
                       for p in j.problems),
        dtype="float64", tally_dtype="float64")


@functools.cache
def run_port_oracle(kind: str):
    return oracle.run_config(port_problem(kind))


def test_threefry_py_matches_kats_and_jax():
    """Random123's known answers, and JAX's draws on the same keys."""
    for (pk, mk, c), want in KAT:
        assert trng.threefry2x64_py((c, 0), (pk, mk)) == want
        assert trng.uniform2_py(pk, mk, c) == jrng.uniform2_py(pk, mk, c)
    for rounds in (1, 4, 13, 20):
        assert (trng.threefry2x64_py((5, 6), (7, 8), rounds)
                == jrng.threefry2x64_py((5, 6), (7, 8), rounds))


def test_pcg64si_py_matches_kats_and_jax():
    """pcg_variants.h's known answers, and JAX's pair draws."""
    for seed, a, b in VECS:
        assert trng.pcg64si_pair_py(seed) == (a, b)
        assert trng.pcg64si_py(seed) == a
        assert trng.pcg64si_py((seed + 1) % 2**64) == jrng.pcg64si_py(
            (seed + 1) % 2**64)
    for pid, mk, c in [(0, 0, 0), (7, 1, 3), (999, 2, 17), (2**40, 9, 5)]:
        assert trng.uniform2_pcg_py(pid, mk, c) == jrng.uniform2_pcg_py(
            pid, mk, c)


@pytest.mark.parametrize("kind", FAMILIES)
def test_oracle_matches_jax_oracle(kind):
    """Same counts per step, the tally and the end states bitwise."""
    jt, jstats, jparts = run_oracle(make_problem(kind))
    tally, stats, parts = run_port_oracle(kind)
    assert stats == jstats
    assert tally.sum() != 0.0
    np.testing.assert_array_equal(tally, jt)
    assert ([dataclasses.astuple(p) for p in parts]
            == [dataclasses.astuple(p) for p in jparts])


@pytest.mark.parametrize("transport", ["sweep", "flight"])
@pytest.mark.parametrize("kind", FAMILIES)
def test_plain_engine_matches_oracle_f64(kind, transport):
    """The port's plain engine in float64 on the CPU against the port's
    oracle: counts exact per step, the tally to 1e-9 (flight: the sum to
    1e-11, each cell to 1e-7), dead flags equal."""
    sim = driver.Simulation(port_problem(kind), device="cpu",
                            transport=transport, quiet=True)
    assert sim.engine == "plain"
    stats = [dict(nf=m.nfacets, nc=m.ncollisions, nproc=m.nprocessed)
             for m in (sim.step(t) for t in range(1, sim.cfg.niters + 1))]
    tally, ostats, parts = run_port_oracle(kind)
    assert stats == ostats
    got = sim.host_tally().reshape(tally.shape)
    if transport == "sweep":
        np.testing.assert_allclose(got, tally, rtol=1e-9, atol=1e-300)
    else:
        np.testing.assert_allclose(got.sum(), tally.sum(), rtol=1e-11)
        np.testing.assert_allclose(got, tally, rtol=1e-7, atol=1e-30)
    np.testing.assert_array_equal(sim.state.dead.numpy(),
                                  [p.dead for p in parts])
