"""The global tally's read to the host (`census.read_tallies`, which
`Simulation.host_tally` and a one-process decomposition's `host_tally`
run).

A read returns the flat tally as float64, bitwise what
`tally.cpu().numpy().astype(np.float64)` gives, in a block of its own that
a later step leaves as it is.  On a card the conversion runs there and the
copy lands in a pinned block of torch's caching host allocator, which the
next read reuses once the caller has dropped the array
(`profiler.TallyReads` counts reads and fresh blocks).  The CPU tests run
the plain engine on a small deck in every (state, tally) dtype pair; the
`cuda` tests need a card and skip without one:

    python -m pytest tests/test_torch_tally_read.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import census, driver, profiler

PAIRS = [("float32", "float32"), ("float64", "float64"),
         ("float32", "float64"), ("float64", "float32")]


def small_cfg(dtype, tally_dtype, n=300, nx=32):
    """A small dense deck on the sweep transport, lanes crossing cells."""
    return tt.SimConfig(
        nx=nx, ny=nx, width=1.0, height=1.0, dt=1e-7, niters=2,
        nparticles=n, initial_energy=1.0e3,
        source=tt.SourceBox(0.3, 0.3, 0.4, 0.4),
        problems=(tt.ProblemRegion(1.0, 0, 0, 1, 1),),
        dtype=dtype, tally_dtype=tally_dtype)


def old_read(sim):
    """The read as it was: a pageable copy, converted on the host."""
    return sim.tally.cpu().numpy().astype(np.float64)


def bitwise_equal(a, b):
    assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))


@pytest.fixture
def reads(monkeypatch):
    """A fresh record of the process's tally reads."""
    record = profiler.TallyReads()
    monkeypatch.setattr(census, "TALLY_READS", record)
    return record


def test_tally_reads_counts_reads_and_new_addresses():
    record = profiler.TallyReads()
    for address in (64, 64, None, 128, 64):
        record.add(address)
    assert (record.reads, record.fresh) == (5, 2)


@pytest.mark.parametrize("dtype,tally_dtype", PAIRS)
def test_host_tally_is_the_old_read_in_float64(dtype, tally_dtype, reads):
    sim = driver.Simulation(small_cfg(dtype, tally_dtype), device="cpu",
                            quiet=True)
    sim.step(1)
    got = sim.host_tally()
    assert sim.tally.dtype == getattr(torch, tally_dtype)
    assert got.shape == (32 * 32,) and np.abs(got).sum() > 0
    bitwise_equal(got, old_read(sim))
    assert (reads.reads, reads.fresh) == (1, 0)   # no pinned block here


@pytest.mark.parametrize("dtype,tally_dtype", PAIRS)
def test_host_tally_does_not_alias_the_live_tally(dtype, tally_dtype,
                                                  reads):
    sim = driver.Simulation(small_cfg(dtype, tally_dtype), device="cpu",
                            quiet=True)
    sim.step(1)
    first = sim.host_tally()
    kept = first.copy()
    first[:] = -1.0              # the caller's array is the caller's own
    bitwise_equal(sim.host_tally(), kept)
    first[:] = kept
    sim.step(2)
    np.testing.assert_array_equal(first, kept)
    later = sim.host_tally()
    bitwise_equal(later, old_read(sim))
    assert not np.array_equal(later, first)
    assert reads.reads == 3


@pytest.mark.parametrize("decomposition", ["replicated", "spatial2d"])
def test_decomposition_reads_its_tallies_in_one_read(decomposition, reads):
    """A one-process decomposition reads every shard's tally through the
    same read, once a host_tally: float64 partials, bitwise the old read
    of each shard, summed (replicated) or placed (2x2 blocks) as before."""
    cfg = small_cfg("float32", "float32")
    sim = driver.make_simulation(cfg, decomposition, ["cpu"] * 4,
                                 quiet=True)
    sim.step(1)
    parts = sim.shard_tallies()
    assert (reads.reads, reads.fresh) == (1, 0)
    for part, sh in zip(parts, sim.shards):
        bitwise_equal(part, sh.tally.cpu().numpy().astype(np.float64))
    got = sim.host_tally()
    assert reads.reads == 2
    if decomposition == "replicated":
        want = sum(sh.tally.cpu().numpy().astype(np.float64)
                   for sh in sim.shards)
    else:
        want = np.block([[sim.shards[2 * r + c].tally.cpu().numpy()
                          .astype(np.float64).reshape(16, 16)
                          for c in range(2)] for r in range(2)]).reshape(-1)
    bitwise_equal(got, want)
    assert np.abs(got).sum() > 0


# -- on a card ----------------------------------------------------------------

def card_sim(tally_dtype):
    """One census of the small deck on the card (plain engine: no kernel
    library to build), with a tally of `tally_dtype`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim = driver.Simulation(small_cfg("float32", tally_dtype), device="cuda",
                            engine="plain", quiet=True)
    sim.step(1)
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("tally_dtype", ["float32", "float64"])
def test_card_read_is_pinned_and_the_old_read(tally_dtype, reads):
    sim = card_sim(tally_dtype)
    got = sim.host_tally()
    assert torch.from_numpy(got).is_pinned()
    bitwise_equal(got, old_read(sim))
    assert (reads.reads, reads.fresh) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("tally_dtype", ["float32", "float64"])
def test_card_reads_dropped_in_turn_reuse_one_block(tally_dtype, reads):
    sim = card_sim(tally_dtype)
    addresses = []
    for _ in range(5):
        got = sim.host_tally()
        addresses.append(got.ctypes.data)
        del got
    assert len(set(addresses)) == 1
    assert (reads.reads, reads.fresh) == (5, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("tally_dtype", ["float32", "float64"])
def test_card_read_that_is_held_keeps_its_block(tally_dtype, reads):
    sim = card_sim(tally_dtype)
    held = sim.host_tally()
    kept, address = held.copy(), held.ctypes.data
    sim.step(2)
    later = sim.host_tally()
    assert later.ctypes.data != address and held.ctypes.data == address
    np.testing.assert_array_equal(held, kept)
    bitwise_equal(later, old_read(sim))
    assert not np.array_equal(later, held)
    assert (reads.reads, reads.fresh) == (2, 2)
