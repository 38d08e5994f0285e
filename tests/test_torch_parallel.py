"""The port's decomposed runs (neutral_tpu_torch.parallel) against
single-device runs of the port and of the JAX package.

Each decomposition runs 4 shards on the CPU (`devices=["cpu"] * 4`, the
counterpart of the JAX tests' virtual devices) in float64 on a
scatter-like deck (sweep transport) and a csp-like one (flight
transport).  Histories are keyed by pid, so every run must give the
single-device run's per-step event counts exactly and its tally to 1e-12
(summation order); a spatial flight run is held to a single-device run
over `flight.split_rects` at the shard grid lines, as
tests/test_spatial_flight.py holds JAX's.  Also here: migration into
shards that start empty, the deck variants under 2D blocks, the grid
factorisation, per-shard injection, the device defaults, the CLI, and the
rule that nothing of the port imports JAX.  The `cuda` test runs a
decomposition on the card and skips without one:

    python -m pytest tests/test_torch_parallel.py -q -m cuda --noconftest
"""

import dataclasses
import functools
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver, flight
from neutral_tpu_torch.parallel import (ShardedSimulation,
                                        Spatial2DSimulation,
                                        SpatialSimulation, factor_grid)
from neutral_tpu_torch.particles import STATE_FIELDS, inject_particles
from neutral_tpu_torch.xs import resonance_log_table, write_cs_file

CLASSES = {"replicated": ShardedSimulation, "spatial": SpatialSimulation,
           "spatial2d": Spatial2DSimulation}
CPU4 = ["cpu"] * 4


def make_cfg(pkg, kind, **kw):
    """32x32 decks in float64, small enough for the plain engine on four
    shards: `scatter` (dense, sweep transport) and `csp` (a dense block in
    near-vacuum, flight transport), both with lanes crossing the shards'
    boundaries in both steps."""
    P, S = pkg.ProblemRegion, pkg.SourceBox
    base = {
        "scatter": dict(dt=1e-7, nparticles=300, initial_energy=1.0e3,
                        source=S(0.3, 0.3, 0.4, 0.4),
                        problems=(P(1.0, 0, 0, 1, 1),
                                  P(10.0, 0.6, 0.6, 0.2, 0.2))),
        "csp": dict(dt=2e-7, nparticles=200, initial_energy=1.0e4,
                    source=S(0.15, 0.15, 0.2, 0.2),
                    problems=(P(1.0e-6, 0, 0, 1, 1),
                              P(3.0, 0.4, 0.4, 0.2, 0.2))),
        "stream": dict(dt=1e-7, nparticles=400, initial_energy=1.0e6,
                       source=S(0.4, 0.05, 0.2, 0.1),
                       problems=(P(1.0e-2, 0, 0, 1, 1),)),
    }[kind]
    base.update(nx=32, ny=32, niters=2, dtype="float64",
                tally_dtype="float64")
    base.update(kw)
    return pkg.SimConfig(**base)


def cuts(sim):
    """The shard grid lines of a spatial run, as (xcuts, ycuts)."""
    return (tuple(sim.cols * k for k in range(1, sim.px)),
            tuple(sim.rows * k for k in range(1, sim.py)))


def stats_of(sim):
    return [(m.nfacets, m.ncollisions, m.nprocessed)
            for m in (sim.step(t) for t in range(1, sim.cfg.niters + 1))]


@functools.cache
def run_single(kind, xcuts=(), ycuts=(), transport_name="auto"):
    """The port's single-device run, with the rects split at the cuts."""
    sim = driver.Simulation(make_cfg(tt, kind), device="cpu",
                            transport=transport_name, quiet=True)
    if sim.transport == "flight":
        # the census runs over its one shard's geometry
        sim.shards[0].geom = dataclasses.replace(
            sim.geom, rects=flight.split_rects(sim.geom.rects, xcuts, ycuts))
    stats = stats_of(sim)
    return sim.host_tally(), stats, alive_pids(sim.state)


@functools.cache
def run_jax(kind, xcuts=(), ycuts=()):
    """JAX's single-device Simulation: the XLA stepping engine, or the
    flight engine over the split rects."""
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver
    from neutral_tpu.flight import split_rects

    engine = "flight" if kind == "csp" else "xla"
    sim = jdriver.Simulation(make_cfg(nt, kind).with_(engine=engine),
                             quiet=True)
    if engine == "flight":
        sim.geom = dataclasses.replace(
            sim.geom, rects=split_rects(sim.geom.rects, xcuts, ycuts))
    return stats_of(sim)


def alive_pids(state):
    return np.sort(state.pid[~state.dead].cpu().numpy())


def shard_pids(sim):
    """The pids of every shard's live lanes, sorted."""
    return np.sort(np.concatenate([alive_pids(sh.state)
                                   for sh in sim.shards]))


def assert_owned(sim):
    """Every live lane sits on its owner shard."""
    for s, sh in enumerate(sim.shards):
        live = ~sh.state.dead
        owner = sim.owner(sh.state.cellx[live], sh.state.celly[live])
        assert bool((owner == s).all())


@pytest.mark.parametrize("kind", ["scatter", "csp"])
@pytest.mark.parametrize("decomposition", list(CLASSES))
def test_decomposition_matches_single_device(decomposition, kind):
    """Four shards against the port's and JAX's single-device runs: counts
    exact per step, the tally to 1e-12, every surviving pid once.  csp runs
    on the flight transport, asked for by name (`auto` gives float64 decks
    the sweep transport, as JAX's is_f32 rule does)."""
    want = {"scatter": "sweep", "csp": "flight"}[kind]
    sim = CLASSES[decomposition](make_cfg(tt, kind), devices=CPU4,
                                 transport=want, quiet=True)
    assert sim.engine == "plain" and sim.nshards == 4
    assert sim.transport == want
    stats = stats_of(sim)
    split = (cuts(sim) if decomposition != "replicated"
             and sim.transport == "flight" else ((), ()))
    tally, single_stats, pids = run_single(kind, *split, transport_name=want)
    assert stats == single_stats
    assert stats[1][1] > 0 and stats[1][0] > 0
    np.testing.assert_allclose(sim.host_tally(), tally, rtol=1e-12,
                               atol=1e-300)
    assert stats == run_jax(kind, *split)
    np.testing.assert_array_equal(shard_pids(sim), pids)
    if decomposition != "replicated":
        assert_owned(sim)
        assert sum(m.nmigrated for m in sim.step_metrics) > 0


def test_migration_into_empty_shards_grows_them():
    """A source inside the bottom slab: three of the four shards start with
    no lanes at all and must grow to take their arrivals.  No particle is
    lost or duplicated and the result is the single-device run's."""
    cfg = make_cfg(tt, "stream")
    sim = SpatialSimulation(cfg, devices=CPU4, transport="flight", quiet=True)
    assert [sh.state.n for sh in sim.shards][1:] == [0, 0, 0]
    stats = stats_of(sim)
    tally, single_stats, pids = run_single("stream", *cuts(sim),
                                           transport_name="flight")
    assert stats == single_stats
    np.testing.assert_allclose(sim.host_tally(), tally, rtol=1e-12,
                               atol=1e-300)
    np.testing.assert_array_equal(shard_pids(sim), pids)
    assert_owned(sim)
    assert all(sh.state.n > 0 for sh in sim.shards)
    live = [int((~sh.state.dead).sum()) for sh in sim.shards]
    assert sum(v > 0 for v in live) >= 3


def variant_cfg(variant, tmp_path):
    """The scatter-like deck with pcg64si draws, user .cs tables or a
    density grid (at half the timestep)."""
    cfg = make_cfg(tt, "scatter", dt=5e-8)
    if variant == "pcg64si":
        return cfg.with_(rng="pcg64si")
    if variant == "table":
        keys, values = resonance_log_table()
        for name in ("elastic_scatter.cs", "capture.cs"):
            write_cs_file(str(tmp_path / name), keys, values)
        return cfg.with_(params_path=str(tmp_path / "deck.params"))
    rng = np.random.default_rng(7)
    dens = rng.uniform(0.5, 10.0, size=(32, 32))
    dens[rng.random((32, 32)) < 0.25] = 0.0
    np.save(tmp_path / "dens.npy", dens)
    return cfg.with_(density_file=str(tmp_path / "dens.npy"), problems=())


@pytest.mark.parametrize("variant", ["pcg64si", "table", "grid"])
def test_deck_variants_under_2d_blocks(variant, tmp_path):
    """pcg64si, table and grid decks on 2x2 blocks against one device:
    counts exact per step, the tally to 1e-12 (the grid deck's density is
    cut into the shards' blocks)."""
    cfg = variant_cfg(variant, tmp_path)
    single = driver.Simulation(cfg, device="cpu", quiet=True)
    sim = Spatial2DSimulation(cfg, devices=CPU4, quiet=True)
    assert (sim.py, sim.px) == (2, 2)
    if variant == "table":
        assert not sim.shards[0].tables[0].analytic
    if variant == "grid":
        assert sim.shards[3].geom.density.shape == (16 * 16,)
    assert stats_of(sim) == stats_of(single)
    np.testing.assert_allclose(sim.host_tally(), single.host_tally(),
                               rtol=1e-12, atol=1e-300)
    assert sum(m.nmigrated for m in sim.step_metrics) > 0


@pytest.mark.parametrize("ndev,nx,ny", [(4, 32, 32), (8, 64, 64),
                                        (6, 30, 32), (2, 7, 8), (1, 5, 5)])
def test_factor_grid_matches_jax(ndev, nx, ny):
    from neutral_tpu.parallel.spatial import factor_grid as jfactor_grid

    assert factor_grid(ndev, nx, ny) == jfactor_grid(ndev, nx, ny)
    with pytest.raises(ValueError, match="cannot factor"):
        factor_grid(4, 7, 7)


def test_divisibility_errors():
    cfg = make_cfg(tt, "scatter", ny=30)
    with pytest.raises(ValueError, match="divisible"):
        SpatialSimulation(cfg, devices=CPU4, quiet=True)
    with pytest.raises(ValueError, match="divide"):
        Spatial2DSimulation(make_cfg(tt, "scatter"), devices=["cpu"] * 6,
                            grid=(3, 2), quiet=True)


@pytest.mark.parametrize("cls", [SpatialSimulation, Spatial2DSimulation])
def test_per_shard_injection_equals_host_partition(cls):
    """Each shard injects the pids born in its block: exactly the lanes of
    one global injection that the host assigns to it, in pid order."""
    cfg = make_cfg(tt, "scatter", nparticles=3000, dtype="float32",
                   tally_dtype="float32", source=tt.SourceBox(0.1, 0.3, 0.7,
                                                              0.5))
    sim = cls(cfg, devices=CPU4, quiet=True)
    state = inject_particles(
        sim.mesh, nparticles=cfg.nparticles, initial_energy=cfg.initial_energy,
        dt=cfg.dt, dtype=sim.dtype, **sim.source())
    owner = sim.owner(state.cellx, state.celly).numpy()
    assert sum(sh.state.n for sh in sim.shards) == cfg.nparticles
    for s, sh in enumerate(sim.shards):
        sel = torch.from_numpy(np.flatnonzero(owner == s))
        for f in STATE_FIELDS:
            assert torch.equal(getattr(sh.state, f), getattr(state, f)[sel]), f


def test_simulation_defaults_to_the_card():
    """Simulation and the decomposed classes run on the card unless asked
    for the CPU; without a card they raise and name device="cpu"."""
    cfg = make_cfg(tt, "scatter", nparticles=10)
    if torch.cuda.is_available():
        assert driver.Simulation(cfg, quiet=True).device.type == "cuda"
        return
    for make in (lambda: driver.Simulation(cfg, quiet=True),
                 lambda: SpatialSimulation(cfg, quiet=True),
                 lambda: ShardedSimulation(cfg, devices=["cuda"] * 2,
                                           quiet=True)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


def test_cli_defaults_to_the_card(capsys):
    """`python -m neutral_tpu_torch deck` asks for the card; without one
    it exits non-zero and says to pass --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    rc = driver.main(["problems/scatter.params", "--nparticles", "10"])
    assert rc != 0
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("argv,want", [
    ([], "Decomposition: none (1 device)."),
    (["--shards", "4", "--decomposition", "spatial2d"],
     "Decomposition: spatial2d, 4 shards on cpu, 2x2 blocks of 16x16 cells."),
])
def test_cli_prints_the_decomposition(argv, want):
    out = subprocess.run(
        [sys.executable, "-m", "neutral_tpu_torch", "problems/stream.params",
         "--device", "cpu", "--nparticles", "300", "--mesh-scale", "125",
         *argv],
        capture_output=True, text=True, check=True, timeout=300).stdout
    assert want in out
    total = float(re.search(r"Final global_energy_tally (\S+)", out)[1])
    assert total > 0.0
    assert ("Migrated" in out) == bool(argv)


def test_port_imports_no_jax():
    """Every module of neutral_tpu_torch imports with JAX and neutral_tpu
    made unimportable (all but `__main__`, which would run the CLI)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['neutral_tpu'] = None\n"
        "import neutral_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'neutral_tpu_torch.') if m.name != 'neutral_tpu_torch.__main__']\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for n in ('parallel.spatial', 'io_utils', 'tools', 'native',\n"
        "          'profiler', 'oracle', 'parallel.distributed'):\n"
        "    assert 'neutral_tpu_torch.' + n in names, n\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    assert int(out) >= 25


@pytest.mark.cuda
@pytest.mark.parametrize("decomposition", list(CLASSES))
def test_decomposition_matches_single_device_on_card(decomposition):
    """Four shards on one card (kernel engine, float32) against the
    single-device kernel run of the scatter deck at 65,536 particles:
    counts exact per step, tally sums to 1e-5 (atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tt.load_config("problems/scatter.params").with_(
        nparticles=65536, expected_tally=None)
    single = driver.Simulation(cfg, quiet=True)
    sim = CLASSES[decomposition](cfg, devices=["cuda"] * 4, quiet=True)
    assert sim.engine == single.engine == "kernel"
    assert stats_of(sim) == stats_of(single)
    a, b = sim.host_tally().sum(), single.host_tally().sum()
    assert abs(a - b) <= 1e-5 * abs(b)
    if decomposition != "replicated":
        assert_owned(sim)
