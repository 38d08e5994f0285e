"""Decks without a uniform pitch in the port: non-uniform meshes and
`fast_math 0`, against neutral_tpu.

Their geometry has dx = dy = 0: facet distances gather the edge arrays by
global cell (`transport._facet_edges`), and a fast_math 0 deck gathers its
density from the region-built grid.  They run the plain engine's sweep
transport, as JAX runs them on its XLA sweep; the CUDA kernels and the
flight transport refuse them before any state is built.  On the CPU, in
float64, the per-step counts must equal JAX's XLA `Simulation` and
`neutral_tpu.oracle` exactly and the tally agree to rtol 1e-9 (the port
of tests/test_nonuniform.py:117-168); float32 lies within 1e-3 of JAX's
float64; four CPU shards give the single-device run's counts.  JAX is
imported only inside the tests that compare with it.
"""

import functools
import re

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver
from neutral_tpu_torch.parallel import Spatial2DSimulation, SpatialSimulation

CPU4 = ["cpu"] * 4


def stretched_cfg(pkg, **kw):
    """tests/test_nonuniform.py's 40^2 stretched deck, in `pkg`'s config
    classes."""
    P, S = pkg.ProblemRegion, pkg.SourceBox
    base = dict(nx=40, ny=40, dt=1e-7, niters=2, nparticles=200,
                initial_energy=1.0e4, source=S(0.1, 0.1, 0.3, 0.3),
                problems=(P(1.0e2, 0.0, 0.0, 1.0, 1.0),
                          P(1.0e4, 0.4, 0.4, 0.2, 0.2)),
                mesh_stretch_x=1.08, mesh_stretch_y=0.93,
                dtype="float64", tally_dtype="float64")
    base.update(kw)
    return pkg.SimConfig(**base)


def light_cfg(pkg, **kw):
    """A 32^2 deck with lanes that cross many cells in both steps (few
    collisions per history): tests/test_torch_parallel.py's scatter-like
    deck."""
    P, S = pkg.ProblemRegion, pkg.SourceBox
    base = dict(nx=32, ny=32, dt=1e-7, niters=2, nparticles=300,
                initial_energy=1.0e3, source=S(0.3, 0.3, 0.4, 0.4),
                problems=(P(1.0, 0, 0, 1, 1), P(10.0, 0.6, 0.6, 0.2, 0.2)),
                dtype="float64", tally_dtype="float64")
    base.update(kw)
    return pkg.SimConfig(**base)


# deck name -> builder of its config in a package
DECKS = {
    "stretched": stretched_cfg,
    "fast_math0": lambda pkg, **kw: light_cfg(pkg, fast_math=False, **kw),
    "stretched_fast_math0": lambda pkg, **kw: light_cfg(
        pkg, fast_math=False, mesh_stretch_x=1.05, mesh_stretch_y=0.95, **kw),
}


def write_deck(cfg, path) -> str:
    """`cfg` as a deck file in the reference grammar (with the port's
    `fast_math` key)."""
    src = cfg.source
    path.write_text(
        f"nparticles {cfg.nparticles}\ninitial_energy {cfg.initial_energy}\n"
        f"dt {cfg.dt}\nnx {cfg.nx}\nny {cfg.ny}\niterations {cfg.niters}\n"
        f"fast_math {int(cfg.fast_math)}\n"
        f"mesh_stretch_x {cfg.mesh_stretch_x}\n"
        f"mesh_stretch_y {cfg.mesh_stretch_y}\n"
        f"source xpos={src.xpos} ypos={src.ypos} width={src.width} "
        f"height={src.height}\n"
        + "".join(f"problem_{i} density={r.density} energy=0.0 "
                  f"xpos={r.xpos} ypos={r.ypos} width={r.width} "
                  f"height={r.height}\n" for i, r in enumerate(cfg.problems)))
    return str(path)


def stats_of(sim):
    return [(m.nfacets, m.ncollisions, m.nprocessed)
            for m in (sim.step(t) for t in range(1, sim.cfg.niters + 1))]


@functools.cache
def run_port(deck, dtype="float64"):
    sim = driver.Simulation(DECKS[deck](tt, dtype=dtype, tally_dtype=dtype),
                            device="cpu", quiet=True)
    return stats_of(sim), sim.host_tally(), sim


@functools.cache
def run_jax(deck):
    """JAX's XLA Simulation and neutral_tpu.oracle in float64: (counts,
    tally) of each."""
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver
    from test_nonuniform import _run_oracle

    cfg = DECKS[deck](nt, engine="xla")
    jsim = jdriver.Simulation(cfg, quiet=True)
    assert not jsim.use_pallas and not jsim.use_flight
    jstats = stats_of(jsim)
    otally, ostats = _run_oracle(cfg)
    return (jstats, np.asarray(jsim.tally, np.float64),
            ostats, otally.reshape(-1))


@pytest.mark.parametrize("deck", list(DECKS))
def test_geometry_has_no_pitch(deck):
    """dx = dy = 0 and JAX's regions, rects and density: region bounds from
    the edge midpoints (fast_math), or the region-built grid (fast_math
    0); edges equal to JAX's mesh edges."""
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver
    from neutral_tpu.mesh import build_mesh

    cfg, jcfg = DECKS[deck](tt), DECKS[deck](nt)
    geom = driver.make_geometry(cfg, torch.float64)
    jgeom = jdriver.make_geometry(jcfg)
    assert geom.dx == geom.dy == 0.0 == jgeom.dx == jgeom.dy
    assert geom.regions == jgeom.regions and geom.rects is None
    jmesh = build_mesh(jcfg, dtype=np.float64)
    np.testing.assert_array_equal(geom.edgex.numpy(), np.asarray(jmesh.edgex))
    np.testing.assert_array_equal(geom.edgey.numpy(), np.asarray(jmesh.edgey))
    if cfg.fast_math:
        assert geom.density is None and geom.regions
    else:
        np.testing.assert_array_equal(
            geom.density.numpy(), np.asarray(jmesh.density).reshape(-1))


@pytest.mark.parametrize("deck", list(DECKS))
def test_float64_matches_jax_and_oracle(deck):
    """Per-step (facets, collisions, processed) exactly equal to JAX's XLA
    sweep and to the sequential oracle; the tally to rtol 1e-9."""
    stats, tally, sim = run_port(deck)
    assert sim.engine == "plain" and sim.transport == "sweep"
    assert sim.coords() == "global"
    jstats, jtally, ostats, otally = run_jax(deck)
    assert stats == jstats == ostats
    assert sum(s[0] for s in stats) > 0 and sum(s[1] for s in stats) > 0
    assert otally.sum() != 0.0
    np.testing.assert_allclose(tally, otally, rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(tally, jtally, rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("deck", list(DECKS))
def test_float32_within_1e3_of_jax_float64(deck):
    """float32 keeps global coordinates on these decks (no pitch, no
    cell-local frame) and lands within 1e-3 of JAX's float64 tally."""
    _, tally, sim = run_port(deck, "float32")
    assert sim.coords() == "global" and sim.state.x.dtype == torch.float32
    ref = run_jax(deck)[1].sum()
    assert abs(tally.sum() - ref) <= 1e-3 * abs(ref)


@pytest.mark.parametrize("deck", ["stretched_fast_math0"])
@pytest.mark.parametrize("cls", [SpatialSimulation, Spatial2DSimulation])
def test_four_cpu_shards_match_one_device(cls, deck):
    """y-slabs and 2x2 blocks on four CPU shards: edges indexed by global
    cell, each shard's density block gathered; per-step counts equal to
    the single-device run's, the tally to 1e-12."""
    stats, tally, _ = run_port(deck)
    sim = cls(DECKS[deck](tt), devices=CPU4, quiet=True)
    assert sim.engine == "plain" and sim.transport == "sweep"
    assert sim.shards[-1].geom.density.shape == (sim.rows * sim.cols,)
    assert stats_of(sim) == stats
    assert sum(m.nmigrated for m in sim.step_metrics) > 0
    np.testing.assert_allclose(sim.host_tally(), tally, rtol=1e-12,
                               atol=1e-300)


def test_auto_routes_to_plain_sweep():
    """`auto` on a CUDA device in float32 gives the plain engine and the
    sweep transport for decks without a pitch (no card needed to decide)."""
    for deck in DECKS:
        cfg = DECKS[deck](tt, dtype="float32", tally_dtype="float32")
        assert driver.pick_engine("auto", torch.device("cuda"),
                                  torch.float32, cfg) == "plain"
        assert driver.pick_transport(cfg, "auto") == "sweep"
    uniform = light_cfg(tt, dtype="float32", tally_dtype="float32")
    assert driver.pick_engine("auto", torch.device("cuda"), torch.float32,
                              uniform) == "kernel"


@pytest.mark.parametrize("deck,match", [
    ("stretched", "uniform mesh"), ("fast_math0", "fast_math"),
    ("stretched_fast_math0", "uniform mesh")])
@pytest.mark.parametrize("how", ["engine", "transport"])
def test_kernel_and_flight_raise_before_state(deck, match, how, monkeypatch,
                                              tmp_path):
    """--engine kernel (on the card, in float32) and --transport flight
    raise with neutral_tpu's reason in Simulation.__init__ and in the CLI,
    before the geometry or any particle is made."""
    def no_state(*a, **k):
        raise AssertionError("state was built")
    monkeypatch.setattr(driver, "make_geometry", no_state)
    monkeypatch.setattr(driver, "inject_particles", no_state)
    cfg = DECKS[deck](tt, dtype="float32", tally_dtype="float32")
    kw = ({"device": "cuda", "engine": "kernel"} if how == "engine"
          else {"device": "cpu", "transport": "flight"})
    with pytest.raises(ValueError, match=match):
        driver.Simulation(cfg, quiet=True, **kw)
    deck = write_deck(cfg.with_(nparticles=10), tmp_path / "deck.params")
    argv = ([deck, "--engine", "kernel"] if how == "engine"
            else [deck, "--transport", "flight", "--device", "cpu"])
    with pytest.raises(ValueError, match=match):
        driver.main(argv)


@pytest.mark.parametrize("deck", ["fast_math0", "stretched_fast_math0"])
def test_cli_runs_the_deck_on_the_cpu(deck, tmp_path, capsys):
    """`python -m neutral_tpu_torch deck --device cpu --dtype float64` on
    the deck file: the plain engine and the sweep transport, with the
    per-step counts of the Simulation run that JAX's matches."""
    path = write_deck(DECKS[deck](tt), tmp_path / "deck.params")
    assert driver.main([path, "--device", "cpu", "--dtype", "float64"]) == 0
    out = capsys.readouterr().out
    assert "Engine: plain." in out and "Transport: sweep." in out
    counts = [(int(f), int(c)) for f, c in re.findall(
        r"Facets\s+(\d+)\nCollisions\s+(\d+)", out)]
    assert counts == [s[:2] for s in run_port(deck)[0]]
