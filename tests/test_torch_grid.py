"""Density-grid decks (`density_file`) in the port, against neutral_tpu.

A grid deck's geometry carries its flat density on the device and no
regions or rects, as JAX's grid geometry does; the sweep transport gathers
the density of each lane's cell (`transport._density_of`), and the flight
transport refuses such decks.  On the CPU: a random grid with 25% vacuum
cells (`write_grid`, as tests/test_density_grid.py makes it), alone and
with a table deck, gives float64 per-step counts exactly equal to JAX's XLA sweep; and a
region deck written out as its own grid gives bitwise the same run as the
region deck.  The `cuda` tests hold the sweep kernel's grid mode to its
plain version on the card and skip without one; JAX is imported only
inside the tests that compare with it:

    python -m pytest tests/test_torch_grid.py -q -m cuda --noconftest
"""

import shutil

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver
from neutral_tpu_torch.mesh import build_density
from neutral_tpu_torch.particles import STATE_FIELDS
from neutral_tpu_torch.xs import resonance_log_table, write_cs_file

from test_torch_driver import kernel_matches_plain_on_card
from test_torch_flight import make_cfg


def write_grid(tmp_path, nx, ny, seed=7, vacuum_frac=0.25):
    """tests/test_density_grid.py's `_write_grid` (without its JAX
    imports): a random density field with some vacuum cells, as dens.npy."""
    rng = np.random.default_rng(seed)
    dens = rng.uniform(1.0e3, 2.0e4, size=(ny, nx))
    dens[rng.random((ny, nx)) < vacuum_frac] = 0.0
    path = tmp_path / "dens.npy"
    np.save(path, dens)
    return str(path)


def grid_cfg(pkg, tmp_path, dtype="float64", **kw):
    """tests/test_density_grid.py's grid deck (32^2, random densities,
    25% vacuum cells) built with `pkg`'s config class."""
    path = write_grid(tmp_path, 32, 32)
    base = dict(nx=32, ny=32, dt=4e-6, niters=2, nparticles=2048,
                initial_energy=1.0e3,
                source=pkg.SourceBox(0.2, 0.2, 0.6, 0.6), density_file=path, dtype=dtype, tally_dtype=dtype,
                params_path=str(tmp_path / "deck.params"))
    base.update(kw)
    return pkg.SimConfig(**base)


def test_grid_geometry(tmp_path):
    cfg = grid_cfg(tt, tmp_path, dtype="float32")
    geom = driver.make_geometry(cfg, torch.float32)
    assert geom.regions is None and geom.rects is None
    assert geom.dx == 1.0 / 32 and geom.dy == 1.0 / 32
    assert geom.density.dtype == torch.float32
    np.testing.assert_array_equal(
        geom.density.numpy(),
        np.load(cfg.density_file).astype(np.float32).reshape(-1))
    assert driver.auto_transport(cfg) == "sweep"


def test_grid_deck_flight_refused(tmp_path):
    cfg = grid_cfg(tt, tmp_path)
    with pytest.raises(ValueError, match="constant-density"):
        driver.Simulation(cfg, device="cpu", transport="flight", quiet=True)


def _steps(sim, niters):
    return [(m.nfacets, m.ncollisions, m.nprocessed)
            for m in (sim.step(s) for s in range(1, niters + 1))]


@pytest.mark.parametrize("tables", ["analytic", "table"])
def test_grid_deck_matches_jax_xla_f64(tmp_path, tables):
    """float64 sweep on the grid deck, with the generated tables or with
    user tables (test_pallas_table.py's): per-step counts exactly equal to
    JAX's XLA sweep, tallies to 1e-12."""
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver
    from test_pallas_table import make_log_table

    if tables == "table":
        keys, values = make_log_table()
        for name in ("elastic_scatter.cs", "capture.cs"):
            write_cs_file(str(tmp_path / name), keys, values)
    sim = driver.Simulation(grid_cfg(tt, tmp_path), device="cpu", quiet=True)
    assert sim.transport == "sweep" and sim.geom.regions is None
    assert sim.cs_scatter.analytic == (tables == "analytic")
    t_stats = _steps(sim, 2)
    jsim = jdriver.Simulation(grid_cfg(nt, tmp_path, engine="xla"),
                              quiet=True)
    assert jsim.geom.regions is None
    assert t_stats == _steps(jsim, 2)
    assert sum(s[1] for s in t_stats) > 0
    j_tally = np.asarray(jsim.tally, np.float64)
    assert j_tally.sum() != 0.0
    np.testing.assert_allclose(sim.host_tally().sum(), j_tally.sum(),
                               rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_region_deck_as_grid_is_bitwise_the_same(tmp_path, dtype):
    """The csp family's regions written out as a (ny, nx) grid: the grid
    deck's run equals the region deck's bitwise (counts, all 14 fields,
    tally), since each cell's density is the same rounded value."""
    cfg = make_cfg(tt, "csp", dtype=dtype)
    path = tmp_path / "dens.npy"
    np.save(path, build_density(cfg))
    region = driver.Simulation(cfg, device="cpu", transport="sweep",
                               quiet=True)
    grid = driver.Simulation(cfg.with_(density_file=str(path), problems=()),
                             device="cpu", transport="sweep", quiet=True)
    assert grid.geom.regions is None and region.geom.regions
    assert _steps(region, cfg.niters) == _steps(grid, cfg.niters)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(region.state, f),
                           getattr(grid.state, f)), f
    assert torch.equal(region.tally, grid.tally)


@pytest.mark.cuda
@pytest.mark.parametrize("modes", ["grid", "grid_table_pcg64si"])
def test_grid_kernel_matches_plain_on_card(modes, tmp_path):
    """The sweep kernel's grid mode against its plain version at 65,536
    particles: the scatter deck on a random 4000^2 grid with 25% vacuum
    cells, alone and with user tables and pcg64si draws (every mode of
    the kernel at once)."""
    write_grid(tmp_path, 4000, 4000)
    deck = tmp_path / "scatter.params"
    shutil.copy("problems/scatter.params", deck)
    with open(deck, "a") as f:
        f.write("density_file dens.npy\n")
        if modes != "grid":
            f.write("rng pcg64si\n")
    if modes != "grid":
        keys, values = resonance_log_table()
        for name in ("elastic_scatter.cs", "capture.cs"):
            write_cs_file(str(tmp_path / name), keys, values)
    cfg = tt.load_config(str(deck)).with_(nparticles=65536,
                                          expected_tally=None)
    sim, _ = kernel_matches_plain_on_card(cfg)
    assert sim.transport == "sweep" and sim.geom.regions is None
    assert sim.cs_scatter.analytic == (modes == "grid")
