"""The port's IO (neutral_tpu_torch.io_utils, the driver's checkpoints,
dumps and trace) against neutral_tpu.io_utils.

VisIt dumps are byte-equal to JAX's for the same field and the particle
density equal on the same state; npz checkpoints round-trip bitwise, cross
between the port and JAX in both directions (the next step's counts
exact, the tally to 1e-12), restore into every layout from every other
(tests/test_spatial.py:243-290's round trip), refuse other coordinates,
and a restored CLI run resumes at the step after its checkpoint.  JAX is
imported only inside the tests that compare with it.
"""

import json
import re
import types

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver, io_utils
from neutral_tpu_torch.parallel import (ShardedSimulation, Spatial2DSimulation,
                                        SpatialSimulation)
from neutral_tpu_torch.particles import STATE_FIELDS, state_to_numpy

CPU4 = ["cpu"] * 4
LAYOUTS = {"replicated": ShardedSimulation, "spatial": SpatialSimulation,
           "spatial2d": Spatial2DSimulation}
SMALL = ["--device", "cpu", "--nparticles", "300", "--mesh-scale", "125"]


def make_cfg(pkg, **kw):
    """A 32^2 float64 deck whose lanes cross cells and collide in every
    step (tests/test_torch_parallel.py's scatter-like deck)."""
    P, S = pkg.ProblemRegion, pkg.SourceBox
    base = dict(nx=32, ny=32, dt=1e-7, niters=3, nparticles=300,
                initial_energy=1.0e3, source=S(0.3, 0.3, 0.4, 0.4),
                problems=(P(1.0, 0, 0, 1, 1), P(10.0, 0.6, 0.6, 0.2, 0.2)),
                dtype="float64", tally_dtype="float64")
    base.update(kw)
    return pkg.SimConfig(**base)


def counts(m):
    return (m.nfacets, m.ncollisions, m.nprocessed)


def test_write_bov_is_byte_equal_to_jax(tmp_path):
    from neutral_tpu import io_utils as jio

    field = np.random.default_rng(3).random((24, 40)) * 1e-3
    io_utils.write_bov(str(tmp_path / "port"), field, variable="energy",
                       time=2.5e-7)
    jio.write_bov(str(tmp_path / "jax"), field, variable="energy",
                  time=2.5e-7)
    for ext in (".dat", ".bov"):
        port = (tmp_path / f"port{ext}").read_bytes()
        jax = (tmp_path / f"jax{ext}").read_bytes()
        assert port == jax.replace(b"jax.dat", b"port.dat")
    with pytest.raises(ValueError, match="2D"):
        io_utils.write_bov(str(tmp_path / "x"), field[0], variable="e")


def test_particle_density_equals_jax():
    """Live particles per cell of a state after one step, with every third
    lane dead and one live lane past the mesh's edge (clipped), equal to
    JAX's histogram of the same fields."""
    from neutral_tpu import io_utils as jio

    sim = driver.Simulation(make_cfg(tt), device="cpu", quiet=True)
    sim.step(1)
    state = sim.state
    state.dead[::3] = True
    state.cellx[1] = 40
    mine = io_utils.particle_density(state, 32, 32)
    ref = jio.particle_density(types.SimpleNamespace(**state_to_numpy(state)),
                               32, 32)
    np.testing.assert_array_equal(mine, ref)
    assert mine.sum() == int((~state.dead).sum())


@pytest.mark.parametrize("dtype,transport,coords", [
    ("float64", "sweep", "global"), ("float32", "sweep", "cell-local"),
    ("float32", "flight", "global")])
def test_checkpoint_round_trip_is_bitwise(tmp_path, dtype, transport, coords):
    """save -> restore gives all 14 fields and the tally bitwise, and the
    next step of both runs is the same."""
    cfg = make_cfg(tt, dtype=dtype, tally_dtype=dtype)
    a = driver.Simulation(cfg, device="cpu", transport=transport, quiet=True)
    a.step(1)
    assert a.coords() == coords
    path = str(tmp_path / "ck.npz")
    a.checkpoint(path, 1)
    b = driver.Simulation(cfg, device="cpu", transport=transport, quiet=True)
    assert b.restore(path) == 1
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert torch.equal(a.tally, b.tally)
    assert counts(a.step(2)) == counts(b.step(2))
    assert torch.equal(a.tally, b.tally)


def test_coords_mismatch_raises(tmp_path):
    """A cell-local checkpoint (float32 sweep) refuses a global run."""
    cfg = make_cfg(tt, dtype="float32", tally_dtype="float32")
    sim = driver.Simulation(cfg, device="cpu", transport="sweep", quiet=True)
    path = str(tmp_path / "ck.npz")
    sim.checkpoint(path, 0)
    for other in (driver.Simulation(cfg, device="cpu", transport="flight",
                                    quiet=True),
                  driver.Simulation(make_cfg(tt), device="cpu", quiet=True)):
        with pytest.raises(ValueError, match="coordinates"):
            other.restore(path)
    with pytest.raises(ValueError, match="npz"):
        sim.checkpoint(str(tmp_path / "ck_dir"), 0)


def test_checkpoints_cross_between_jax_and_port(tmp_path):
    """A JAX npz after step 1 restored in the port gives JAX's step 2, and
    a port npz restored in JAX gives the port's step 2: counts exact, the
    tally's sum to 1e-12 and each cell to 1e-9 (float64, XLA sweep and the
    plain sweep, which add a cell's deposits in different orders)."""
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver

    jcfg = make_cfg(nt, engine="xla")
    jax_a = jdriver.Simulation(jcfg, quiet=True)
    jax_a.step(1)
    jax_a.checkpoint(str(tmp_path / "jax.npz"), 1)
    port_a = driver.Simulation(make_cfg(tt), device="cpu", quiet=True)
    port_a.step(1)
    port_a.checkpoint(str(tmp_path / "port.npz"), 1)

    port_b = driver.Simulation(make_cfg(tt), device="cpu", quiet=True)
    assert port_b.restore(str(tmp_path / "jax.npz")) == 1
    jax_b = jdriver.Simulation(jcfg, quiet=True)
    assert jax_b.restore(str(tmp_path / "port.npz")) == 1
    want = counts(jax_a.step(2))
    assert want[1] > 0 and want[0] > 0
    assert counts(port_b.step(2)) == want == counts(port_a.step(2))
    assert counts(jax_b.step(2)) == want
    ref = np.asarray(jax_a.tally, np.float64)
    for tally in (port_b.host_tally(), port_a.host_tally(),
                  np.asarray(jax_b.tally, np.float64)):
        np.testing.assert_allclose(tally.sum(), ref.sum(), rtol=1e-12)
        np.testing.assert_allclose(tally, ref, rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_checkpoint_restores_across_layouts(tmp_path, layout):
    """One device -> four CPU shards and back (each lane onto its owner
    shard, the tally cut into the shards' parts): the restored runs finish
    with the uninterrupted decomposed run's counts and tally."""
    cfg = make_cfg(tt, niters=2)
    cls = LAYOUTS[layout]
    ref = cls(cfg, devices=CPU4, quiet=True)
    stats = [counts(ref.step(t)) for t in (1, 2)]

    single = driver.Simulation(cfg, device="cpu", quiet=True)
    single.step(1)
    single.checkpoint(str(tmp_path / "single.npz"), 1)
    sim = cls(cfg, devices=CPU4, quiet=True)
    assert sim.restore(str(tmp_path / "single.npz")) == 1
    assert counts(sim.step(2)) == stats[1]
    np.testing.assert_allclose(sim.host_tally(), ref.host_tally(),
                               rtol=1e-12, atol=1e-300)

    back = cls(cfg, devices=CPU4, quiet=True)
    back.step(1)
    back.checkpoint(str(tmp_path / "shards.npz"), 1)
    with np.load(tmp_path / "shards.npz") as z:
        np.testing.assert_array_equal(z["pid"], np.arange(cfg.nparticles))
    single = driver.Simulation(cfg, device="cpu", quiet=True)
    assert single.restore(str(tmp_path / "shards.npz")) == 1
    assert counts(single.step(2)) == stats[1]
    np.testing.assert_allclose(single.host_tally(), ref.host_tally(),
                               rtol=1e-12, atol=1e-300)


def step_lines(out):
    return re.findall(r"Iteration  (\d+)\n(?:.*\n)*?Facets\s+(\d+)\n"
                      r"Collisions\s+(\d+)", out)


def test_cli_restore_resumes_after_the_checkpoint(tmp_path, capsys):
    """--iterations 1 --checkpoint, then --restore: the resumed run prints
    step 2 (not step 1 again) with the uninterrupted run's counts and
    tally."""
    deck = "problems/csp.params"
    ck = str(tmp_path / "ck.npz")
    driver.main([deck, *SMALL, "--iterations", "2"])
    full = capsys.readouterr().out
    driver.main([deck, *SMALL, "--iterations", "1", "--checkpoint", ck])
    capsys.readouterr()
    driver.main([deck, *SMALL, "--iterations", "2", "--restore", ck])
    resumed = capsys.readouterr().out
    assert "Restored checkpoint at step 1" in resumed
    assert step_lines(resumed) == step_lines(full)[1:]
    assert [s[0] for s in step_lines(resumed)] == ["2"]
    tally = re.compile(r"Final global_energy_tally (\S+)")
    assert tally.search(resumed)[1] == tally.search(full)[1]


def test_visit_dump_writes_jax_files(tmp_path, monkeypatch):
    """visit_dump: density<tt> before each step and after the last,
    energy<tt> after each step, in the working directory; density files
    byte-equal to JAX's, the energy's sum to 1e-12 and each cell to 1e-9
    (float64 sweep)."""
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver

    for name, pkg in (("port", tt), ("jax", nt)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        cfg = make_cfg(pkg, niters=2, visit_dump=True)
        if pkg is tt:
            sim = driver.Simulation(cfg, device="cpu", quiet=True)
        else:
            sim = jdriver.Simulation(cfg.with_(engine="xla"), quiet=True)
        total = sim.run()
    port, jax = tmp_path / "port", tmp_path / "jax"
    names = sorted(p.name for p in port.iterdir())
    assert names == sorted(p.name for p in jax.iterdir()) == sorted(
        f"{k}{t}.{e}" for k, ts in (("density", (1, 2, 3)),
                                    ("energy", (1, 2)))
        for t in ts for e in ("bov", "dat"))
    for t in (1, 2, 3):
        assert ((port / f"density{t}.dat").read_bytes()
                == (jax / f"density{t}.dat").read_bytes())
    assert np.fromfile(port / "density1.dat").sum() == 300
    energy = np.fromfile(port / "energy2.dat")
    assert energy.sum() == pytest.approx(total, rel=1e-15)
    jenergy = np.fromfile(jax / "energy2.dat")
    np.testing.assert_allclose(energy.sum(), jenergy.sum(), rtol=1e-12)
    np.testing.assert_allclose(energy, jenergy, rtol=1e-9, atol=1e-300)


def test_trace_dir_writes_a_chrome_trace(tmp_path):
    trace = tmp_path / "trace"
    assert driver.main(["problems/stream.params", "--device", "cpu",
                        "--nparticles", "20", "--mesh-scale", "250",
                        "--iterations", "1", "--trace-dir", str(trace)]) == 0
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
