"""The port's flight transport (neutral_tpu_torch.flight, flight_kernel)
against the JAX flight engine (neutral_tpu.flight), and against the port's
own facet-stepping transport.

The four deck families of tests/test_flight.py (stream, csp, split,
scatter; 400 particles, 64x64 mesh, 2 steps) run with analytic
cross-sections and region density on both sides.  In float64 every branch
decision must agree: flight_core's per-lane outputs match JAX's to 1e-12
with masks, cells and event counts exactly equal, and whole runs give
exactly equal per-step counts.  The CUDA flight kernel against its plain
version is checked by the `cuda` test at the end, which needs a card and
skips without one (it mirrors the flight phase of chip_smoke.py).  JAX is
imported only inside the tests that compare with it, so that on a machine
with a card and without JAX the `cuda` test runs on its own:

    python -m pytest tests/test_torch_flight.py -q -m cuda --noconftest
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
from neutral_tpu_torch import driver, flight, transport
from neutral_tpu_torch.census import flight_chunk_kernel
from neutral_tpu_torch.flight_kernel import FlightBuffers
from neutral_tpu_torch.particles import STATE_FIELDS

FAMILIES = ["stream", "csp", "split", "scatter"]
DECKS = ["stream", "csp", "split"]


def make_cfg(pkg, kind, n=400, nx=64, iters=2, dtype="float64"):
    """tests/test_flight.py's families, built with `pkg`'s config classes
    (neutral_tpu or neutral_tpu_torch)."""
    P, S = pkg.ProblemRegion, pkg.SourceBox
    problems, e0, src = {
        "stream": ((P(1.0e-30, 0, 0, 1, 1),), 1.0e6,
                   S(0.45, 0.45, 0.1, 0.1)),
        "csp": ((P(1.0e-30, 0, 0, 1, 1), P(1.0e4, 0.4, 0.4, 0.2, 0.2)),
                1.0e4, S(0.1, 0.1, 0.2, 0.2)),
        "split": ((P(1.0e-30, 0.0, 0.0, 1.0, 0.5),
                   P(1.0e3, 0.0, 0.5, 1.0, 0.5)), 2.5e4,
                  S(0.4, 0.4, 0.2, 0.2)),
        "scatter": ((P(1.0e4, 0, 0, 1, 1),), 1.0e3, S(0.2, 0.2, 0.6, 0.6)),
    }[kind]
    return pkg.SimConfig(nx=nx, ny=nx, width=1.0, height=1.0, dt=1e-7,
                         niters=iters, nparticles=n, initial_energy=e0,
                         source=src, problems=problems, dtype=dtype,
                         tally_dtype=dtype)


@functools.cache
def run_port(kind, transport_name, **kw):
    cfg = make_cfg(tt, kind, **kw)
    sim = driver.Simulation(cfg, device="cpu", transport=transport_name,
                            quiet=True)
    stats = [(m.nfacets, m.ncollisions, m.nprocessed)
             for m in (sim.step(s) for s in range(1, cfg.niters + 1))]
    return sim.host_tally(), stats


@functools.cache
def run_jax(kind, engine, **kw):
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver

    cfg = make_cfg(nt, kind, **kw)
    sim = jdriver.Simulation(cfg.with_(engine=engine), quiet=True)
    stats = [(m.nfacets, m.ncollisions, m.nprocessed)
             for m in (sim.step(s) for s in range(1, cfg.niters + 1))]
    return np.asarray(sim.tally, np.float64), stats


# ---------------------------------------------------------------------------
# geometry and transport choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deck", DECKS)
def test_disjoint_rects_match_jax(deck):
    import neutral_tpu as nt
    from neutral_tpu import flight as jflight, mesh as jmesh

    path = f"problems/{deck}.params"
    cfg = tt.load_config(path)
    regions = tt.mesh.region_cell_bounds(cfg)
    jregions = jmesh.region_cell_bounds(nt.load_config(path))
    assert regions == jregions
    rects = flight.disjoint_rects(regions, cfg.nx, cfg.ny)
    assert rects == jflight.disjoint_rects(jregions, cfg.nx, cfg.ny)
    assert driver.make_geometry(cfg).rects == rects
    cover = np.zeros((cfg.ny, cfg.nx), np.int32)
    for (ix0, ix1, iy0, iy1, _) in rects:
        cover[iy0:iy1, ix0:ix1] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("deck,want", [("stream", "flight"),
                                       ("csp", "flight"),
                                       ("split", "flight"),
                                       ("scatter", "sweep")])
def test_auto_transport_follows_the_jax_rule(deck, want, dtype):
    """JAX's rule (neutral_tpu/driver.py:303) without its TPU term: flight
    for float32 decks with a near-vacuum region, the sweep transport for
    every float64 deck (its is_f32 term)."""
    cfg = tt.load_config(f"problems/{deck}.params").with_(
        dtype=dtype, tally_dtype=dtype)
    assert driver.auto_transport(cfg) == (want if dtype == "float32"
                                          else "sweep")


def test_flight_keeps_global_coordinates_in_float32():
    cfg = tt.load_config("problems/csp.params").with_(nparticles=64, nx=64,
                                                      ny=64)
    fl = driver.Simulation(cfg, device="cpu", quiet=True)
    sw = driver.Simulation(cfg, device="cpu", transport="sweep", quiet=True)
    assert fl.transport == "flight" and sw.transport == "sweep"
    # Global positions lie inside the source box; cell-local ones inside
    # one cell.
    assert float(fl.state.x.min()) >= 0.1 - 1e-6
    assert float(sw.state.x.max()) <= sw.geom.dx * (1 + 1e-6)


# ---------------------------------------------------------------------------
# one flight piece against neutral_tpu.flight.flight_core (float64)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", FAMILIES)
def test_flight_core_matches_jax_f64(kind):
    """Up to 8 successive pieces of step 1, each from the same JAX state on
    both sides: equal masks, cells and counts, fields to 1e-12."""
    import jax.numpy as jnp
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver
    from neutral_tpu import flight as jflight, transport as jtransport

    cfg = make_cfg(tt, kind)
    jcfg = make_cfg(nt, kind)
    sim = driver.Simulation(cfg, device="cpu", transport="flight",
                            quiet=True)
    jgeom = dataclasses.replace(jdriver.make_geometry(jcfg), same_xs=True)
    assert sim.geom.same_xs and sim.geom.rects == jgeom.rects
    jtab = nt.CrossSection.resonance(dtype=jnp.float64, analytic=True)
    mesh = nt.build_mesh(jcfg, dtype=jnp.float64)
    jstate = nt.inject_particles(
        mesh, nparticles=jcfg.nparticles,
        source_x0=jcfg.source.xpos, source_y0=jcfg.source.ypos,
        source_width=jcfg.source.width, source_height=jcfg.source.height,
        initial_energy=jcfg.initial_energy, dt=jcfg.dt, dtype=jnp.float64)
    jstate = jtransport.begin_timestep(jstate, mesh, jgeom, jtab, jcfg.dt,
                                       jnp.uint32(1))
    inv = 1.0 / cfg.nparticles
    pieces = colls = 0
    for _ in range(8):
        tstate = tt.state_from_numpy(
            {f: np.asarray(getattr(jstate, f)) for f in STATE_FIELDS})
        if not bool(transport.working_mask(tstate).any()):
            break
        jp = jflight.flight_core(jstate, jgeom, jtab, jtab, jnp.uint32(1),
                                 inv, jnp.float64)
        tp = flight.flight_core(tstate, sim.geom, sim.cs_scatter,
                                sim.cs_absorb, 1, inv, torch.float64)
        j = dict(zip(flight.FlightPiece._fields, jp))
        for f in STATE_FIELDS:
            a = getattr(tp.state, f).numpy()
            b = np.asarray(getattr(j["state"], f)).astype(a.dtype)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=f)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)
        for f in ("flush1", "flush2", "emit", "is_coll", "nf_lane"):
            np.testing.assert_array_equal(
                getattr(tp, f).numpy(),
                np.asarray(j[f]).astype(getattr(tp, f).numpy().dtype),
                err_msg=f)
        for f, mask in (("cell1", "flush1"), ("val1", "flush1"),
                        ("cell2", "flush2"), ("val2", "flush2"),
                        ("p0x", "emit"), ("p0y", "emit"), ("p1x", "emit"),
                        ("p1y", "emit"), ("kk", "emit")):
            m = getattr(tp, mask).numpy()
            np.testing.assert_allclose(getattr(tp, f).numpy()[m],
                                       np.asarray(j[f])[m], rtol=1e-12,
                                       atol=0, err_msg=f)
        pieces += 1
        colls += int(tp.is_coll.sum())
        jstate = j["state"]
    assert pieces >= 2
    if kind in ("split", "scatter"):
        assert colls > 0


# ---------------------------------------------------------------------------
# whole runs through the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", FAMILIES)
def test_flight_path_matches_jax_flight_f64(kind):
    """The driver's flight path (plain) against
    neutral_tpu.driver.Simulation(engine="flight"), as
    tests/test_flight.py::test_flight_matches_xla_engine_f64 holds the JAX
    flight engine to its stepping engine."""
    t_tally, t_stats = run_port(kind, "flight")
    j_tally, j_stats = run_jax(kind, "flight")
    assert t_stats == j_stats
    assert j_tally.sum() != 0.0
    np.testing.assert_allclose(t_tally.sum(), j_tally.sum(), rtol=1e-11)
    np.testing.assert_allclose(t_tally, j_tally, rtol=1e-7, atol=1e-30)


@pytest.mark.parametrize("kind", FAMILIES)
def test_flight_path_counts_equal_sweep_path(kind):
    """Draws happen only at collisions, so the port's two transports run
    the same histories: per-step counts exactly equal, tallies to
    summation order."""
    f_tally, f_stats = run_port(kind, "flight")
    s_tally, s_stats = run_port(kind, "sweep")
    assert f_stats == s_stats
    np.testing.assert_allclose(f_tally.sum(), s_tally.sum(), rtol=1e-11)


def test_flight_f32_within_tolerance_of_jax_f64():
    """float32 flight (global coordinates) against JAX's float64 stepping
    engine on the csp family, as tests/test_flight.py holds JAX's own."""
    t_tally, _ = run_port("csp", "flight", n=600, iters=3, dtype="float32")
    j_tally, _ = run_jax("csp", "xla", n=600, iters=3)
    ref = j_tally.sum()
    assert ref != 0.0
    assert abs(t_tally.sum() - ref) / abs(ref) < 1e-3


def test_cli_stream_takes_flight_and_matches_golden():
    out = subprocess.run(
        [sys.executable, "-m", "neutral_tpu_torch", "problems/stream.params",
         "--nparticles", "400", "--mesh-scale", "62", "--device", "cpu"],
        capture_output=True, text=True, check=True, timeout=300).stdout
    assert "Engine: plain." in out and "Transport: flight." in out
    assert "flight sweeps" in out
    for phase in ("begin=", "flight=", "raster=", "loop="):
        assert phase in out
    total = float(re.search(r"Final global_energy_tally (\S+)", out)[1])
    assert abs(total - 5.76e-24) <= 1e-2 * 5.76e-24


# ---------------------------------------------------------------------------
# the CUDA flight kernel
# ---------------------------------------------------------------------------

def test_flight_kernel_wrapper_on_cpu_raises():
    cfg = make_cfg(tt, "split", dtype="float32")
    sim = driver.Simulation(cfg, device="cpu", quiet=True)
    launches0 = flight_chunk_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        flight_chunk_kernel(sim.state, sim.tally, sim.geom, sim.cs_scatter,
                            sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    assert flight_chunk_kernel.launches == launches0


def test_flight_kernel_rejects_more_than_16_rects():
    """The kernels once held at most 16 density rectangles in their
    parameters; they now take the rects as device arrays of any length, so
    17 rects pass the wrapper's checks and only the CPU state is refused."""
    stripes = tuple(tt.ProblemRegion(0.5 + 0.01 * i, i / 17, 0.0, 1 / 17, 1.0)
                    for i in range(17))
    cfg = make_cfg(tt, "stream", nx=68, dtype="float32").with_(
        problems=stripes)
    sim = driver.Simulation(cfg, device="cpu", quiet=True)
    assert sim.transport == "flight" and len(sim.geom.rects) == 17
    with pytest.raises(ValueError, match="CUDA"):
        flight_chunk_kernel(sim.state, sim.tally, sim.geom, sim.cs_scatter,
                            sim.cs_absorb, 1, 1.0 / cfg.nparticles)


def _sorted_rows(segs):
    rows = torch.cat(segs).cpu().numpy()
    return rows[np.lexsort(rows.T[::-1])]


def _bits(t):
    """A float64 tensor's bit patterns (-0.0 differs from 0.0, NaN equals
    itself); others as they are."""
    return t.view(torch.int64) if t.dtype == torch.float64 else t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("max_pieces,rows", [(64, None), (1, None),
                                             (None, 1000)],
                         ids=["64", "1", "1000_rows"])
@pytest.mark.parametrize("deck", DECKS)
def test_flight_kernel_matches_plain_on_card(deck, max_pieces, rows, dtype):
    """Kernel and plain version from one begin_timestep state of the full
    deck's geometry at 65,536 particles: equal counts, all 14 per-lane
    fields (bitwise in float64) and sorted segment rows; tally sums to
    1e-5 in float32 and 1e-12 in float64 (atomics add in another order).
    max_pieces=1 splits the census over many launches; a segment buffer
    of 1000 rows (grown up to 4000) refuses rows in many rounds, under the
    default pieces per launch.  float64 runs the flight and deposit
    kernels' float64 instantiations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tt.load_config(f"problems/{deck}.params").with_(
        nparticles=65536, expected_tally=None, dtype=dtype,
        tally_dtype=dtype)
    sim = driver.Simulation(cfg, device="cuda", engine="plain",
                            transport="flight", quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    args = (sim.geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    kt, pt = torch.zeros_like(sim.tally), torch.zeros_like(sim.tally)
    ksegs, psegs = [], []
    buffers = (None if rows is None else
               FlightBuffers(sim.geom.nx, sim.geom.ny, "cuda", rows=rows,
                             max_rows=4 * rows, dtype=sim.dtype))
    refusals0 = flight_chunk_kernel.refusals
    ks, knf, knc, launches, _ = flight_chunk_kernel(
        start.clone(), kt, *args, max_pieces=max_pieces, segments=ksegs,
        buffers=buffers)
    ps, pnf, pnc, _, _ = flight.flight_chunk_plain(start.clone(), pt, *args,
                                                   segments=psegs)
    assert (knf, knc) == (pnf, pnc) and knf > 0
    if max_pieces == 1:
        assert launches > 1
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(ks, f)).cpu().numpy(),
                                      _bits(getattr(ps, f)).cpu().numpy(), f)
    assert torch.cat(ksegs).dtype == sim.dtype
    np.testing.assert_array_equal(_sorted_rows(ksegs), _sorted_rows(psegs))
    if rows is not None and len(torch.cat(psegs)) > 4 * rows:
        assert flight_chunk_kernel.refusals - refusals0 > 1
    ksum, psum = float(kt.double().sum()), float(pt.double().sum())
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert abs(ksum - psum) <= tol * abs(psum)
