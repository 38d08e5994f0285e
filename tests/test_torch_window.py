"""The spatial window of the port's plain sweep and flight (the plain
versions of the kernels' window modes) against the JAX package.

A shard of a spatial decomposition owns a window of the mesh: its tally is
window-local, lanes outside the window freeze, and the flight transport
clamps rect walls to the window.  In float64 the port's windowed
`transport.sweep_chunk` and `flight.flight_core` must take every branch as
`neutral_tpu`'s do with `y_off_dyn`/`x_off_dyn` and `x_off`/`y_off`, on a
window that the source straddles, so that lanes leave it.  The `cuda`
tests hold the windowed kernels to these plain versions on the card and
skip without one:

    python -m pytest tests/test_torch_window.py -q -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver, flight, transport
from neutral_tpu_torch.particles import STATE_FIELDS

from test_torch_driver import kernel_matches_plain_on_card
from test_torch_flight import make_cfg

NX = 48
# (x_off, y_off, nx, ny): a 2D block, a y-slab and an x-column, each cut
# at the middle of the mesh, through the source boxes of the split and
# stream families (lanes start on both sides and leave the window).
WINDOWS = [(24, 0, 24, 24), (None, 0, NX, 24), (24, None, 24, NX)]


def window_geom(geom, window):
    x_off, y_off, nx, ny = window
    return dataclasses.replace(geom, nx=nx, ny=ny), x_off, y_off


def jax_state(cfg, jgeom):
    """The JAX injection of `cfg` in float64 and its step-1 begin state."""
    import jax.numpy as jnp
    import neutral_tpu as nt
    from neutral_tpu import transport as jtransport

    jtab = nt.CrossSection.resonance(dtype=jnp.float64, analytic=True)
    mesh = nt.build_mesh(cfg, dtype=jnp.float64)
    jstate = nt.inject_particles(
        mesh, nparticles=cfg.nparticles,
        source_x0=cfg.source.xpos, source_y0=cfg.source.ypos,
        source_width=cfg.source.width, source_height=cfg.source.height,
        initial_energy=cfg.initial_energy, dt=cfg.dt, dtype=jnp.float64)
    jstate = jtransport.begin_timestep(jstate, mesh, jgeom, jtab, cfg.dt,
                                       jnp.uint32(1))
    return jstate, jtab, mesh


def to_port(jstate):
    return tt.state_from_numpy(
        {f: np.asarray(getattr(jstate, f)) for f in STATE_FIELDS})


def assert_states_equal(port, jax_state_, rtol=0.0):
    """All 14 fields: integers and masks exactly, floats to `rtol` (with
    an absolute 1e-12 for values near 0)."""
    for f in STATE_FIELDS:
        a = getattr(port, f).numpy()
        b = np.asarray(getattr(jax_state_, f)).astype(a.dtype)
        if a.dtype.kind == "f" and rtol:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-12,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_split_rects_match_jax():
    from neutral_tpu import flight as jflight

    for deck in ("stream", "csp", "split"):
        cfg = tt.load_config(f"problems/{deck}.params")
        rects = driver.make_geometry(cfg).rects
        for cuts in (([], [1000, 2000, 3000]), ([2000], [2000]),
                     ([1000, 3000], [])):
            got = flight.split_rects(rects, *cuts)
            assert got == jflight.split_rects(rects, *cuts)
            cover = np.zeros((cfg.ny // 100, cfg.nx // 100), np.int32)
            for (ix0, ix1, iy0, iy1, _) in got:
                cover[iy0 // 100:iy1 // 100, ix0 // 100:ix1 // 100] += 1
                assert not any(ix0 < c < ix1 for c in cuts[0])
                assert not any(iy0 < c < iy1 for c in cuts[1])
            assert (cover == 1).all()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("kind", ["split", "stream"])
def test_windowed_sweep_chunk_matches_jax_f64(kind, window):
    """The windowed plain sweep, run until no lane in the window has work,
    against `neutral_tpu.transport.sweep_chunk(y_off_dyn=, x_off_dyn=)`
    from one JAX state in float64: event counts exact, the integer and
    mask fields exactly equal, the float fields to 1e-9 (XLA on the CPU
    rounds a few float64 operations differently, by an ulp, and a history
    of hundreds of collisions carries it to ~1e-10: ROADMAP Queue C),
    out-of-window lanes untouched, the window-local tally's sum to 1e-12
    and each cell to 1e-10 (summation order over up to hundreds of flushes
    a cell)."""
    import jax.numpy as jnp
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver
    from neutral_tpu import transport as jtransport

    jcfg = make_cfg(nt, kind, n=600, nx=NX).with_(dt=5e-8)
    cfg = make_cfg(tt, kind, n=600, nx=NX).with_(dt=5e-8)
    x_off, y_off, nx, ny = window
    jglobal = dataclasses.replace(jdriver.make_geometry(jcfg), same_xs=True,
                                  rects=None)
    jgeom = dataclasses.replace(jglobal, nx=nx, ny=ny)
    jstate, jtab, mesh = jax_state(jcfg, jglobal)
    start = to_port(jstate)
    off = lambda v: None if v is None else jnp.int32(v)  # noqa: E731
    inv = 1.0 / cfg.nparticles
    js, jt, jc, _, jwork = jtransport.sweep_chunk(
        jstate, jnp.zeros(nx * ny, jnp.float64),
        jtransport.EventCounts.zeros(), mesh, jtab, jtab, jgeom,
        jnp.uint32(1), inv, 100_000, y_off_dyn=off(y_off),
        x_off_dyn=off(x_off))

    sim = driver.Simulation(cfg, device="cpu", transport="sweep", quiet=True)
    geom, xo, yo = window_geom(sim.geom, window)
    tally = torch.zeros(nx * ny, dtype=torch.float64)
    ts, nf, nc, _, twork = transport.sweep_chunk(
        start.clone(), tally, geom, sim.cs_scatter, sim.cs_absorb, 1, inv,
        100_000, x_off=xo, y_off=yo)
    assert (nf, nc) == jc.totals()
    assert twork == int(jwork) == 0
    assert_states_equal(ts, js, rtol=1e-9)
    np.testing.assert_allclose(tally.sum(), np.asarray(jt).sum(),
                               rtol=1e-12)
    np.testing.assert_allclose(tally.numpy(), np.asarray(jt), rtol=1e-10,
                               atol=1e-300)
    # The window's work: lanes left it, and lanes outside it never moved.
    _, _, inside = transport.window_cells(start, geom, xo, yo)
    outside = ~start.dead & ~inside
    _, _, now_inside = transport.window_cells(ts, geom, xo, yo)
    assert bool(outside.any()) and nf > 0
    assert bool((inside & ~ts.dead & ~now_inside).any())
    for f in STATE_FIELDS:
        assert torch.equal(getattr(ts, f)[outside], getattr(start, f)[outside])


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("kind", ["split", "stream", "scatter"])
def test_windowed_flight_core_matches_jax_f64(kind, window):
    """Successive windowed flight pieces against
    `neutral_tpu.flight.flight_core(x_off=, y_off=)` from the same JAX
    state in float64: every mask, cell and count exactly equal (both
    flushes with their window-local cells, the emit mask, the facet
    counts, the integer state), every float (state, flush values, the
    segments in window-local cell units) to 1e-12, as
    test_torch_flight.py holds the unwindowed piece: XLA on the CPU rounds
    the collision's float64 arithmetic differently by an ulp."""
    import jax.numpy as jnp
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver
    from neutral_tpu import flight as jflight

    jcfg = make_cfg(nt, kind, n=600, nx=NX)
    cfg = make_cfg(tt, kind, n=600, nx=NX)
    x_off, y_off, nx, ny = window
    jglobal = dataclasses.replace(jdriver.make_geometry(jcfg), same_xs=True)
    jgeom = dataclasses.replace(jglobal, nx=nx, ny=ny)
    jstate, jtab, _ = jax_state(jcfg, jglobal)
    sim = driver.Simulation(cfg, device="cpu", transport="flight", quiet=True)
    geom, xo, yo = window_geom(sim.geom, window)
    assert geom.rects == jgeom.rects
    off = lambda v: None if v is None else jnp.int32(v)  # noqa: E731
    inv = 1.0 / cfg.nparticles
    pieces = crossings = 0
    for _ in range(6):
        tstate = to_port(jstate)
        if not bool(transport.working_mask(tstate, geom, xo, yo).any()):
            break
        jp = jflight.flight_core(jstate, jgeom, jtab, jtab, jnp.uint32(1),
                                 inv, jnp.float64, x_off=off(x_off),
                                 y_off=off(y_off))
        tp = flight.flight_core(tstate, geom, sim.cs_scatter, sim.cs_absorb,
                                1, inv, torch.float64, x_off=xo, y_off=yo)
        j = dict(zip(flight.FlightPiece._fields, jp))
        assert_states_equal(tp.state, j["state"], rtol=1e-12)
        for f in ("flush1", "flush2", "emit", "is_coll", "nf_lane"):
            a = getattr(tp, f).numpy()
            np.testing.assert_array_equal(a, np.asarray(j[f]).astype(a.dtype),
                                          err_msg=f)
        for f, mask in (("cell1", "flush1"), ("val1", "flush1"),
                        ("cell2", "flush2"), ("val2", "flush2"),
                        ("p0x", "emit"), ("p0y", "emit"), ("p1x", "emit"),
                        ("p1y", "emit"), ("kk", "emit")):
            m = getattr(tp, mask).numpy()
            a = getattr(tp, f).numpy()[m]
            b = np.asarray(j[f])[m].astype(a.dtype)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=0,
                                           err_msg=f)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)
        cells = torch.cat([tp.cell1[tp.flush1], tp.cell2[tp.flush2]])
        assert bool(((cells >= 0) & (cells < nx * ny)).all())
        _, _, inside = transport.window_cells(tp.state, geom, xo, yo)
        crossings += int((~tp.state.dead & ~inside).sum())
        pieces += 1
        jstate = j["state"]
    assert pieces >= 1 and crossings > 0


@pytest.mark.parametrize("transport_name", ["sweep", "flight"])
def test_whole_mesh_window_is_bitwise_unwindowed(transport_name):
    """A window of the whole mesh at offsets 0 is the unwindowed run, bit
    for bit (float32, as on the card)."""
    cfg = make_cfg(tt, "csp", n=500, nx=NX, dtype="float32")
    sim = driver.Simulation(cfg, device="cpu", transport=transport_name,
                            quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    args = (sim.geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    runs = []
    for win in ({}, {"x_off": 0, "y_off": 0}):
        tally = torch.zeros_like(sim.tally)
        if transport_name == "flight":
            segs = []
            out = flight.flight_chunk_plain(start.clone(), tally, *args,
                                            segments=segs, **win)
            runs.append((out[0], out[1:3], tally, torch.cat(segs)))
        else:
            out = tt.sweep_chunk_plain(start.clone(), tally, *args, **win)
            runs.append((out[0], out[1:3], tally, None))
    (a, ca, ta, sa), (b, cb, tb, sb) = runs
    assert ca == cb and ca[0] > 0
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(ta, tb)
    if sa is not None:
        assert torch.equal(sa, sb)


# ---------------------------------------------------------------------------
# the window modes of the kernels on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("deck,transport_name", [
    ("problems/scatter.params", "sweep"), ("problems/split.params", "flight"),
    ("problems/stream.params", "flight")])
def test_windowed_kernel_matches_plain_on_card(deck, transport_name, dtype):
    """The windowed sweep and flight kernels against their windowed plain
    versions at 65,536 particles on the full decks' geometry, in the 2x2
    block (2000, 2000) that the source box straddles, in float32 and in
    float64 (the kernels' float64 instantiations, bitwise)."""
    cfg = tt.load_config(deck).with_(nparticles=65536, expected_tally=None,
                                     dtype=dtype, tally_dtype=dtype)
    kernel_matches_plain_on_card(cfg, transport_name,
                                 window=(2000, 2000, 2000, 2000))
