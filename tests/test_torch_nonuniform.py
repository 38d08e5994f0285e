"""Decks without a uniform pitch in the port: non-uniform meshes and
`fast_math 0`, against neutral_tpu.

Their geometry has dx = dy = 0: facet distances gather the edge arrays by
global cell (`transport._facet_edges`), and a fast_math 0 deck gathers its
density from the region-built grid.  They run on the sweep transport, as
JAX runs them on its XLA edge-array sweep: on a card through the sweep
kernel's edge-array mode and the begin kernel (`auto` picks the kernel
engine), on the CPU through the plain engine; the flight transport
refuses them before any state is built.  On the CPU, in float64, the
per-step counts must equal JAX's XLA `Simulation` and `neutral_tpu.oracle`
exactly and the tally agree to rtol 1e-9 (the port of
tests/test_nonuniform.py:117-168); float32 lies within 1e-3 of JAX's
float64; four CPU shards give the single-device run's counts.  One event
of the plain `sweep_core`, from one state made with numpy, is held to
`neutral_tpu`'s XLA `sweep_core` (float64 to 1e-12); the kernel is held to
that plain version bitwise by the `cuda` cases, which skip without a card:

    python -m pytest tests/test_torch_nonuniform.py -q -m cuda --noconftest

JAX is imported only inside the tests that compare with it.
"""

import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import (begin_kernel, census, driver, sweep_kernel,
                               transport)
from neutral_tpu_torch.particles import STATE_FIELDS
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


@pytest.mark.parametrize("deck", list(DECKS))
@pytest.mark.parametrize("cls", [SpatialSimulation, Spatial2DSimulation])
def test_four_cpu_shards_match_one_device(cls, deck):
    """y-slabs and 2x2 blocks on four CPU shards: edges indexed by global
    cell (every shard carries the whole mesh's edge arrays), each shard's
    density block gathered (fast_math 0) or the global regions tested
    (fast_math); per-step counts equal to the single-device run's, the
    tally to 1e-12; lanes migrate on the two light decks (the stretched
    deck's lanes, dense and slow, end in the shard they were born in)."""
    cfg = DECKS[deck](tt)
    stats, tally, _ = run_port(deck)
    sim = cls(cfg, devices=CPU4, quiet=True)
    assert sim.engine == "plain" and sim.transport == "sweep"
    geom = sim.shards[-1].geom
    assert geom.edgex.shape == (cfg.nx + 1,)
    assert geom.edgey.shape == (cfg.ny + 1,)
    if cfg.fast_math:
        assert geom.density is None and geom.regions
    else:
        assert geom.density.shape == (sim.rows * sim.cols,)
    assert stats_of(sim) == stats
    if deck != "stretched":
        assert sum(m.nmigrated for m in sim.step_metrics) > 0
    np.testing.assert_allclose(sim.host_tally(), tally, rtol=1e-12,
                               atol=1e-300)


def test_auto_routes_to_plain_sweep():
    """`auto` on a CUDA device gives the kernel engine and the sweep
    transport for decks without a pitch, in float32 and float64 (the sweep
    kernel's edge-array mode and the begin kernel; no card needed to
    decide), as for a uniform deck; on the CPU the plain engine."""
    cuda = torch.device("cuda")
    for dtype in ("float32", "float64"):
        for deck in DECKS:
            cfg = DECKS[deck](tt, dtype=dtype, tally_dtype=dtype)
            assert driver.pick_transport(cfg, "auto") == "sweep"
            assert driver.pick_engine("auto", cuda, getattr(torch, dtype),
                                      cfg) == "kernel"
            assert driver.pick_engine("auto", torch.device("cpu"),
                                      getattr(torch, dtype), cfg) == "plain"
        uniform = light_cfg(tt, dtype=dtype, tally_dtype=dtype)
        assert driver.pick_engine("auto", cuda, getattr(torch, dtype),
                                  uniform) == "kernel"


@pytest.mark.parametrize("deck,match", [
    ("stretched", "uniform mesh"), ("fast_math0", "fast_math"),
    ("stretched_fast_math0", "uniform mesh")])
@pytest.mark.parametrize("how", ["engine", "transport"])
def test_kernel_and_flight_raise_before_state(deck, match, how, monkeypatch,
                                              tmp_path, capsys):
    """--transport flight raises with neutral_tpu's reason (`match`) in
    Simulation.__init__ and in the CLI, before the geometry or any particle
    is made.  --engine kernel (in float32) passes the deck's checks and is
    refused only for want of a card: on a host without one (as this test
    makes every host look) Simulation raises at its device check and the
    CLI exits 2, again before any state."""
    def no_state(*a, **k):
        raise AssertionError("state was built")
    monkeypatch.setattr(driver, "make_geometry", no_state)
    monkeypatch.setattr(census, "inject_particles", no_state)
    cfg = DECKS[deck](tt, dtype="float32", tally_dtype="float32")
    deck = write_deck(cfg.with_(nparticles=10), tmp_path / "deck.params")
    if how == "transport":
        with pytest.raises(ValueError, match=match):
            driver.Simulation(cfg, device="cpu", transport="flight",
                              quiet=True)
        with pytest.raises(ValueError, match=match):
            driver.main([deck, "--transport", "flight", "--device", "cpu"])
        return
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert driver.pick_engine("kernel", torch.device("cuda"), torch.float32,
                              cfg) == "kernel"
    with pytest.raises(RuntimeError, match="is_available"):
        driver.Simulation(cfg, device="cuda", engine="kernel", quiet=True)
    assert driver.main([deck, "--engine", "kernel"]) == 2
    assert "is_available() is False" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the sweep kernel's edge-array mode: its packing on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deck", [*DECKS, "uniform"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sweep_kernel_packs_the_edge_array_mode(deck, dtype):
    """sweep_kernel.edge_mode selects the edge-array mode (1) exactly for
    the decks without a pitch and the pitch mode (0) for a uniform one;
    check_edges accepts the geometry's own edge arrays (global_nx + 1 and
    global_ny + 1 entries in the working type, also under a window) and
    refuses missing, short, mistyped or misplaced ones by name;
    edge_fields packs the mode and the arrays' pointers into both
    parameter layouts."""
    real = getattr(torch, dtype)
    cfg = (light_cfg(tt) if deck == "uniform" else DECKS[deck](tt)).with_(
        dtype=dtype, tally_dtype=dtype)
    geom = driver.make_geometry(cfg, real, "cpu")
    cpu = torch.device("cpu")
    want = int(deck != "uniform")
    assert sweep_kernel.edge_mode(geom) == want
    assert geom.edgex.shape == (cfg.nx + 1,) and geom.edgey.dtype == real
    sweep_kernel.check_edges(geom, real, cpu, "sweep kernel")
    window = dataclasses.replace(geom, nx=cfg.nx // 2, ny=cfg.ny // 2)
    sweep_kernel.check_edges(window, real, cpu, "sweep kernel")
    layout = sweep_kernel._LAYOUTS[(real, real)][0]
    p = layout()
    sweep_kernel.edge_fields(p, geom)
    assert p.edge_mode == want
    assert (p.edgex, p.edgey) == ((geom.edgex.data_ptr(),
                                   geom.edgey.data_ptr()) if want
                                  else (None, None))
    if not want:
        return
    other = torch.float64 if real == torch.float32 else torch.float32
    bad = {"geom.edgex": dataclasses.replace(geom, edgex=None),
           "geom.edgey": dataclasses.replace(geom, edgey=geom.edgey[:-1]),
           "geom.edgex ": dataclasses.replace(
               geom, edgex=geom.edgex.to(other))}
    for name, g in bad.items():
        with pytest.raises(ValueError, match=name.strip()):
            sweep_kernel.check_edges(g, real, cpu, "sweep kernel")
    with pytest.raises(ValueError, match="geom.edgex: expected"):
        sweep_kernel.check_edges(geom, real, torch.device("meta"),
                                 "sweep kernel")


@pytest.mark.parametrize("deck", list(DECKS))
def test_kernels_take_the_deck_up_to_the_device_check(deck):
    """The sweep and begin kernels' wrappers take a deck without a pitch
    through every check of its configuration and refuse its CPU state only
    for the device (the flight kernel's wrapper still asks for a pitch);
    neither runs a plain version."""
    sim = driver.Simulation(DECKS[deck](tt), device="cpu", quiet=True)
    args = (sim.geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0)
    calls = (transport.begin_timestep.calls, sweep_kernel.sweep_chunk_plain
             .calls)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        census.sweep_chunk_kernel(sim.state, sim.tally, *args)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        begin_kernel.begin_timestep_kernel(sim.state, sim.geom,
                                           sim.cs_scatter, 1e-7, 1)
    with pytest.raises(ValueError, match="uniform-pitch"):
        sweep_kernel.check_inputs(sim.state, sim.tally, sim.geom,
                                  sim.cs_scatter, sim.cs_absorb,
                                  "flight kernel", sweep_kernel.REALS)
    assert calls == (transport.begin_timestep.calls,
                     sweep_kernel.sweep_chunk_plain.calls)


# ---------------------------------------------------------------------------
# one event of the plain sweep against neutral_tpu's XLA sweep
# ---------------------------------------------------------------------------

EVENT_N = 2048
EVENT_KEY = 3


def event_state(edgex: np.ndarray, edgey: np.ndarray) -> dict:
    """EVENT_N lanes from a numpy seed, in float64 (pid and counter as
    uint32 values, which both packages hold): cells over the whole mesh,
    each position inside its cell (some on its edges), log-uniform
    energies, a quarter of the lanes dead, clocks, mean free paths and
    deposits that give facets, collisions and censuses."""
    rs = np.random.default_rng(14)
    nx, ny = edgex.shape[0] - 1, edgey.shape[0] - 1
    cx = rs.integers(0, nx, EVENT_N).astype(np.int32)
    cy = rs.integers(0, ny, EVENT_N).astype(np.int32)
    fx = np.where(rs.random(EVENT_N) < 0.05, 0.0, rs.random(EVENT_N))
    fy = np.where(rs.random(EVENT_N) < 0.05, 1.0, rs.random(EVENT_N))
    angle = rs.uniform(0.0, 2.0 * np.pi, EVENT_N)
    return {
        "x": edgex[cx] + fx * (edgex[cx + 1] - edgex[cx]),
        "y": edgey[cy] + fy * (edgey[cy + 1] - edgey[cy]),
        "omega_x": np.cos(angle), "omega_y": np.sin(angle),
        "energy": 10.0 ** rs.uniform(-1.0, 6.0, EVENT_N),
        "weight": rs.random(EVENT_N),
        "dt_to_census": rs.uniform(0.0, 1e-7, EVENT_N),
        "mfp_to_collision": rs.exponential(1.0, EVENT_N),
        "deposit": rs.random(EVENT_N),
        "cellx": cx, "celly": cy,
        "dead": rs.random(EVENT_N) < 0.25,
        "pid": rs.choice(2 ** 32, EVENT_N, replace=False).astype(np.int64),
        "counter": rs.integers(1, 1000, EVENT_N).astype(np.int64),
    }


@functools.cache
def jax_event(deck):
    """(the numpy state, neutral_tpu's XLA sweep_core of it in float64 as
    numpy arrays: the 14 fields, flush, flat_cell, contrib, is_facet,
    is_coll)."""
    import jax.numpy as jnp
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver
    from neutral_tpu import transport as jtransport
    from neutral_tpu.particles import ParticleState as JState

    cfg = DECKS[deck](nt, engine="xla")
    jsim = jdriver.Simulation(cfg, quiet=True)
    assert jsim.geom.dx == 0.0
    fields = event_state(np.asarray(jsim.mesh.edgex),
                         np.asarray(jsim.mesh.edgey))
    jstate = JState(**{
        f: jnp.asarray(v.astype(np.uint32) if f in ("pid", "counter")
                       else v) for f, v in fields.items()})
    out = jtransport.sweep_core(jstate, jsim.mesh, jsim.geom,
                                jsim.cs_scatter, jsim.cs_absorb,
                                jnp.uint32(EVENT_KEY), 1.0 / EVENT_N,
                                jnp.float64)
    state, rest = out[0], out[1:]
    got = {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}
    names = ("flush", "flat_cell", "contrib", "is_facet", "is_coll")
    return fields, got | {k: np.asarray(v) for k, v in zip(names, rest)}


def port_event(deck, dtype):
    """The port's plain transport.sweep_core of jax_event's state in
    `dtype`, as numpy arrays under the same names."""
    fields, _ = jax_event(deck)
    cfg = DECKS[deck](tt, dtype=dtype, tally_dtype=dtype)
    sim = driver.Simulation(cfg, device="cpu", quiet=True)
    state = tt.state_from_numpy(
        {f: v.astype(dtype) if v.dtype == np.float64 else v
         for f, v in fields.items()}, device="cpu")
    out = transport.sweep_core(state, sim.geom, sim.cs_scatter,
                               sim.cs_absorb, EVENT_KEY, 1.0 / EVENT_N,
                               getattr(torch, dtype))
    got = {f: getattr(out[0], f).numpy() for f in STATE_FIELDS}
    names = ("flush", "flat_cell", "contrib", "is_facet", "is_coll")
    return got | {k: v.numpy() for k, v in zip(names, out[1:])}


@pytest.mark.parametrize("deck", list(DECKS))
def test_one_event_matches_jax_float64(deck):
    """float64: the event kinds, cells, dead flags, counters and flat cells
    exactly JAX's; every float field and the tally contributions to rtol
    1e-12 (JAX's lookups round inside XLA, ROADMAP's known differences).
    The state has facets, collisions and censuses."""
    _, want = jax_event(deck)
    got = port_event(deck, "float64")
    for k in ("is_facet", "is_coll", "flush", "flat_cell", "cellx", "celly",
              "dead", "counter"):
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype),
                                      k)
    assert want["is_facet"].sum() > 100 and want["is_coll"].sum() > 100
    assert (want["flush"] & ~want["is_facet"] & ~want["dead"]).sum() > 0
    for k in ("x", "y", "omega_x", "omega_y", "energy", "weight",
              "dt_to_census", "mfp_to_collision", "deposit", "contrib"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("deck", list(DECKS))
def test_one_event_tracks_jax_float64_in_float32(deck):
    """float32 against JAX's float64 on the same state: the event kind of
    all but at most 0.5% of the lanes (those whose two nearest distances
    lie within float32's rounding of each other; XLA also rewrites a
    division by a constant as a product, ROADMAP's known differences), and
    on the lanes whose kind agrees: the cells and counters exactly;
    positions to 1e-5 of the mesh's width; energies, weights and deposits
    to rtol 1e-5; the clock to 1e-4 of dt and the mean free path to 1e-3
    (each a difference that cancels digits); directions to 5e-4 (a forward
    scatter's sine, sqrt(1 - cos^2) with cos near 1, turns one float32 ulp
    of the cosine into ~1e-7 / sin)."""
    _, want = jax_event(deck)
    got = port_event(deck, "float32")
    same = ((got["is_facet"] == want["is_facet"])
            & (got["is_coll"] == want["is_coll"]))
    assert same.mean() >= 0.995, same.mean()
    for k in ("cellx", "celly", "counter", "dead"):
        np.testing.assert_array_equal(
            got[k][same], want[k][same].astype(got[k].dtype), k)
    cfg = DECKS[deck](tt)
    for k, atol in (("x", 1e-5 * cfg.width), ("y", 1e-5 * cfg.height),
                    ("omega_x", 5e-4), ("omega_y", 5e-4),
                    ("dt_to_census", 1e-4 * cfg.dt),
                    ("mfp_to_collision", 1e-3)):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=0,
                                   atol=atol, err_msg=k)
    for k in ("energy", "weight", "deposit"):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# cuda: the edge-array mode against its plain versions, bitwise
# ---------------------------------------------------------------------------

def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bit patterns; others as they are."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["threefry", "pcg64si"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("deck", list(DECKS))
def test_edge_array_kernels_match_plain_on_card(deck, dtype, rng):
    """On the card: the begin kernel against transport.begin_timestep (14
    fields bitwise, the live count) and the sweep kernel's edge-array mode
    against sweep_chunk_plain from that state (counts equal, 14 fields
    bitwise, again at 1 event per launch; the tally to 1e-12 in float64,
    1e-5 in float32: atomics add in another order); then the deck through
    Simulation under auto takes both kernels and no plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = DECKS[deck](tt, dtype=dtype, tally_dtype=dtype, rng=rng,
                      nparticles=4096)
    sim = driver.Simulation(cfg, device="cuda", engine="plain", quiet=True)
    assert sweep_kernel.edge_mode(sim.geom) == 1
    got, live = begin_kernel.begin_timestep_kernel(
        sim.state, sim.geom, sim.cs_scatter, cfg.dt, 1)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    for f in STATE_FIELDS:
        assert torch.equal(bits(getattr(got, f)), bits(getattr(start, f))), f
    assert int(live) == int((~start.dead).sum())
    args = (sim.geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    pt = torch.zeros_like(sim.tally)
    ps, pnf, pnc, _ = sweep_kernel.sweep_chunk_plain(start.clone(), pt, *args)
    assert pnf > 0 and pnc > 0
    for events in (sweep_kernel.MAX_EVENTS, 1):
        kt = torch.zeros_like(pt)
        ks, knf, knc, _ = census.sweep_chunk_kernel(
            start.clone(), kt, *args, max_events=events)
        assert (knf, knc) == (pnf, pnc), events
        for f in STATE_FIELDS:
            assert torch.equal(bits(getattr(ks, f)), bits(getattr(ps, f))), f
        tol = 1e-12 if dtype == "float64" else 1e-5
        torch.testing.assert_close(kt.double(), pt.double(), rtol=tol,
                                   atol=tol * float(pt.abs().max()))
    launches = (census.sweep_chunk_kernel.launches,
                begin_kernel.begin_timestep_kernel.launches)
    plain = (sweep_kernel.sweep_chunk_plain.calls,
             transport.begin_timestep.calls)
    run = driver.Simulation(cfg, device="cuda", quiet=True)
    assert (run.engine, run.transport) == ("kernel", "sweep")
    assert stats_of(run) and np.isfinite(run.host_tally()).all()
    assert census.sweep_chunk_kernel.launches > launches[0]
    assert (begin_kernel.begin_timestep_kernel.launches
            == launches[1] + cfg.niters)
    assert plain == (sweep_kernel.sweep_chunk_plain.calls,
                     transport.begin_timestep.calls)


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
