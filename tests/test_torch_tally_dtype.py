"""A state and a tally of different types: a float32 state with a float64
tally, and a float64 state with a float32 tally, on the plain engine and
on the kernels' mixed instantiations (csrc/sweep_mixed.cu, and the mixed
instantiations of csrc/flight.cu and csrc/raster.cu).

neutral_tpu keeps the two types apart (SimConfig.dtype and tally_dtype);
its XLA engine runs any pair, and its TPU kernels take the tally's type
as their own parameter.  The physics reads no tally: each flush rounds
the accumulated deposit to the tally's type and multiplies by inv_ntotal
in that type, and a flight segment row's kk is (K * seg_len) rounded to
the tally's type, times inv_ntotal in it, rounded to the state's type.

On the CPU, without a card:

- the port's plain engine against JAX's XLA engine on the four 48^2
  families of tests/test_transport.py (and against JAX's flight engine on
  stream, split and csp), step by step, from one JAX-injected state.  A
  float64 state with a float32 tally gives JAX's per-step counts exactly
  and its float32 tally to float32 summation-order rounding (rtol 2e-6 on
  the sum; each cell within 1e-5 of the largest cell).  A float32 state
  with a float64 tally gives the counts and the 14 fields of the port's
  own float32 run bitwise and a tally within 1e-4 of JAX's float64 tally
  (XLA on the CPU rounds float32 otherwise than PyTorch:
  tests/test_torch_transport.py::test_plain_engine_tracks_jax_f32);
- the invariant that physics reads no tally: every pair's per-step
  counts and all 14 fields bitwise those of the run whose tally is of the
  state's type, on both transports, on one device, y-slabs and 2x2 blocks;
  the flight path's segment rows bitwise but kk, which is the plain form
  of the raw K * seg_len, bitwise;
- the routing (every float32/float64 pair takes the kernels of both
  transports on a card), the wrappers' checks (a mixed tally is taken,
  tables or a density grid of the other type are not) and the mixed
  parameter layouts.

The `cuda` cases hold each mixed instantiation to its plain version on
the card at 65,536 lanes: counts and all 14 fields bitwise, segment rows
bitwise, the tally's sum, and each cell against the largest, to 1e-12
(float64 tally) or 1e-5 (float32 tally).  They skip without a card and
run there with

    python -m pytest tests/test_torch_tally_dtype.py -q -m cuda --noconftest
"""

import ctypes
import dataclasses
import functools

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import (census, driver, flight, flight_kernel,
                               raster, raster_kernel, sweep_kernel,
                               transport)
from neutral_tpu_torch.particles import STATE_FIELDS
from neutral_tpu_torch.xs import const, resonance_log_table, write_cs_file

from test_torch_flight import make_cfg

F32, F64 = "float32", "float64"
PAIRS = [(F32, F64), (F64, F32)]
ALL_PAIRS = [(F32, F32), (F32, F64), (F64, F32), (F64, F64)]
FAMILIES = ["scatter", "stream", "csp", "split"]
FLIGHT_FAMILIES = ["stream", "split", "csp"]


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bit patterns (-0.0 differs from 0.0, NaN equals
    itself); others as they are."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_states_bitwise(a, b) -> None:
    for f in STATE_FIELDS:
        assert torch.equal(bits(getattr(a, f)), bits(getattr(b, f))), f


# ---------------------------------------------------------------------------
# the plain engine against JAX's XLA engine
# ---------------------------------------------------------------------------

@functools.cache
def sweep_runs(kind: str, state: str, tally: str):
    """JAX's run_timestep and the port's on family `kind` with a `state`
    state and a `tally` tally, from one JAX-injected state: per step JAX's
    and the port's counts and the port's state, then both tallies.  JAX
    runs only a float64 state: the port's float32 state is held to its
    own float32 run and to JAX's float64 tally."""
    import jax.numpy as jnp

    import neutral_tpu as nt
    from neutral_tpu import mesh as jmesh
    from test_transport import make_problem

    cfg = make_problem(kind)
    jdt, jtd = getattr(jnp, state), getattr(jnp, tally)
    regions = jmesh.region_cell_bounds(cfg)
    dx, dy = cfg.width / cfg.nx, cfg.height / cfg.ny
    jgeom = nt.Geometry(cfg.nx, cfg.ny, cfg.nx, cfg.ny, dx=dx, dy=dy,
                        regions=regions, same_xs=True)
    jtab = nt.CrossSection.resonance(dtype=jdt, analytic=True)
    mesh = nt.build_mesh(cfg, dtype=jdt)
    jstate = nt.inject_particles(
        mesh, nparticles=cfg.nparticles,
        source_x0=cfg.source.xpos * cfg.width,
        source_y0=cfg.source.ypos * cfg.height,
        source_width=cfg.source.width * cfg.width,
        source_height=cfg.source.height * cfg.height,
        initial_energy=cfg.initial_energy, dt=cfg.dt, dtype=jdt,
        local_coords=(dx, dy) if state == F32 else None)
    tstate = tt.state_from_numpy(
        {f: np.asarray(getattr(jstate, f)) for f in STATE_FIELDS})
    tgeom = transport.Geometry(nx=cfg.nx, ny=cfg.ny, dx=dx, dy=dy,
                               regions=regions, same_xs=True)
    ttab = tt.CrossSection.resonance(dtype=getattr(torch, state),
                                     analytic=True)
    jtally = jnp.zeros(cfg.nx * cfg.ny, jtd)
    ttally = torch.zeros(cfg.nx * cfg.ny, dtype=getattr(torch, tally))
    steps = []
    for step in range(1, cfg.niters + 1):
        if state == F64:
            jstate, jtally, counts, nproc, _ = nt.run_timestep(
                jstate, jtally, mesh, jtab, jtab, jgeom, cfg.dt,
                jnp.uint32(step), 1.0 / cfg.nparticles)
        tstate, tnf, tnc, tnproc, _ = transport.run_timestep(
            tstate, ttally, tgeom, ttab, ttab, cfg.dt, step,
            1.0 / cfg.nparticles)
        steps.append(dict(torch=(tnf, tnc, tnproc), state=tstate.clone(),
                          jax=((*counts.totals(), int(nproc))
                               if state == F64 else None)))
    assert ttally.dtype == getattr(torch, tally)
    assert np.asarray(jtally).dtype == np.dtype(tally)
    return steps, np.asarray(jtally), ttally.numpy()


def assert_float32_tally(got: np.ndarray, want: np.ndarray) -> None:
    """Two float32 tallies of the same float32 contributions added in other
    orders (index_add_ against XLA's scatter-add): the sum to rtol 2e-6,
    each cell within 1e-5 of the largest cell."""
    assert got.dtype == want.dtype == np.float32
    ref = want.astype(np.float64)
    assert ref.sum() != 0.0
    assert abs(got.astype(np.float64).sum() - ref.sum()) <= 2e-6 * abs(
        ref.sum())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("state,tally", PAIRS)
@pytest.mark.parametrize("kind", FAMILIES)
def test_plain_sweep_engine_against_jax(kind, state, tally):
    """The sweep transport's plain engine (which the mixed sweep kernels
    are held to bitwise on the card) against JAX's XLA engine, per
    family and pair."""
    steps, jtally, ttally = sweep_runs(kind, state, tally)
    if state == F64:
        for s in steps:
            assert s["torch"] == s["jax"]
        assert_float32_tally(ttally, jtally)
        return
    same, _, _ = sweep_runs(kind, F32, F32)
    for s, s32 in zip(steps, same):
        assert s["torch"] == s32["torch"]
        assert_states_bitwise(s["state"], s32["state"])
    _, jtally64, _ = sweep_runs(kind, F64, F64)
    ref = jtally64.sum()
    assert ttally.dtype == np.float64 and ref != 0.0
    assert abs(ttally.sum() - ref) <= 1e-4 * abs(ref)


@functools.cache
def flight_runs(kind: str, state: str, tally: str):
    """The port's plain flight engine and JAX's flight engine on family
    `kind` (48^2, 64 particles, 2 steps) with a `state` state and a
    `tally` tally: per step each side's counts, the port's last state, and
    both tallies (JAX runs only a float64 state, as in sweep_runs)."""
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver

    cfg = make_cfg(tt, kind, n=64, nx=48).with_(dtype=state,
                                                tally_dtype=tally)
    sim = driver.Simulation(cfg, device="cpu", transport="flight",
                            quiet=True)
    assert (sim.engine, sim.transport) == ("plain", "flight")
    tsteps = [(m.nfacets, m.ncollisions) for m in (sim.step(t)
                                                   for t in (1, 2))]
    assert sim.tally.dtype == getattr(torch, tally)
    if state == F32:
        return tsteps, None, sim.state, None, sim.tally.numpy()
    jcfg = make_cfg(nt, kind, n=64, nx=48).with_(
        dtype=state, tally_dtype=tally, engine="flight")
    jsim = jdriver.Simulation(jcfg, quiet=True)
    jsteps = [(m.nfacets, m.ncollisions) for m in (jsim.step(t)
                                                   for t in (1, 2))]
    return (tsteps, jsteps, sim.state, np.asarray(jsim.tally),
            sim.tally.numpy())


@pytest.mark.parametrize("state,tally", PAIRS)
@pytest.mark.parametrize("kind", FLIGHT_FAMILIES)
def test_plain_flight_engine_against_jax(kind, state, tally):
    """The flight transport's plain engine (which the mixed flight and
    deposit kernels are held to bitwise on the card) against JAX's flight
    engine, per family and pair."""
    tsteps, jsteps, tstate, jtally, ttally = flight_runs(kind, state, tally)
    assert sum(f + c for f, c in tsteps) > 0
    if state == F64:
        assert tsteps == jsteps
        assert_float32_tally(ttally, jtally)
        return
    same_steps, _, same_state, _, _ = flight_runs(kind, F32, F32)
    assert tsteps == same_steps
    assert_states_bitwise(tstate, same_state)
    _, _, _, jtally64, _ = flight_runs(kind, F64, F64)
    ref = jtally64.sum()
    assert ttally.dtype == np.float64 and ref != 0.0
    assert abs(ttally.sum() - ref) <= 1e-4 * abs(ref)


# ---------------------------------------------------------------------------
# the physics reads no tally
# ---------------------------------------------------------------------------

def light_cfg(state: str, tally: str):
    """The split family cut to short histories (32^2, 48 particles, 2 steps
    of 1e-5 s, born at 5 eV over a half of density 30): facets in the
    vacuum half, collisions and deaths (fewer than half the lanes live to
    step 2) in the dense one, and lanes that cross the shards' seams."""
    return make_cfg(tt, "split", n=48, nx=32).with_(
        dtype=state, tally_dtype=tally, initial_energy=5.0, dt=1.0e-5,
        problems=(tt.ProblemRegion(1.0e-30, 0.0, 0.0, 1.0, 0.5),
                  tt.ProblemRegion(30.0, 0.0, 0.5, 1.0, 0.5)))


@functools.cache
def plain_run(state: str, tally: str, transport_name: str,
              decomposition: str | None):
    """Two steps of light_cfg on the CPU's plain engine, on one device or
    4 shards: per-step counts, each shard's state, and the tally's
    dtypes."""
    cfg = light_cfg(state, tally)
    devices = ["cpu"] * (4 if decomposition else 1)
    sim = driver.make_simulation(cfg, decomposition or "replicated",
                                 devices, transport=transport_name,
                                 quiet=True)
    assert (sim.engine, sim.transport) == ("plain", transport_name)
    counts = [(m.nfacets, m.ncollisions, m.nprocessed, m.nmigrated)
              for m in (sim.step(t) for t in (1, 2))]
    tallies = ([sh.tally for sh in sim.shards] if decomposition
               else [sim.tally])
    return counts, sim.states(), {t.dtype for t in tallies}


@pytest.mark.parametrize("decomposition", [None, "spatial", "spatial2d"])
@pytest.mark.parametrize("transport_name", ["sweep", "flight"])
@pytest.mark.parametrize("state,tally", PAIRS)
def test_physics_reads_no_tally(state, tally, transport_name,
                                decomposition):
    """A pair's per-step counts (facets, collisions, live lanes, lanes
    migrated) and all 14 fields of every shard are bitwise those of the
    run whose tally is of the state's type (light_cfg), on both
    transports, on one device, y-slabs and 2x2 blocks; its tally is of the
    tally's type."""
    counts, states, tdtype = plain_run(state, tally, transport_name,
                                       decomposition)
    want, want_states, _ = plain_run(state, state, transport_name,
                                     decomposition)
    assert tdtype == {getattr(torch, tally)}
    assert counts == want
    (f1, c1, n1, _), (_, _, n2, _) = counts
    assert f1 > 0 and c1 > 0 and n2 < n1
    if decomposition:
        assert sum(m for *_, m in counts) > 0
    assert len(states) == len(want_states)
    for a, b in zip(states, want_states):
        assert a.dtype == getattr(torch, state)
        assert_states_bitwise(a, b)


@pytest.mark.parametrize("state,tally", PAIRS)
@pytest.mark.parametrize("kind", ["stream", "csp", "light"])
def test_segment_rows_follow_the_plain_form(kind, state, tally):
    """flight_chunk_plain's segment rows with a `tally` tally against a
    run whose tally is of the state's type at inv_ntotal = 1, whose kk
    column is the raw K * seg_len: the cell coordinates bitwise, and kk
    bitwise ((K * seg_len).to(tally) * inv_ntotal in the tally's type,
    rounded to the state's), as neutral_tpu's flight.py:401 writes it; on
    the stream and csp families (48^2) and light_cfg."""
    cfg = (light_cfg(state, tally) if kind == "light" else make_cfg(
        tt, kind, n=64, nx=48).with_(dtype=state, tally_dtype=tally))
    n = cfg.nx * cfg.ny
    sim = driver.Simulation(cfg, device="cpu", transport="flight",
                            quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    inv = 1.0 / cfg.nparticles
    real, tdt = getattr(torch, state), getattr(torch, tally)
    got, raw = [], []
    flight.flight_chunk_plain(start.clone(), torch.zeros(n, dtype=tdt),
                              sim.geom, sim.cs_scatter, sim.cs_absorb, 1,
                              inv, segments=got)
    flight.flight_chunk_plain(start.clone(), torch.zeros(n, dtype=real),
                              sim.geom, sim.cs_scatter, sim.cs_absorb, 1,
                              1.0, segments=raw)
    got, raw = got[0], raw[0]
    assert got.dtype == raw.dtype == real and got.shape[0] > 0
    assert torch.equal(bits(got[:, :4]), bits(raw[:, :4]))
    kk = (raw[:, 4].to(tdt) * const(inv, tdt)).to(real)
    assert torch.equal(bits(got[:, 4]), bits(kk))
    if tally == F32:
        # a float32 tally's product differs from the float64 one's
        assert not torch.equal(got[:, 4], raw[:, 4] * inv)


# ---------------------------------------------------------------------------
# routing, the wrappers' checks and the mixed layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport_name", ["sweep", "flight"])
@pytest.mark.parametrize("state,tally", ALL_PAIRS)
def test_every_pair_takes_the_kernels_on_a_card(state, tally,
                                                transport_name):
    """`auto` and `kernel` take the kernels on CUDA for every
    float32/float64 (state, tally) pair on both transports; the CPU runs
    the plain engine."""
    cfg = make_cfg(tt, "split", n=64, nx=16, dtype=state).with_(
        tally_dtype=tally)
    dtype = getattr(torch, state)
    assert driver.kernel_refusal(dtype, cfg) is None
    for engine in ("auto", "kernel"):
        assert driver.pick_engine(engine, torch.device("cuda"), dtype,
                                  cfg) == "kernel"
    assert driver.pick_engine("auto", torch.device("cpu"), dtype,
                              cfg) == "plain"
    with pytest.raises(ValueError, match="float32 or float64 tally"):
        driver.pick_engine("kernel", torch.device("cuda"), dtype,
                           cfg.with_(tally_dtype="float16"))
    # the transport decides nothing, so it is no argument
    assert driver.pick_transport(cfg, transport_name) == transport_name


def test_auto_transport_follows_the_state_type():
    """`auto` decides the transport on the state's type alone (JAX's is_f32
    rule): a float32 state with a float64 tally takes the flight transport
    on stream, split and csp, a float64 state with a float32 tally the
    sweep transport."""
    for name in ("stream", "split", "csp"):
        cfg = tt.load_config(f"problems/{name}.params")
        assert driver.auto_transport(cfg.with_(tally_dtype=F64)) == "flight"
        assert driver.auto_transport(cfg.with_(dtype=F64,
                                               tally_dtype=F32)) == "sweep"


@pytest.mark.parametrize("what", ["tally", "table", "grid"])
@pytest.mark.parametrize("state,tally", PAIRS)
def test_kernel_wrappers_take_a_tally_of_either_type(state, tally, what,
                                                     tmp_path):
    """The sweep and flight wrappers take a tally of the other float type
    (on CPU tensors they pass every dtype check and raise at the device
    check, launching nothing), and still raise on stored tables or a
    density grid that are not of the state's type."""
    cfg = make_cfg(tt, "split", n=64, nx=16, dtype=state).with_(
        tally_dtype=tally)
    other = getattr(torch, tally)
    if what == "table":
        keys, values = resonance_log_table(64)
        for name in ("elastic_scatter.cs", "capture.cs"):
            write_cs_file(str(tmp_path / name), keys, values)
        cfg = cfg.with_(params_path=str(tmp_path / "deck.params"))
    sim = driver.Simulation(cfg, device="cpu", quiet=True)
    assert sim.tally.dtype == other
    geom, tabs = sim.geom, (sim.cs_scatter, sim.cs_absorb)
    if what == "table":
        assert not sim.cs_scatter.analytic
        tabs = tuple(dataclasses.replace(t, keys=t.keys.to(other),
                                         values=t.values.to(other))
                     for t in tabs)
    elif what == "grid":
        geom = dataclasses.replace(
            geom, regions=None, density=torch.ones(16 * 16, dtype=other))
    message = "needs CUDA tensors" if what == "tally" else "one working type"
    launches = (census.sweep_chunk_kernel.launches,
                census.flight_chunk_kernel.launches)
    for fn in (census.sweep_chunk_kernel,
               census.flight_chunk_kernel):
        with pytest.raises(ValueError, match=message):
            fn(sim.state, sim.tally, geom, *tabs, 1, 1.0 / 64)
    assert launches == (census.sweep_chunk_kernel.launches,
                        census.flight_chunk_kernel.launches)


def c_layout(fields: list) -> tuple[dict, int]:
    """(offset of each field, size) of a C struct of these (name, ctypes
    type) fields on x86-64: each at the next multiple of its size, the
    whole padded to its largest member."""
    off, offsets, align = 0, {}, 1
    for name, ty in fields:
        size = ctypes.sizeof(ty)
        off = -(-off // size) * size
        offsets[name] = off
        off += size
        align = max(align, size)
    return offsets, -(-off // align) * align


@pytest.mark.parametrize("module", [sweep_kernel, flight_kernel,
                                    raster_kernel])
def test_mixed_param_layouts(module):
    """Each mixed pair has its own layout and entry-point suffix: the
    same-type layout of its state's type with inv_ntotal of the tally's
    type (the deposit's: the same pointers), every offset and the size by
    the C layout rules; the same-type layouts stay those of before."""
    names = {(F32, F64): "_f32t64", (F64, F32): "_f64t32"}
    for (state, tally), sfx in names.items():
        real, tdt = getattr(torch, state), getattr(torch, tally)
        cls, got_sfx = module._LAYOUTS[(real, tdt)]
        same = module._LAYOUTS[(real, real)][0]
        assert got_sfx == sfx and cls is not same
        offsets, size = c_layout(cls._fields_)
        for name, ty in cls._fields_:
            assert getattr(cls, name).offset == offsets[name], name
        assert ctypes.sizeof(cls) == size
        want = [(f, {"float32": ctypes.c_float, "float64": ctypes.c_double}[
            tally] if f == "inv_ntotal" else ty) for f, ty in same._fields_]
        assert cls._fields_ == want
    assert module._LAYOUTS[(torch.float32, torch.float32)][1] == ""
    assert module._LAYOUTS[(torch.float64, torch.float64)][1] == "_f64"


@pytest.mark.parametrize("state,tally", PAIRS)
def test_segment_deposit_takes_rows_into_a_tally_of_the_other_type(state,
                                                                   tally):
    """The deposit's wrapper takes rows of one float type into a tally of
    the other (on CPU tensors it raises at the device check), its buffers
    tile by the tally's type, and FlightBuffers keep their rows in the
    state's type and their budget in its bytes."""
    real, tdt = getattr(torch, state), getattr(torch, tally)
    launches = raster_kernel.deposit_segments_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        raster_kernel.deposit_segments_kernel(
            torch.zeros(32 * 32, dtype=tdt), torch.zeros((4, 5), dtype=real),
            torch.tensor([4]), 32, 32)
    assert raster_kernel.deposit_segments_kernel.launches == launches
    dep = raster_kernel.SegmentDeposit(300, 300, "cpu", dtype=real,
                                       tally_dtype=tdt)
    assert (dep.dtype, dep.tally_dtype) == (real, tdt)
    assert dep.tile == raster_kernel.TILES[tdt]
    assert dep.ntiles == (-(-300 // dep.tile)) ** 2
    b = flight_kernel.FlightBuffers(64, 64, "cpu", dtype=real,
                                    tally_dtype=tdt)
    assert b.segs.dtype == real
    assert b.segs.shape[0] == flight_kernel.seg_rows(flight_kernel.SEG_BYTES,
                                                     real)
    assert (b.deposit.dtype, b.deposit.tally_dtype) == (real, tdt)


# ---------------------------------------------------------------------------
# cuda: each mixed instantiation against its plain version, bitwise
# ---------------------------------------------------------------------------

SWEEP_MODES = [(xs, density, rng, edges) for edges in ("pitch", "array")
               for xs in ("analytic", "table")
               for density in ("regions", "grid") for rng in ("threefry",
                                                              "pcg64si")]
FLIGHT_MODES = [(xs, rng) for xs in ("analytic", "table")
                for rng in ("threefry", "pcg64si")]
CUDA_N = 65536


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def card_cfg(name: str, state: str, tally: str, tmp_path, xs="analytic",
             density="regions", rng="threefry", edges="pitch"):
    """Deck `name` on a 400^2 mesh at CUDA_N particles with a `state`
    state and a `tally` tally, in the given modes (tables and a random
    density grid written to tmp_path)."""
    cfg = tt.load_config(f"problems/{name}.params").with_(
        nx=400, ny=400, nparticles=CUDA_N, expected_tally=None, dtype=state,
        tally_dtype=tally, rng=rng,
        params_path=str(tmp_path / f"{name}.params"))
    if xs == "table":
        keys, values = resonance_log_table()
        for fname in ("elastic_scatter.cs", "capture.cs"):
            write_cs_file(str(tmp_path / fname), keys, values)
    if density == "grid":
        g = np.random.default_rng(7)
        dens = g.uniform(1.0e3, 2.0e4, size=(400, 400))
        dens[g.random((400, 400)) < 0.25] = 0.0
        np.save(tmp_path / "dens.npy", dens)
        cfg = cfg.with_(density_file=str(tmp_path / "dens.npy"))
    if edges == "array":
        cfg = cfg.with_(mesh_stretch_x=1.0002, mesh_stretch_y=0.9998)
    return cfg


def tally_close(got: torch.Tensor, want: torch.Tensor) -> None:
    """The sums, and each cell against the largest, within `tol`: a flush
    into the wrong cell keeps the sum but not the cells."""
    tol = 1e-12 if got.dtype == torch.float64 else 1e-5
    g, w = float(got.double().sum()), float(want.double().sum())
    assert w != 0.0 and abs(g - w) <= tol * abs(w), (g, w)
    err = float((got.double() - want.double()).abs().max())
    peak = float(want.double().abs().max())
    assert err <= tol * peak, (err, peak)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SWEEP_MODES, ids="-".join)
@pytest.mark.parametrize("state,tally", PAIRS)
def test_mixed_sweep_kernel_matches_plain_on_card(state, tally, mode,
                                                  tmp_path):
    needs_card()
    cfg = card_cfg("scatter", state, tally, tmp_path, *mode)
    sim = driver.Simulation(cfg, engine="plain", transport="sweep",
                            quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    args = (sim.geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / CUDA_N)
    pt = torch.zeros_like(sim.tally)
    ps, pnf, pnc, _ = sweep_kernel.sweep_chunk_plain(start.clone(), pt,
                                                     *args)
    launches = census.sweep_chunk_kernel.launches
    kt = torch.zeros_like(pt)
    ks, knf, knc, _ = census.sweep_chunk_kernel(start.clone(), kt,
                                                      *args)
    assert census.sweep_chunk_kernel.launches > launches
    assert (knf, knc) == (pnf, pnc) and pnf + pnc > 0
    assert_states_bitwise(ks, ps)
    assert kt.dtype == getattr(torch, tally)
    tally_close(kt, pt)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", FLIGHT_MODES, ids="-".join)
@pytest.mark.parametrize("state,tally", PAIRS)
def test_mixed_flight_and_deposit_kernels_match_plain_on_card(
        state, tally, mode, tmp_path):
    needs_card()
    xs, rng = mode
    cfg = card_cfg("split", state, tally, tmp_path, xs=xs, rng=rng)
    sim = driver.Simulation(cfg, engine="plain", transport="flight",
                            quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    args = (sim.geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / CUDA_N)
    pt, kt = torch.zeros_like(sim.tally), torch.zeros_like(sim.tally)
    psegs, ksegs = [], []
    ps, pnf, pnc, _, _ = flight.flight_chunk_plain(start.clone(), pt, *args,
                                                   segments=psegs)
    ks, knf, knc, _, _ = census.flight_chunk_kernel(
        start.clone(), kt, *args, segments=ksegs)
    assert (knf, knc) == (pnf, pnc) and pnf > 0
    assert_states_bitwise(ks, ps)
    prows, krows = psegs[0], torch.cat(ksegs)
    assert krows.dtype == prows.dtype == getattr(torch, state)
    key = lambda r: sorted(map(tuple, bits(r).tolist()))   # noqa: E731
    assert key(krows) == key(prows)
    tally_close(kt, pt)
    # the deposit alone on those rows
    nseg = torch.tensor([prows.shape[0]], dtype=torch.int64, device="cuda")
    dk, dp = torch.zeros_like(pt), torch.zeros_like(pt)
    raster_kernel.deposit_segments_kernel(dk, prows.contiguous(), nseg,
                                          400, 400)
    raster.deposit_segments_plain(dp, prows, 400, 400)
    tally_close(dk, dp)


# ---------------------------------------------------------------------------
# measure.py kernels: the names two checkouts are compared by
# ---------------------------------------------------------------------------

KERNEL_NAMES = [
    # (as cu++filt prints a kernel of this tree, its pair, the name
    # measure.py gives it: that of the same kernel before the tally type)
    ("void <unnamed>::sweep_kernel<(nt::XsMode)0, (nt::DensityMode)1, "
     "(nt::RngScheme)1, float, (nt::EdgeMode)0, float>(SweepParamsT<T4, T6>)",
     (F32, F32), "void <unnamed>::sweep_kernel<(nt::XsMode)0, "
     "(nt::DensityMode)1, (nt::RngScheme)1>(SweepParams)"),
    ("void <unnamed>::sweep_kernel<(nt::XsMode)1, (nt::DensityMode)0, "
     "(nt::RngScheme)0, double, (nt::EdgeMode)1, double>(SweepParamsT<T4, "
     "T6>)", (F64, F64), "void <unnamed>::sweep_kernel<(nt::XsMode)1, "
     "(nt::DensityMode)0, (nt::RngScheme)0, double, (nt::EdgeMode)1>"
     "(SweepParams)"),
    ("void <unnamed>::flight_kernel_table<(nt::RngScheme)0, float, float>"
     "(FlightParamsT<T1, T2>)", (F32, F32),
     "void <unnamed>::flight_kernel_table<(nt::RngScheme)0>(FlightParams)"),
    ("void <unnamed>::scan_kernel<double, double>(RasterParamsT<T0, T1>, "
     "int, int)", (F64, F64),
     "void <unnamed>::scan_kernel<double>(RasterParams, int, int)"),
    ("void <unnamed>::count_kernel<float, float>(RasterParamsT<T0, T1>)",
     (F32, F32), "<unnamed>::count_kernel(RasterParams)"),
    ("void <unnamed>::sweep_kernel<(nt::XsMode)1, (nt::DensityMode)1, "
     "(nt::RngScheme)1, double, (nt::EdgeMode)1, float>(SweepParamsT<T4, "
     "T6>)", (F64, F32), None),
    ("void <unnamed>::tile_kernel<float, double>(RasterParamsT<T0, T1>)",
     (F32, F64), None),
    ("void <unnamed>::begin_kernel<(nt::XsMode)1, double, "
     "(nt::EdgeMode)0>(BeginParamsT<T1>)", (F64, F64), None),
    # as GNU c++filt prints them, where the toolkit has no cu++filt
    ("void (anonymous namespace)::flight_kernel_analytic<(nt::RngScheme)1, "
     "double, float>(FlightParamsT<double, float>)", (F64, F32), None),
    ("void (anonymous namespace)::count_kernel<float, float>(RasterParamsT"
     "<float, float>)", (F32, F32),
     "(anonymous namespace)::count_kernel(RasterParams)"),
]


@pytest.mark.parametrize("demangled,pair,name", KERNEL_NAMES)
def test_kernel_names_of_two_checkouts(demangled, pair, name):
    """measure.py kernels names a kernel whose tally is of its working type
    as the same kernel was named before the tally had a type of its own,
    so that a parent's digests compare with this tree's kernel by kernel;
    a mixed pair keeps its whole name; `kernel_pair` reads the (working,
    tally) types from the template arguments (a kernel without a tally,
    the begin kernel, reads as its working type's)."""
    from neutral_tpu_torch import measure

    assert measure.kernel_pair(demangled) == pair
    got = measure._kernel_name(demangled)
    if name is not None:
        assert got == name
    elif pair[0] != pair[1]:
        assert got == demangled


def test_build_times_compile_merged_sources_as_one_unit(tmp_path,
                                                        monkeypatch):
    """measure.py build: one compile a translation unit, the sources of
    `--merge` as one unit that includes each in turn, and one link, every
    rep (an nvcc that records what it was given stands in for the real
    one)."""
    import sys

    from neutral_tpu_torch import build, measure

    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "a = sys.argv[1:]\n"
        "open(a[a.index('-o') + 1], 'w').close()\n"
        "src = a[a.index('-c') + 1] if '-c' in a else 'link'\n"
        f"with open({str(log)!r}, 'a') as f:\n"
        "    f.write(src + '|' + (open(src).read() if src != 'link' "
        "else '') + '@@')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    merge = ["sweep.cu", "sweep_mixed.cu"]
    recs = measure.build_times(2, merge)
    units = {s.name for s in build.sources() if s.suffix == ".cu"}
    want = (units - set(merge)) | {"sweep+sweep_mixed.cu"}
    assert [r["rep"] for r in recs] == [0, 1]
    for r in recs:
        assert set(r["units_s"]) == want and r["merge"] == merge
        assert r["wall_s"] >= r["link_s"] >= 0.0
    calls = [c.split("|", 1) for c in log.read_text().split("@@") if c]
    assert sum(src == "link" for src, _ in calls) == 2
    merged = [text for src, text in calls
              if src.endswith("sweep+sweep_mixed.cu")]
    assert merged == ["".join(f'#include "{build.CSRC_DIR / m}"\n'
                              for m in merge)] * 2
    assert len(calls) == 2 * (len(want) + 1)
    with pytest.raises(SystemExit):
        measure.build_times(1, ["sweep.cu"])
