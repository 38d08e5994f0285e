"""Lanes below 1e-2 eV, and the port's float-to-integer conversions,
against the JAX package, the port's oracle and (on the card) the kernels.

The resonance table's closed-form index takes the root of (E - 1e-2) *
1e-8, which is NaN below 1e-2 eV.  XLA converts a NaN to the integer 0 and
saturates values beyond the type's range; PyTorch on an x86 CPU gives the
type's minimum for all of them.  The port converts through `xs.to_int`,
XLA's conversion, at every floor that such a value can reach, and its CUDA
kernels through `__float2int_rd` (cvt.rmi, the same result).  Here:

- `to_int` equals JAX's `astype` on NaN, +-inf and values past both ends
  of int32 and int64, and PyTorch's own conversion on every value in
  range: bitwise, so no energy at or above 1e-2 eV changes;
- the closed-form index (`lookup_index` on the stored quartic table,
  `_analytic_index`) in float32 and float64 equals JAX's exactly on the
  energies of ENERGIES; so do `TableLayout.index` and the float64 lookup
  of the oracle's searchsorted (`oracle._cs_lookup`, bitwise), except
  that searchsorted sends a NaN past the table's end where the closed form
  sends it to index 0: the values, NaN either way, still agree;
- the cells of injection (`particles._find_cell`), of a flight piece
  (`flight_core`) and of a segment's start (`raster._clipfloor`) for
  positions far outside the mesh equal JAX's exactly;
- tests/test_transport.py's 48x48 scatter family born at 5e-3 eV (every
  lane below 1e-2 eV) and at 1.01e-2 eV (lanes cross 1e-2 eV in their
  first scatters: one elastic scatter off A = 100 loses up to 4%), in
  float64 on the plain engine: JAX's per-step facet, collision and
  processed counts and dead masks exactly and its tally to rtol 1e-9, and
  the oracle's with the tolerances of test_torch_oracle.py (counts and dead
  flags exact; sweep transport: the tally per cell to rtol 1e-9; flight
  transport: the sum to 1e-11 and each cell to 1e-7).  Each asserts that
  some lanes looked their cross-sections up below 1e-2 eV.

The `cuda` case holds the sweep kernel to its plain version on the card on
both decks in float32 (counts and all 14 fields bitwise, tally sums to
1e-5), and skips without one; JAX is imported only inside the tests that
compare with it:

    python -m pytest tests/test_torch_lowenergy.py -q -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver, flight, oracle, particles, raster
from neutral_tpu_torch import transport
from neutral_tpu_torch.particles import STATE_FIELDS
from neutral_tpu_torch.census import sweep_chunk_kernel
from neutral_tpu_torch.sweep_kernel import sweep_chunk_plain
from neutral_tpu_torch.xs import CrossSection, make_resonance_table, to_int

THRESHOLD = 1.0e-2          # the resonance table's lowest key, in eV
ENERGIES = [0.0, 1e-3, 5e-3, 9.99e-3, np.nextafter(1e-2, -np.inf),
            float(np.float32(1e-2)), 1e-2, np.nan, -1.0, np.inf, 1e30]
DECKS = {"born_5e-3": 5.0e-3, "crossing_1.01e-2": 1.01e-2}
DTYPES = {"float32": torch.float32, "float64": torch.float64}
FAR = [1e12, -1e12, np.inf, np.nan, -np.inf, 1e30, 3e9, 0.5]


def family(energy: float, **kw) -> tt.SimConfig:
    """tests/test_transport.py's scatter family (48x48, density 1e4, 30
    particles, 2 steps, float64) born at `energy` eV."""
    return tt.SimConfig(
        nx=48, ny=48, width=1.0, height=1.0, dt=1e-7, niters=2,
        nparticles=30, initial_energy=energy,
        source=tt.SourceBox(0.2, 0.2, 0.6, 0.6),
        problems=(tt.ProblemRegion(1.0e4, 0, 0, 1, 1),), dtype="float64",
        tally_dtype="float64").with_(**kw)


def energies(dtype: str) -> np.ndarray:
    """ENERGIES in `dtype`, with float32's neighbour below 1e-2 in float32."""
    e = np.array(ENERGIES, dtype=dtype)
    if dtype == "float32":
        e = np.append(e, np.nextafter(np.float32(1e-2), np.float32(-np.inf)))
    return e


def below(energy: torch.Tensor) -> int:
    """Lanes whose energy is below 1e-2 eV: each looked its
    cross-sections up there (every sweep looks up every lane's energy, and
    a collision looks up the energy it leaves)."""
    return int((energy < THRESHOLD).sum())


# ---------------------------------------------------------------------------
# the conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itype", ["int32", "int64"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_to_int_is_xla_conversion(dtype, itype):
    """NaN, +-inf and values past both ends equal jnp's astype exactly; in
    range (random and at both ends) to_int equals torch's .to bitwise."""
    import jax.numpy as jnp

    top = float(np.iinfo(itype).max) + 1.0
    edge = np.nextafter(np.array(top, dtype), 0)
    odd = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, top, -2 * top,
                    3 * top], dtype)
    want = np.asarray(jnp.asarray(odd).astype(getattr(jnp, itype)))
    got = to_int(torch.from_numpy(odd), getattr(torch, itype)).numpy()
    np.testing.assert_array_equal(got, want)

    rng = np.random.default_rng(11)
    inside = np.concatenate([
        rng.uniform(-1e4, 1e4, 1000), rng.uniform(-top, top, 1000),
        [0.0, -0.0, 0.5, -0.5, 1.0, -1.0, -top, edge, -edge]]).astype(dtype)
    x = torch.from_numpy(np.clip(inside, -top, edge))
    assert torch.equal(to_int(x, getattr(torch, itype)),
                       x.to(getattr(torch, itype)))


# ---------------------------------------------------------------------------
# the closed-form index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_closed_form_index_matches_jax_and_searchsorted(dtype):
    """Both closed forms equal JAX's index exactly on ENERGIES, and
    TableLayout.index (the kernels' search) on every energy but NaN; the
    lookups' values equal JAX's to rtol 1e-6 in float32 (XLA rewrites the
    analytic keys' division by a constant) and 1e-12 in float64, NaN where
    JAX's is NaN."""
    import jax.numpy as jnp
    import neutral_tpu as nt

    e = energies(dtype)
    te, je = torch.from_numpy(e), jnp.asarray(e)
    ok = ~np.isnan(e)
    stored = tt.CrossSection.resonance(dtype=DTYPES[dtype])
    analytic = tt.CrossSection.resonance(dtype=DTYPES[dtype], analytic=True)
    jstored = nt.CrossSection.resonance(dtype=getattr(jnp, dtype))
    janalytic = nt.CrossSection.resonance(dtype=getattr(jnp, dtype),
                                          analytic=True)
    search = stored.table_layout.index(te).numpy()
    for port, jax_, name in ((stored, jstored, "lookup_index"),
                             (analytic, janalytic, "_analytic_index")):
        got = getattr(port, name)(te).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(getattr(jax_, name)(je)), err_msg=name)
        np.testing.assert_array_equal(got[ok], search[ok], err_msg=name)
        assert got[np.isnan(e)].tolist() == [0]
        np.testing.assert_allclose(
            port.lookup(te).numpy(), np.asarray(jax_.lookup(je)),
            rtol=1e-6 if dtype == "float32" else 1e-12, equal_nan=True,
            err_msg=name)
    assert (search[e < THRESHOLD] == 0).all()


def test_stored_lookup_equals_oracle_bitwise():
    """The float64 stored-table lookup equals the oracle's (searchsorted
    over the same keys and values) bit for bit on ENERGIES, NaN included,
    and on 2,000 energies log-uniform over [1e-6, 1e-2) eV."""
    keys, values = make_resonance_table()
    tab = CrossSection.resonance(dtype=torch.float64)
    rng = np.random.default_rng(5)
    e = np.concatenate([energies("float64"),
                        np.exp(rng.uniform(np.log(1e-6), np.log(1e-2),
                                           2000))])
    got = tab.lookup(torch.from_numpy(e)).numpy()
    want = np.array([oracle._cs_lookup(keys, values, float(x)) for x in e])
    np.testing.assert_array_equal(got.view(np.int64)[~np.isnan(e)],
                                  want.view(np.int64)[~np.isnan(e)])
    assert np.isnan(got[np.isnan(e)]).all() and np.isnan(
        want[np.isnan(e)]).all()


# ---------------------------------------------------------------------------
# the other floors: cells of positions far outside the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_find_cell_far_outside_matches_jax(dtype):
    """Injection's cell of a position far outside the mesh (a source box
    placed there) equals JAX's exactly, on the uniform path."""
    import jax.numpy as jnp
    from neutral_tpu import particles as jparticles

    edges = np.linspace(0.0, 1.0, 49)
    pos = np.array(FAR, dtype)
    got = particles._find_cell(torch.from_numpy(edges.astype(dtype)),
                               torch.from_numpy(pos), 48, 1.0, True)
    want = jparticles._find_cell(jnp.asarray(edges.astype(dtype)),
                                 jnp.asarray(pos), 48, 1.0, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_clipfloor_matches_jax(dtype):
    """A segment row's start cell (raster._clipfloor) equals JAX's exactly
    for positions far outside the grid, NaN and +-inf included."""
    import jax.numpy as jnp
    from neutral_tpu import raster as jraster

    u = np.array(FAR, dtype)
    np.testing.assert_array_equal(
        raster._clipfloor(torch.from_numpy(u), 48).numpy(),
        np.asarray(jraster._clipfloor(jnp.asarray(u), 48)))


@pytest.mark.parametrize("kind", ["stream", "split"])
def test_flight_core_far_outside_matches_jax(kind):
    """One flight piece from JAX's begin_timestep state of the family with
    lanes moved far outside the mesh (x or y at +-1e12, +-inf, NaN): the
    pieces' end cells equal JAX's exactly."""
    import jax.numpy as jnp
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver
    from neutral_tpu import flight as jflight, transport as jtransport

    from test_torch_flight import make_cfg

    cfg, jcfg = make_cfg(tt, kind, n=8, nx=48), make_cfg(nt, kind, n=8, nx=48)
    sim = driver.Simulation(cfg, device="cpu", transport="flight",
                            quiet=True)
    jgeom = dataclasses.replace(jdriver.make_geometry(jcfg), same_xs=True)
    jtab = nt.CrossSection.resonance(dtype=jnp.float64, analytic=True)
    mesh = nt.build_mesh(jcfg, dtype=jnp.float64)
    jstate = nt.inject_particles(
        mesh, nparticles=8, source_x0=jcfg.source.xpos,
        source_y0=jcfg.source.ypos, source_width=jcfg.source.width,
        source_height=jcfg.source.height,
        initial_energy=jcfg.initial_energy, dt=jcfg.dt, dtype=jnp.float64)
    jstate = jtransport.begin_timestep(jstate, mesh, jgeom, jtab, jcfg.dt,
                                       jnp.uint32(1))
    fields = {f: np.array(getattr(jstate, f)) for f in STATE_FIELDS}
    fields["x"][:4] = [1e12, -1e12, np.inf, np.nan]
    fields["y"][4:6] = [1e12, -np.inf]
    jstate = dataclasses.replace(
        jstate, **{f: jnp.asarray(v) for f, v in fields.items()})
    jp = jflight.flight_core(jstate, jgeom, jtab, jtab, jnp.uint32(1),
                             1.0 / 8, jnp.float64)
    tp = flight.flight_core(tt.state_from_numpy(fields), sim.geom,
                            sim.cs_scatter, sim.cs_absorb, 1, 1.0 / 8,
                            torch.float64)
    jstate = dict(zip(flight.FlightPiece._fields, jp))["state"]
    for f in ("cellx", "celly"):
        np.testing.assert_array_equal(getattr(tp.state, f).numpy(),
                                      np.asarray(getattr(jstate, f)), f)


# ---------------------------------------------------------------------------
# decks that live below 1e-2 eV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deck", DECKS)
def test_low_energy_deck_matches_jax_f64(deck):
    """JAX's counts and dead masks exactly per step, its tally to rtol
    1e-9 (the port's float64 plain engine against JAX's run_timestep)."""
    from test_torch_transport import run_both

    steps, jtally, ttally = run_both("scatter", "float64", DECKS[deck])
    for s in steps:
        assert s["torch"] == s["jax"]
        np.testing.assert_array_equal(s["tdead"], s["jdead"])
    assert below(torch.from_numpy(steps[0]["tenergy"])) > 0
    assert jtally.sum() != 0.0
    np.testing.assert_allclose(ttally, jtally, rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("transport_name", ["sweep", "flight"])
@pytest.mark.parametrize("deck", DECKS)
def test_low_energy_deck_matches_oracle_f64(deck, transport_name):
    """The oracle's counts and dead flags exactly; the tally per cell to
    rtol 1e-9 on the sweep transport, the sum to 1e-11 and each cell to
    1e-7 on the flight transport (test_torch_oracle.py's tolerances)."""
    from test_torch_oracle import port_problem

    cfg = family(DECKS[deck])
    assert cfg == port_problem("scatter").with_(initial_energy=DECKS[deck])
    sim = driver.Simulation(cfg, device="cpu", transport=transport_name,
                            quiet=True)
    stats = [dict(nf=m.nfacets, nc=m.ncollisions, nproc=m.nprocessed)
             for m in (sim.step(t) for t in range(1, cfg.niters + 1))]
    tally, ostats, parts = oracle.run_config(cfg)
    assert stats == ostats
    assert below(sim.state.energy) > 0
    assert below(torch.tensor([p.energy for p in parts])) == below(
        sim.state.energy)
    got = sim.host_tally().reshape(tally.shape)
    assert tally.sum() != 0.0
    if transport_name == "sweep":
        np.testing.assert_allclose(got, tally, rtol=1e-9, atol=1e-300)
    else:
        np.testing.assert_allclose(got.sum(), tally.sum(), rtol=1e-11)
        np.testing.assert_allclose(got, tally, rtol=1e-7, atol=1e-30)
    np.testing.assert_array_equal(sim.state.dead.numpy(),
                                  [p.dead for p in parts])


@pytest.mark.cuda
@pytest.mark.parametrize("deck", DECKS)
def test_low_energy_kernel_matches_plain_on_card(deck):
    """The sweep kernel against its plain version on the card, float32,
    65,536 lanes of the family from one begin_timestep state: counts and
    all 14 fields bitwise, tally sums to 1e-5 (atomics reorder adds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = family(DECKS[deck], nparticles=65_536, dtype="float32",
                 tally_dtype="float32")
    sim = driver.Simulation(cfg, device="cuda", engine="plain", quiet=True)
    assert sim.transport == "sweep"
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    args = (sim.geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    kt = torch.zeros(48 * 48, dtype=torch.float32, device="cuda")
    pt = torch.zeros_like(kt)
    ks, knf, knc, _ = sweep_chunk_kernel(start.clone(), kt, *args)
    ps, pnf, pnc, _ = sweep_chunk_plain(start.clone(), pt, *args)
    assert (knf, knc) == (pnf, pnc) and knc > 0
    for f in STATE_FIELDS:
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f
    assert below(ks.energy) > 0
    ksum, psum = float(kt.double().sum()), float(pt.double().sum())
    assert abs(ksum - psum) <= 1e-5 * abs(psum)
