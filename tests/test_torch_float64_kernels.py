"""float64 decks on the card's kernels: the float64 instantiations of the
sweep, begin, lookup, flight and segment-deposit kernels (csrc/sweep.cu,
csrc/begin.cu, csrc/table.cu, csrc/flight.cu, csrc/raster.cu, over
csrc/common.cuh) and the routing that sends float64 decks to them.

float64 is the reference's own precision.  neutral_tpu runs it as device
programs that XLA compiles (transport.py sweep_chunk and begin_timestep,
flight.py flight_chunk_impl and raster.py rasterize_xla), in global
coordinates, and its `auto` never gives a float64 deck the flight engine
(the is_f32 term at neutral_tpu/driver.py:303); `engine="flight"` runs it
there by name.  The port does the same on the card: `auto` takes the
sweep transport and the kernel engine for float64 decks with a float64
tally (with a pitch or, through the edge-array mode, without one); an
explicit `--transport flight --dtype float64` takes the float64 flight
and segment-deposit kernels.

On the CPU, without a card:

- the routing (pick_engine, auto_transport, the refusals, a mixed state
  and tally dtype);
- the float64 analytic grid, bitwise `_key_at`/`_val_at`, and a plain
  mirror of the kernels' grid lookup in float64 bitwise
  `CrossSection.lookup`;
- the float64 `TableLayout` search against the plain float64 lookup and
  JAX's float64 `CrossSection.lookup_index` on census, log-uniform and
  sub-1e-2 eV energies;
- the float64 parameter layouts against the C structs' layout rules;
- the float64 sweep-transport path (the driver's plain engine, which the
  kernels are held to bitwise on the card) against JAX's XLA float64
  engine: the four families of tests/test_transport.py and pcg64si,
  table, grid and window variants, per-step counts exactly equal, the
  tally to rtol 1e-9 (atomics and index_add_ add in other orders);
- the float64 flight path through `driver.main --transport flight
  --dtype float64` against JAX's `engine="flight"` float64 run on the
  stream, split and csp families, and on 2x2 blocks against the single
  device.

The `cuda` cases hold each float64 kernel to its plain float64 version on
the card, bitwise (all 14 fields and the counts), in every mode; they skip
without a card and run there with

    python -m pytest tests/test_torch_float64_kernels.py -q -m cuda --noconftest
"""

import ctypes
import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import (begin_kernel, census, driver, flight_kernel,
                               raster_kernel, sweep_kernel, transport)
from neutral_tpu_torch.particles import STATE_FIELDS, ParticleState
from neutral_tpu_torch.table_kernel import (PROBE_TABLES, probe_energies,
                                            probe_table, table_lookup_kernel)
from neutral_tpu_torch.xs import (CrossSection, TableLayout, const,
                                  resonance_log_table, to_int, write_cs_file)

from test_torch_flight import make_cfg

DECKS = ("scatter", "stream", "split", "csp")
FAMILIES = ("scatter", "stream", "csp", "split")
F64 = torch.float64


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bit patterns (-0.0 differs from 0.0, NaN equals
    itself); others as they are."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def deck(name: str, dtype: str = "float64", **kw):
    cfg = tt.load_config(f"problems/{name}.params")
    return cfg.with_(dtype=dtype, tally_dtype=dtype, **kw)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DECKS)
def test_auto_sends_float64_decks_to_the_sweep_kernels(name):
    """Every shipped deck in float64 takes the sweep transport (JAX's
    is_f32 rule) and, on a CUDA device, the kernel engine; in float32 the
    transports are the old ones."""
    cfg = deck(name)
    assert driver.pick_transport(cfg, "auto") == "sweep"
    assert driver.pick_engine("auto", torch.device("cuda"), F64,
                              cfg) == "kernel"
    assert driver.pick_engine("kernel", torch.device("cuda"), F64,
                              cfg) == "kernel"
    assert driver.pick_engine("auto", torch.device("cpu"), F64,
                              cfg) == "plain"
    f32 = driver.pick_transport(deck(name, "float32"), "auto")
    assert f32 == ("sweep" if name == "scatter" else "flight")


@pytest.mark.parametrize("how", ["simulation", "cli"])
def test_kernel_float64_flight_raises_before_state(how, monkeypatch):
    """--engine kernel --dtype float64 --transport flight is the float64
    flight and segment-deposit kernels' on a CUDA device (`kernel` and
    `auto` both pick them), while `auto` still gives float64 decks the
    sweep transport; on the CPU `--engine kernel` raises before the
    geometry or any particle is made."""
    def no_state(*a, **k):
        raise AssertionError("state made before the refusal")

    monkeypatch.setattr(driver, "make_geometry", no_state)
    monkeypatch.setattr(census, "inject_particles", no_state)
    cfg = deck("stream")
    for engine in ("kernel", "auto"):
        assert driver.pick_engine(engine, torch.device("cuda"), F64,
                                  cfg) == "kernel"
    assert driver.kernel_refusal(F64, cfg) is None
    assert driver.auto_transport(cfg) == "sweep"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        if how == "simulation":
            driver.Simulation(cfg, device="cpu", engine="kernel",
                              transport="flight")
        else:
            driver.main(["problems/stream.params", "--dtype", "float64",
                         "--engine", "kernel", "--transport", "flight",
                         "--device", "cpu"])


@pytest.mark.parametrize("state,tally", [("float64", "float32"),
                                         ("float32", "float64")])
def test_mixed_state_and_tally_dtypes(state, tally):
    """A tally in another dtype than the state: `auto` and `kernel` take
    the kernels on a CUDA device (the mixed instantiations,
    csrc/sweep_mixed.cu), and the sweep kernel's wrapper takes the pair:
    on the CPU it passes every dtype check and raises only at the device
    check, launching nothing."""
    cfg = make_cfg(tt, "scatter", n=64, nx=16, iters=1, dtype=state).with_(
        tally_dtype=tally)
    cuda = torch.device("cuda")
    dtype = getattr(torch, state)
    assert driver.pick_engine("auto", cuda, dtype, cfg) == "kernel"
    assert driver.pick_engine("kernel", cuda, dtype, cfg) == "kernel"
    sim = driver.Simulation(cfg, device="cpu", quiet=True)
    assert sim.tally.dtype == getattr(torch, tally)
    assert sweep_kernel._LAYOUTS[(dtype, sim.tally.dtype)][1] == (
        "_f32t64" if state == "float32" else "_f64t32")
    launches = census.sweep_chunk_kernel.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        census.sweep_chunk_kernel(sim.state, sim.tally, sim.geom,
                                        sim.cs_scatter, sim.cs_absorb, 1,
                                        1.0 / cfg.nparticles)
    assert census.sweep_chunk_kernel.launches == launches


@pytest.mark.parametrize("transport_name", ["auto", "flight"])
def test_cli_prints_the_float64_route(transport_name, capsys):
    """The CLI on the CPU in float64: stream takes the sweep transport
    under auto; `--transport flight` keeps the plain flight engine, named
    in the print."""
    assert driver.main(["problems/stream.params", "--dtype", "float64",
                        "--device", "cpu", "--nparticles", "40",
                        "--mesh-scale", "125", "--iterations", "1",
                        "--transport", transport_name]) == 0
    out = capsys.readouterr().out
    assert "Engine: plain." in out
    want = "sweep" if transport_name == "auto" else "flight"
    assert f"Transport: {want}." in out
    total = float(re.search(r"Final global_energy_tally (\S+)", out)[1])
    assert np.isfinite(total) and total > 0.0


# ---------------------------------------------------------------------------
# the lookups in float64
# ---------------------------------------------------------------------------

def test_float64_analytic_grid_is_key_at_val_at():
    tab = CrossSection.resonance(dtype=F64, analytic=True)
    grid = tab.analytic_grid_in(F64)
    n = tab.nentries
    assert grid.shape == (n, 2) and grid.dtype == F64 and grid.is_contiguous()
    assert tab.analytic_grid_in(F64) is grid            # made once per dtype
    for itype in (torch.int32, torch.int64):
        i = torch.arange(n, dtype=itype)
        assert torch.equal(bits(grid[:, 0]), bits(tab._key_at(i, F64)))
        assert torch.equal(bits(grid[:, 1]), bits(tab._val_at(i, F64)))
    g32 = tab.analytic_grid_in(torch.float32)
    assert g32.dtype == torch.float32 and g32 is not grid
    assert torch.equal(g32[:, 0], tab._key_at(torch.arange(n), torch.float32))


def grid_lookup(energy: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """csrc/common.cuh xs_lookup in plain PyTorch, in the energy's dtype:
    the closed-form first guess i0 (converted as the kernel's floor_int:
    a NaN root below 1e-2 eV to 0), the grid's entries i0 - 1 .. i0 + 2,
    the two nudges picking from them, and the interpolation."""
    n, dtype = grid.shape[0], energy.dtype
    u = torch.sqrt(torch.sqrt((energy - const(1.0e-2, dtype))
                              * const(1.0e-8, dtype)))
    i0 = (to_int(torch.floor(u * const(float(n), dtype)), torch.int32)
          - 1).clamp(0, n - 2)
    gm = grid[(i0 - 1).clamp(min=0)]
    g0 = grid[i0]
    g1 = grid[i0 + 1]
    g2 = grid[(i0 + 2).clamp(max=n - 1)]
    down = energy < g0[:, 0]
    up = energy >= torch.where(down, g0[:, 0], g1[:, 0])
    idx = (i0 - down.to(torch.int32) + up.to(torch.int32)).clamp(0, n - 2)
    d = (idx - i0)[:, None]
    lo = torch.where(d < 0, gm, torch.where(d == 0, g0, g1))
    hi = torch.where(d < 0, g0, torch.where(d == 0, g1, g2))
    return lo[:, 1] + ((energy - lo[:, 0]) / (hi[:, 0] - lo[:, 0])) * (
        hi[:, 1] - lo[:, 1])


def energies64(keys: np.ndarray | None = None,
               count: int = 100_000) -> np.ndarray:
    """float64 energies: `count` log-uniform over [1e-2, 1e8] eV from
    default_rng(13); 1e-2 eV, 1 eV and 1 MeV; 64 random `keys` and their
    neighbours one ulp either side; and energies below 1e-2 eV."""
    rng = np.random.default_rng(13)
    if keys is None:
        keys = CrossSection.resonance(dtype=F64, analytic=True).analytic_grid_in(
            F64)[:, 0].numpy()
    k = keys[rng.choice(keys.shape[0], 64, replace=False)]
    return np.concatenate([
        np.exp(rng.uniform(np.log(1e-2), np.log(1e8), count)),
        [1e-2, 1.0, 1e6], k, np.nextafter(k, np.inf), np.nextafter(k, -np.inf),
        [0.0, 1e-3, 5e-3, 9.99e-3, np.nextafter(1e-2, 0.0)]])


def test_float64_grid_lookup_is_the_plain_lookup_bitwise():
    tab = CrossSection.resonance(dtype=F64, analytic=True)
    e = torch.from_numpy(energies64())
    got = grid_lookup(e, tab.analytic_grid_in(F64))
    assert torch.equal(bits(got), bits(tab.lookup(e)))
    assert torch.isfinite(got[e >= 1.0]).all()


@functools.cache
def census_energies() -> np.ndarray:
    """End-state energies of a float64 plain census of the scatter family
    (48^2, 500 particles) beside the 30,000-entry log table, and the
    same lanes born at 5e-3 eV: energies the kernels look up in a census,
    from 1e3 eV down below 1 eV, and below 1e-2 eV."""
    keys, values = resonance_log_table()
    tab = CrossSection(torch.from_numpy(keys), torch.from_numpy(values))
    out = []
    for e0 in (1.0e3, 5.0e-3):
        cfg = make_cfg(tt, "scatter", n=500, nx=48, iters=1).with_(
            initial_energy=e0)
        sim = driver.Simulation(cfg, device="cpu", quiet=True)
        state, _, _, _, _ = transport.run_timestep(
            sim.state, sim.tally, sim.geom, tab, tab, cfg.dt, 1,
            1.0 / cfg.nparticles)
        out.append(state.energy.numpy())
    return np.concatenate(out)


@pytest.mark.parametrize("table", ["resonance_log", "runs", "n2049"])
@pytest.mark.parametrize("energies", ["census", "log_uniform", "below"])
def test_float64_table_layout_resolves_the_plain_index(table, energies):
    """The kernels' two-level search over a float64 TableLayout (its plain
    mirror, TableLayout.index/lookup): the index of CrossSection's float64
    searchsorted lookup and of JAX's float64 CrossSection.lookup_index,
    and the value bitwise CrossSection.lookup's."""
    import jax.numpy as jnp
    import neutral_tpu as nt

    if table == "resonance_log":
        keys, values = resonance_log_table()
    else:
        keys, values = (a.astype(np.float64) for a in probe_table(table))
    e = {"census": census_energies(),
         "log_uniform": energies64(keys, 20_000),
         "below": np.concatenate([np.geomspace(1e-6, 1e-2, 1000),
                                  census_energies()[-200:]])}[energies]
    tab = CrossSection(torch.from_numpy(keys), torch.from_numpy(values))
    lay = tab.table_layout
    assert lay.intervals.dtype == F64 and lay.coarse.dtype == F64
    et = torch.from_numpy(e)
    idx = lay.index(et)
    assert torch.equal(idx, tab.lookup_index(et))
    jtab = nt.CrossSection(jnp.asarray(keys), jnp.asarray(values))
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jtab.lookup_index(jnp.asarray(e))))
    assert torch.equal(bits(lay.lookup(et)), bits(tab.lookup(et)))
    if energies == "below":
        assert (e < 1e-2).sum() >= 1000


def test_stride_rule_fits_float64_shared_memory():
    """The coarse index keeps at most xs.COARSE_KEYS entries: two float64
    tables' indexes take at most 32 KiB, within a block's default 48 KiB
    of dynamic shared memory."""
    for n in (2, 30_000, 2**20 + 1, 2**31 - 1):
        shift = tt.xs.coarse_shift(n)
        assert ((n - 1) >> shift) + 1 <= tt.xs.COARSE_KEYS
    assert 2 * 8 * tt.xs.COARSE_KEYS <= 48 * 1024


# ---------------------------------------------------------------------------
# the float64 parameter layouts
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("cls32,cls64", [
    (sweep_kernel._SweepParams, sweep_kernel._SweepParams64),
    (begin_kernel._BeginParams, begin_kernel._BeginParams64),
    (flight_kernel._FlightParams, flight_kernel._FlightParams64)])
def test_float64_param_layouts(cls32, cls64):
    """The float64 layouts repeat the float32 ones but for their floats,
    which are doubles on 8-byte boundaries; every offset and the size
    follow the C layout rules (the library checks the size at load), and
    every field before the floats sits at its float32 offset (the sweep
    kernel's edge-array fields come after them: appended, so that no field
    of the pitch-mode kernels moved)."""
    names32 = [f for f, _ in cls32._fields_]
    assert names32 == [f for f, _ in cls64._fields_]
    offsets, size = c_layout(cls64._fields_)
    for name, _ in cls64._fields_:
        assert getattr(cls64, name).offset == offsets[name], name
    assert ctypes.sizeof(cls64) == size
    reals = [f for f, ty in cls64._fields_ if ty is ctypes.c_double]
    assert reals == ([f for f, ty in cls32._fields_ if ty is ctypes.c_float])
    assert reals and all(getattr(cls64, f).size == 8 for f in reals)
    lead = names32[:names32.index(reals[0])]
    assert names32[len(lead):len(lead) + len(reals)] == reals
    assert set(names32[len(lead) + len(reals):]) <= {"edgex", "edgey",
                                                     "edge_mode"}
    for name in lead:
        assert getattr(cls64, name).offset == getattr(cls32,
                                                      name).offset, name
    assert sweep_kernel.REALS == (torch.float32, F64)


def test_float64_raster_param_layout():
    """The segment deposit's float64 layout is the float32 one: its rows
    and tally are pointers, so every field keeps its offset, and the size
    follows the C layout rules; each working type names its own layout
    and tile side."""
    cls32, cls64 = raster_kernel._RasterParams, raster_kernel._RasterParams64
    assert cls32 is not cls64 and cls32._fields_ == cls64._fields_
    offsets, size = c_layout(cls64._fields_)
    for name, _ in cls64._fields_:
        assert getattr(cls64, name).offset == offsets[name], name
        assert getattr(cls32, name).offset == offsets[name], name
    assert ctypes.sizeof(cls64) == ctypes.sizeof(cls32) == size
    assert raster_kernel._LAYOUTS[(torch.float32, torch.float32)] == (
        cls32, "")
    assert raster_kernel._LAYOUTS[(F64, F64)] == (cls64, "_f64")
    assert set(raster_kernel.TILES) == set(sweep_kernel.REALS)
    assert raster_kernel.TILE == raster_kernel.TILES[torch.float32] == 128


# ---------------------------------------------------------------------------
# the float64 sweep-transport path (plain) against JAX's XLA float64 engine
# ---------------------------------------------------------------------------

def steps_of(sim):
    return [(m.nfacets, m.ncollisions, m.nprocessed)
            for m in (sim.step(t) for t in range(1, sim.cfg.niters + 1))]


def variant_cfgs(pkg, variant, tmp_path):
    """The cfg of a variant with `pkg`'s config classes: a family at 48^2
    (threefry), or "pcg64si" (csp under pcg64si), "table" (scatter beside
    the 30,000-entry log tables), "grid" (tests/test_torch_grid.py's grid
    deck) or "window" (the split family for one step, run on 2x2 blocks by
    the port)."""
    if variant in FAMILIES:
        return make_cfg(pkg, variant, n=150, nx=48)
    if variant == "pcg64si":
        return make_cfg(pkg, "csp", n=150, nx=48).with_(rng="pcg64si")
    if variant == "table":
        keys, values = resonance_log_table()
        for name in ("elastic_scatter.cs", "capture.cs"):
            write_cs_file(str(tmp_path / name), keys, values)
        return make_cfg(pkg, "scatter", n=150, nx=48).with_(
            params_path=str(tmp_path / "deck.params"))
    if variant == "grid":
        from test_torch_grid import grid_cfg
        return grid_cfg(pkg, tmp_path, nparticles=150)
    return make_cfg(pkg, "split", n=150, nx=48, iters=1)


@pytest.mark.parametrize("variant", [*FAMILIES, "pcg64si", "table", "grid",
                                     "window"])
def test_float64_sweep_path_matches_jax_xla_f64(variant, tmp_path):
    """The driver's float64 path on the CPU (auto: the sweep transport and
    the plain engine, the kernels' bitwise reference; on 2x2 blocks of 4
    shards for "window") against JAX's XLA float64 engine on one device:
    per-step facet, collision and processed counts exactly equal; the
    tally's sum to rtol 1e-9, the bound tests/test_torch_transport.py
    holds (summation order: index_add_ and XLA's scatter add in other
    orders), and each cell to 1e-9 of the largest cell (a cell that holds
    only a lane's sliver past a corner moves by more than its own 1e-9
    when an ulp of JAX's float64 mean free path moves the lane: ROADMAP's
    known differences)."""
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver

    cfg = variant_cfgs(tt, variant, tmp_path)
    if variant == "window":
        sim = tt.parallel.Spatial2DSimulation(cfg, devices=["cpu"] * 4,
                                              quiet=True)
    else:
        sim = driver.Simulation(cfg, device="cpu", quiet=True)
    assert (sim.transport, sim.engine) == ("sweep", "plain")
    assert sim.coords() == "global"
    got = steps_of(sim)
    jsim = jdriver.Simulation(
        variant_cfgs(nt, variant, tmp_path).with_(engine="xla"), quiet=True)
    assert got == steps_of(jsim)
    assert sum(s[0] + s[1] for s in got) > 0
    jt = np.asarray(jsim.tally, np.float64)
    assert jt.sum() != 0.0
    got_tally = sim.host_tally()
    np.testing.assert_allclose(got_tally.sum(), jt.sum(), rtol=1e-9)
    np.testing.assert_allclose(got_tally, jt, rtol=0.0,
                               atol=1e-9 * np.abs(jt).max())


# ---------------------------------------------------------------------------
# the float64 flight path through the CLI against JAX's float64 flight engine
# ---------------------------------------------------------------------------

def family_deck(path, kind: str) -> str:
    """test_torch_flight.make_cfg's family `kind` at 48^2 and 150
    particles, 2 steps, as a deck file at `path`."""
    cfg = make_cfg(tt, kind, n=150, nx=48)
    s = cfg.source
    with open(path, "w") as f:
        f.write(f"nparticles {cfg.nparticles}\ninitial_energy "
                f"{cfg.initial_energy!r}\ndt {cfg.dt!r}\nnx {cfg.nx}\n"
                f"ny {cfg.ny}\niterations {cfg.niters}\nsource "
                f"xpos={s.xpos!r} ypos={s.ypos!r} width={s.width!r} "
                f"height={s.height!r}\n")
        for i, r in enumerate(cfg.problems):
            f.write(f"problem_{i} density={r.density!r} energy=0.0 "
                    f"xpos={r.xpos!r} ypos={r.ypos!r} width={r.width!r} "
                    f"height={r.height!r}\n")
    return str(path)


def cli_run(capsys, argv: list) -> tuple[list, float, str]:
    """driver.main(argv) on the CPU: (per-step (facets, collisions), the
    tally sum, the output)."""
    assert driver.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    steps = [(int(f), int(c)) for f, c in re.findall(
        r"Facets\s+(\d+)\nCollisions\s+(\d+)", out)]
    total = float(re.search(r"Final global_energy_tally (\S+)", out)[1])
    return steps, total, out


@pytest.mark.parametrize("kind", ["stream", "split", "csp"])
def test_float64_flight_path_matches_jax_flight_f64(kind, capsys, tmp_path):
    """`python -m neutral_tpu_torch DECK --transport flight --dtype
    float64` on the CPU (the plain engine, which the float64 flight and
    deposit kernels are held to bitwise on the card) against JAX's
    `engine="flight"` float64 run of the same family (48^2, 150
    particles, 2 steps): per-step facet and collision counts exactly
    equal, the tally's sum to rtol 1e-12 (the deposits add in other
    orders).  Then on 2x2 blocks (`--shards 4 --decomposition
    spatial2d`): the single device's per-step counts and its tally to
    rtol 1e-12."""
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver

    path = family_deck(tmp_path / f"{kind}.params", kind)
    argv = [path, "--transport", "flight", "--dtype", "float64"]
    steps, total, out = cli_run(capsys, argv)
    assert "Engine: plain." in out and "Transport: flight." in out
    jsim = jdriver.Simulation(make_cfg(nt, kind, n=150, nx=48).with_(
        engine="flight"), quiet=True)
    want = [(m.nfacets, m.ncollisions)
            for m in (jsim.step(t) for t in range(1, 3))]
    assert steps == want and len(steps) == 2
    assert sum(f + c for f, c in steps) > 0
    jt = float(np.asarray(jsim.tally, np.float64).sum())
    assert jt != 0.0
    assert abs(total - jt) <= 1e-12 * abs(jt)
    blocks, btotal, out = cli_run(capsys, [*argv, "--shards", "4",
                                           "--decomposition", "spatial2d"])
    assert "Decomposition: spatial2d, 4 shards" in out
    assert blocks == steps
    assert abs(btotal - total) <= 1e-12 * abs(total)


# ---------------------------------------------------------------------------
# cuda: each float64 kernel against its plain float64 version, bitwise
# ---------------------------------------------------------------------------

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def sweep_matches_plain(cfg, window=None, events=(sweep_kernel.MAX_EVENTS,
                                                  1)):
    """The float64 sweep kernel against sweep_chunk_plain from one float64
    begin_timestep state of `cfg` on the card (in `window`, if given), at
    each of `events` per launch: counts equal, all 14 fields bitwise, the
    tally to 1e-12 (atomicAdd(double*) reorders the adds).  Returns the
    (facets, collisions)."""
    sim = driver.Simulation(cfg, device="cuda", engine="plain",
                            transport="sweep", quiet=True)
    assert sim.dtype == F64
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    geom, win = sim.geom, {}
    if window is not None:
        x_off, y_off, nx, ny = window
        geom = dataclasses.replace(geom, nx=nx, ny=ny)
        win = {"x_off": x_off, "y_off": y_off}
    args = (geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    pt = torch.zeros(geom.nx * geom.ny, dtype=F64, device="cuda")
    ps, pnf, pnc, _ = sweep_kernel.sweep_chunk_plain(start.clone(), pt,
                                                     *args, **win)
    assert pnf + pnc > 0
    for ev in events:
        kt = torch.zeros_like(pt)
        ks, knf, knc, _ = census.sweep_chunk_kernel(
            start.clone(), kt, *args, max_events=ev, **win)
        assert (knf, knc) == (pnf, pnc), ev
        for f in STATE_FIELDS:
            assert torch.equal(bits(getattr(ks, f)), bits(getattr(ps, f))), f
        torch.testing.assert_close(kt, pt, rtol=1e-12, atol=1e-300)
    return pnf, pnc


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["scatter", "pcg64si", "table",
                                     "table_capture", "grid", "window",
                                     "low_energy", "stream"])
def test_float64_sweep_kernel_matches_plain_on_card(variant, tmp_path):
    needs_card()
    window = None
    if variant in ("scatter", "window"):
        cfg = deck("scatter", nparticles=65536, expected_tally=None)
        window = (2000, 2000, 2000, 2000) if variant == "window" else None
    elif variant == "pcg64si":
        cfg = deck("scatter", nparticles=65536, expected_tally=None,
                   rng="pcg64si")
    elif variant.startswith("table"):
        keys, values = resonance_log_table()
        write_cs_file(str(tmp_path / "elastic_scatter.cs"), keys, values)
        if variant == "table_capture":
            keys, values = keys[::10], values[::10] * 0.5
        write_cs_file(str(tmp_path / "capture.cs"), keys, values)
        cfg = deck("scatter", nparticles=65536, expected_tally=None,
                   params_path=str(tmp_path / "scatter.params"))
    elif variant == "grid":
        rng = np.random.default_rng(7)
        dens = rng.uniform(1.0e3, 2.0e4, size=(400, 400))
        dens[rng.random((400, 400)) < 0.25] = 0.0
        np.save(tmp_path / "dens.npy", dens)
        cfg = deck("scatter", nparticles=65536, expected_tally=None,
                   nx=400, ny=400, density_file=str(tmp_path / "dens.npy"))
    elif variant == "low_energy":
        cfg = make_cfg(tt, "scatter", n=65536, nx=48).with_(
            initial_energy=1.01e-2)
    else:
        cfg = deck("stream", nparticles=16384, expected_tally=None)
    sweep_matches_plain(cfg, window)


BEGIN_CASES = [("mixed", "threefry", "regions", "analytic", "none"),
               ("mixed", "pcg64si", "grid", "table", "block"),
               ("mixed", "threefry", "grid", "analytic", "slab"),
               ("mixed", "pcg64si", "regions", "table", "none"),
               ("mixed", "threefry", "regions", "table", "none"),
               ("mixed", "pcg64si", "regions", "analytic", "none"),
               ("born_5e-3", "threefry", "regions", "analytic", "none")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BEGIN_CASES, ids=["-".join(c)
                                                  for c in BEGIN_CASES])
def test_float64_begin_kernel_matches_plain_on_card(case):
    """The begin kernel's float64 instantiations against
    transport.begin_timestep in float64 (tests/test_torch_begin.py's
    cases, lanes below 1e-2 eV among them): all 14 fields bitwise and the
    live count."""
    needs_card()
    from test_torch_begin import DT, KEY, WINDOWS, port_args

    deck_name, scheme, density, xs, window = case
    state, geom, tab, win = port_args(deck_name, scheme, density, xs,
                                      WINDOWS[window], "float64", "cuda")
    before = state.clone()
    got, live = begin_kernel.begin_timestep_kernel(state, geom, tab, DT,
                                                   KEY, **win)
    want = transport.begin_timestep(state, geom, tab, DT, KEY, **win)
    torch.cuda.synchronize()
    for f in STATE_FIELDS:
        assert torch.equal(bits(getattr(got, f)), bits(getattr(want, f))), f
        assert torch.equal(bits(getattr(state, f)),
                           bits(getattr(before, f))), f
    assert int(live) == int((~state.dead).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROBE_TABLES)
def test_float64_lookup_kernel_matches_plain_on_card(name):
    """The lookup kernel's float64 instantiation on the probe tables (in
    float64) at their probe energies: indices those of searchsorted and
    TableLayout.index, values bitwise TableLayout.lookup's and
    CrossSection.lookup's."""
    needs_card()
    keys, values = (a.astype(np.float64) for a in probe_table(name))
    tab = CrossSection(torch.as_tensor(keys, device="cuda"),
                       torch.as_tensor(values, device="cuda"))
    e = torch.as_tensor(probe_energies(keys, 100_000).astype(np.float64),
                        device="cuda")
    lay = tab.table_layout
    got, idx = table_lookup_kernel(lay, e, index=True)
    want = (torch.searchsorted(tab.keys, e, right=True) - 1).clamp(
        0, tab.nentries - 2)
    assert torch.equal(idx.long(), want)
    assert torch.equal(idx.long(), lay.index(e))
    assert torch.equal(bits(got), bits(lay.lookup(e)))
    assert torch.equal(bits(got), bits(tab.lookup(e)))


@pytest.mark.cuda
@pytest.mark.parametrize("deck_name,transport_name", [("scatter", "sweep"),
                                                      ("csp", "flight")])
def test_float64_checkpoint_resumes_bitwise_on_kernels(deck_name,
                                                       transport_name,
                                                       tmp_path):
    """A float64 run on the kernels checkpointed after step 1 and restored
    onto the kernel engine: step 2 gives the uninterrupted run's counts,
    all 14 fields bitwise and the tally; on the sweep kernel (scatter) and
    on the flight and segment-deposit kernels (csp by name on the flight
    transport)."""
    needs_card()
    cfg = deck(deck_name, nparticles=65536, expected_tally=None)
    whole = driver.Simulation(cfg, transport=transport_name, quiet=True)
    assert (whole.engine, whole.transport) == ("kernel", transport_name)
    whole.step(1)
    path = str(tmp_path / "ck.npz")
    whole.checkpoint(path, 1)
    want = whole.step(2)
    resumed = driver.Simulation(cfg, transport=transport_name, quiet=True)
    assert resumed.restore(path) == 1
    got = resumed.step(2)
    assert (got.nfacets, got.ncollisions) == (want.nfacets, want.ncollisions)
    for f in STATE_FIELDS:
        assert torch.equal(bits(getattr(resumed.state, f)),
                           bits(getattr(whole.state, f))), f
    np.testing.assert_allclose(resumed.host_tally(), whole.host_tally(),
                               rtol=1e-12, atol=1e-300)
