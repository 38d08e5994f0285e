"""The start of a census (`begin_timestep`) in the port: the plain version
against the JAX package, the begin kernel's refusals, the steps' choice of
begin by engine and, on the card, the kernel against the plain version.

`neutral_tpu.transport.begin_timestep` resets each live lane's census
clock, draws its mean free path at counter 0 and sets every counter to 1.
One state from a numpy seed (cells over the whole 48x48 mesh, a quarter
of the lanes dead, old mean free paths, clocks and counters that a live
lane must lose and a dead lane keep) goes through it and through
`neutral_tpu_torch.transport.begin_timestep`, over threefry and pcg64si,
region rectangles and a density grid (with vacuum cells, where the mean
free path is inf), the analytic resonance table and the stored
30,000-entry one, no window, a y-slab and a 2x2 block (a grid deck's
density is window-local), and the 48x48 scatter family of
tests/test_torch_lowenergy.py born at 5e-3 eV and at 1.01e-2 eV.  In
float64 every field is bitwise JAX's, the draws too, but the live lanes'
mean free paths: inside JAX's one jit program XLA rounds the
cross-section lookup otherwise than op by op, so they are held to 1e-14
(`test_jax_begin_rounds_its_lookup_as_jit_does` shows where the
difference comes from).  In float32 the counter and the
clock are exact and the mean free path is held to JAX's float64 within
the rounding of the float32 draw and of JAX's own float32 lookup
(`mfp_tolerance`).

The `cuda` test holds `begin_kernel.begin_timestep_kernel` to the plain
version on the card over the same cases, all 14 fields and the live count
exactly equal, and skips without one.  JAX is imported only inside the
test that compares with it:

    python -m pytest tests/test_torch_begin.py -q -m cuda --noconftest
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import begin_kernel, driver, rng, transport
from neutral_tpu_torch.particles import STATE_FIELDS, ParticleState
from neutral_tpu_torch.xs import CrossSection, resonance_log_table

NX = 48
N = 1024
DT = 1e-7
KEY = 3                                   # the master key (the step)
# (x_off, y_off, nx, ny) of a shard's window; None offsets mean none.
WINDOWS = {"none": None, "slab": (None, 24, NX, 24),
           "block": (24, 24, 24, 24)}
# Overlapping rectangles, later ones winning, and cells x >= 40 in none
# (density 0): global cells, whatever the window.
REGIONS = ((0, 40, 0, NX, 1.0e4), (5, 30, 10, 40, 1.0e-30),
           (20, 45, 0, 25, 2.5e3))
# tests/test_torch_lowenergy.py's decks: the scatter family, one region.
FAMILY = ((0, NX, 0, NX, 1.0e4),)
DECKS = {"mixed": None, "born_5e-3": 5.0e-3, "crossing_1.01e-2": 1.01e-2}
CASES = ([("mixed", *c) for c in itertools.product(
    ("threefry", "pcg64si"), ("regions", "grid"), ("analytic", "table"),
    WINDOWS)]
    + [(deck, r, "regions", xs, "none") for deck in DECKS if deck != "mixed"
       for r in ("threefry", "pcg64si") for xs in ("analytic", "table")])
CASE_IDS = ["-".join(c) for c in CASES]


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bit patterns (-0.0 differs from 0.0); others
    as they are."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def numpy_state(deck: str) -> dict:
    """The 14 fields of N lanes from a numpy seed, in float64 (pid and
    counter as uint32 values, which both packages hold)."""
    rs = np.random.default_rng(12)
    e0 = DECKS[deck]
    if e0 is None:
        energy = 10.0 ** rs.uniform(-2.5, 7.0, N)
    else:
        # born at e0, half of the lanes after a scatter (A = 100 keeps at
        # least 96% of the energy): at 1.01e-2 eV those cross 1e-2 eV
        energy = np.where(rs.random(N) < 0.5, e0,
                          e0 * (1.0 - 0.04 * rs.random(N)))
    return {
        "x": rs.random(N), "y": rs.random(N),
        "omega_x": rs.uniform(-1, 1, N), "omega_y": rs.uniform(-1, 1, N),
        "energy": energy, "weight": rs.random(N),
        "dt_to_census": rs.uniform(0.0, DT, N),
        "mfp_to_collision": rs.uniform(0.0, 5.0, N),
        "deposit": rs.random(N),
        "cellx": rs.integers(0, NX, N).astype(np.int32),
        "celly": rs.integers(0, NX, N).astype(np.int32),
        "dead": rs.random(N) < 0.25,
        "pid": rs.choice(2 ** 32, N, replace=False).astype(np.int64),
        "counter": rs.integers(0, 1000, N).astype(np.int64),
    }


def density_grid() -> np.ndarray:
    """A (NX, NX) density grid from a numpy seed, a quarter of it vacuum."""
    rs = np.random.default_rng(5)
    d = rs.uniform(1.0e3, 2.0e4, size=(NX, NX))
    d[rs.random((NX, NX)) < 0.25] = 0.0
    return d


def port_args(deck, scheme, density, xs, window, dtype, device="cpu"):
    """(state, geom, table, {x_off, y_off}) of a case in the port."""
    fields = numpy_state(deck)
    state = tt.state_from_numpy(
        {f: v.astype(dtype) if v.dtype == np.float64 else v
         for f, v in fields.items()}, device=device)
    tdtype = getattr(torch, dtype)
    if xs == "analytic":
        tab = CrossSection.resonance(dtype=tdtype, analytic=True,
                                     device=device)
    else:
        keys, values = resonance_log_table()
        tab = CrossSection(torch.as_tensor(keys, dtype=tdtype, device=device),
                           torch.as_tensor(values, dtype=tdtype,
                                           device=device))
    x_off, y_off, nx, ny = window or (None, None, NX, NX)
    grid = None
    if density == "grid":
        xo, yo = x_off or 0, y_off or 0
        grid = torch.as_tensor(
            density_grid()[yo:yo + ny, xo:xo + nx].reshape(-1), dtype=tdtype,
            device=device)
    geom = transport.Geometry(
        nx=nx, ny=ny, dx=1.0 / NX, dy=1.0 / NX,
        regions=None if density == "grid" else (
            REGIONS if DECKS[deck] is None else FAMILY),
        rng_scheme=scheme, same_xs=True, density=grid, global_nx=NX,
        global_ny=NX)
    return state, geom, tab, {"x_off": x_off, "y_off": y_off}


def jax_begin(deck, scheme, density, xs, window):
    """neutral_tpu.transport.begin_timestep of the case, float64."""
    import jax.numpy as jnp
    import neutral_tpu as nt
    from neutral_tpu import transport as jtransport
    from neutral_tpu.mesh import Mesh2D
    from neutral_tpu.particles import ParticleState as JState

    fields = numpy_state(deck)
    jstate = JState(**{
        f: jnp.asarray(v.astype(np.uint32) if f in ("pid", "counter")
                       else v) for f, v in fields.items()})
    jtab = jax_table(xs, "float64")
    x_off, y_off, nx, ny = window or (None, None, NX, NX)
    xo, yo = x_off or 0, y_off or 0
    edges = jnp.linspace(0.0, 1.0, NX + 1)
    mesh = Mesh2D(NX, NX, 1.0, 1.0, edges, edges,
                  jnp.asarray(density_grid()[yo:yo + ny, xo:xo + nx]))
    jgeom = nt.Geometry(
        NX, NX, nx, ny, dx=1.0 / NX, dy=1.0 / NX,
        regions=None if density == "grid" else (
            REGIONS if DECKS[deck] is None else FAMILY),
        rng_scheme=scheme, same_xs=True)
    off = lambda v: None if v is None else jnp.int32(v)  # noqa: E731
    out = jtransport.begin_timestep(jstate, mesh, jgeom, jtab, DT,
                                    jnp.uint32(KEY), y_off_dyn=off(y_off),
                                    x_off_dyn=off(x_off))
    return {f: np.asarray(getattr(out, f)) for f in STATE_FIELDS}


def jax_table(xs: str, dtype: str):
    """The case's neutral_tpu.CrossSection in `dtype`."""
    import jax.numpy as jnp
    import neutral_tpu as nt

    jdtype = getattr(jnp, dtype)
    if xs == "analytic":
        return nt.CrossSection.resonance(dtype=jdtype, analytic=True)
    keys, values = resonance_log_table()
    return nt.CrossSection(jnp.asarray(keys, jdtype),
                           jnp.asarray(values, jdtype))


def jax_lookup(xs: str, energy: np.ndarray, dtype: str) -> np.ndarray:
    """neutral_tpu's scatter cross-section of `energy` (cast to `dtype`)
    from the case's table in `dtype`, as float64."""
    import jax.numpy as jnp

    return np.asarray(jax_table(xs, dtype).lookup(
        jnp.asarray(energy, getattr(jnp, dtype))), dtype=np.float64)


def mfp_tolerance(scheme: str, want: np.ndarray, pid: torch.Tensor,
                  sig32: np.ndarray, sig64: np.ndarray) -> np.ndarray:
    """Per lane, how far a float32 mean free path -log(u) / mac_s may lie
    from the float64 one `want`, from what float32 rounds:

    - the draw: the float32 draw keeps the high 32 bits of the word, hi *
      2^-32 + 2^-33, and rounds that to float32, so it lies within 2^-33 +
      2^-24 u of the float64 draw u, and -log(u) moves by up to 2^-33 / u
      + 2^-24, in units of the lane's 1 / mac_s = want / -log(u);
    - the lookup: mac_s scales with the scatter cross-section, so the
      float32 value differs by |sig64 - sig32| / sig32 of it, both from
      the JAX package (its float32 and float64 lookups), never from the
      port's lookup under test.  Above 1e-2
      eV that is below 2e-7 here; below it the closed-form index's NaN
      root sends the lookup to index 0 and the interpolation extrapolates
      over the table's first two keys, which lie closer than float32's
      spacing at 1e-2 (tests/test_torch_lowenergy.py holds the lookup
      there to JAX's): up to 0.6% here;
    - mac_s's products, the logarithm and the division: 1e-6 of the value
      (the injection tests' float32 tolerance).
    """
    u = rng.uniform2_scheme(pid, KEY, 0, torch.float64, scheme)[0].numpy()
    draw = (2.0 ** -33 / u + 2.0 ** -24) * want / -np.log(u)
    lookup = np.abs(sig64 - sig32) / np.abs(sig32)
    return (1e-6 + lookup) * np.abs(want) + draw


@pytest.mark.parametrize("deck,scheme,density,xs,window", CASES,
                         ids=CASE_IDS)
def test_plain_begin_matches_jax(deck, scheme, density, xs, window):
    """float64: all 14 fields bitwise JAX's but the live lanes' mean free
    paths, which agree to 1e-14 (3 ulps).  float32: counter and
    dt_to_census exact (dt rounded once to float32), the other fields
    the input's, and mfp_to_collision within mfp_tolerance of JAX's
    float64 (inf where the density is 0, on both sides); the deck's
    lanes below 1e-2 eV must be there."""
    want = jax_begin(deck, scheme, density, xs, WINDOWS[window])
    state, geom, tab, win = port_args(deck, scheme, density, xs,
                                      WINDOWS[window], "float64")
    got = transport.begin_timestep(state, geom, tab, DT, KEY, **win)
    live = ~want["dead"]
    assert live.any() and (~live).any()
    assert np.all(want["counter"] == 1)
    for f in STATE_FIELDS:
        a = getattr(got, f).numpy()
        b = want[f].astype(a.dtype)
        if f == "mfp_to_collision":
            # JAX's begin compiles the lookup into its one jit program,
            # where XLA rounds it otherwise than op by op: the mean free
            # path differs by up to 3 ulps on a share of the live lanes
            # (ROADMAP's known differences; test_jax_begin_rounds_its_
            # lookup_as_jit_does shows it); the draw is the port's bits
            np.testing.assert_allclose(a[live], b[live], rtol=1e-14, err_msg=f)
            a, b = a[~live], b[~live]
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), f)

    state32, geom32, tab32, win = port_args(deck, scheme, density, xs,
                                            WINDOWS[window], "float32")
    got32 = transport.begin_timestep(state32, geom32, tab32, DT, KEY, **win)
    np.testing.assert_array_equal(got32.counter.numpy(), want["counter"])
    np.testing.assert_array_equal(
        got32.dt_to_census.numpy(),
        np.where(live, np.float32(DT), np.float32(0.0)))
    for f in set(STATE_FIELDS) - set(begin_kernel.CHANGED):
        assert getattr(got32, f) is getattr(state32, f), f
    mfp = got32.mfp_to_collision.numpy().astype(np.float64)
    old = state32.mfp_to_collision.numpy().astype(np.float64)
    np.testing.assert_array_equal(mfp[~live], old[~live])
    w = want["mfp_to_collision"]
    vacuum = live & np.isinf(w)
    np.testing.assert_array_equal(np.isinf(mfp[live]), vacuum[live])
    assert vacuum.any() == (density == "grid" or deck == "mixed")
    assert (state.energy < 1.0e-2).any()
    ok = live & ~vacuum
    energy = numpy_state(deck)["energy"]
    tol = mfp_tolerance(scheme, w, state.pid,
                        jax_lookup(xs, energy, "float32"),
                        jax_lookup(xs, energy, "float64"))
    err = np.abs(mfp[ok] - w[ok])
    assert np.all(err <= tol[ok]), (
        f"mfp_to_collision: {int((err > tol[ok]).sum())} lanes beyond the "
        f"tolerance, worst {np.max(err / tol[ok]):.3g}x")


@pytest.mark.parametrize("xs", ["analytic", "table"])
def test_jax_begin_rounds_its_lookup_as_jit_does(xs):
    """Where the float64 mean free paths of JAX's begin and the port's
    differ: recomputed in the plain order, -log(r0) / (((density *
    INV_MOLAR) * sig) * BARNS) with numpy, from the port's float64 draw
    and jax.jit(lookup)'s cross-sections, they equal JAX's begin on all
    but under 1% of the live lanes, while the port's (eager lookup)
    differ on more.  In analytic mode XLA turns the grid key's division by
    the entry count into a product with its rounded reciprocal; the
    stored table's interpolation rounds otherwise on a few lanes."""
    import jax
    import jax.numpy as jnp

    deck = "mixed"
    want = jax_begin(deck, "threefry", "regions", xs, None)
    state, geom, tab, win = port_args(deck, "threefry", "regions", xs, None,
                                      "float64")
    got = transport.begin_timestep(state, geom, tab, DT, KEY, **win)
    fields = numpy_state(deck)
    density = np.zeros(N)
    for x0, x1, y0, y1, rho in REGIONS:
        inside = ((fields["cellx"] >= x0) & (fields["cellx"] < x1)
                  & (fields["celly"] >= y0) & (fields["celly"] < y1))
        density = np.where(inside, rho, density)
    sig = np.asarray(jax.jit(jax_table(xs, "float64").lookup)(
        jnp.asarray(fields["energy"])))
    r0 = rng.uniform2_scheme(state.pid, KEY, 0, torch.float64,
                             "threefry")[0].numpy()
    with np.errstate(divide="ignore"):
        mfp = -np.log(r0) / (((density * transport._INV_MOLAR) * sig)
                             * tt.constants.BARNS)
    w = want["mfp_to_collision"]
    lanes = ~want["dead"] & np.isfinite(w)
    jit_order = np.mean(mfp[lanes] != w[lanes])
    port = np.mean(got.mfp_to_collision.numpy()[lanes] != w[lanes])
    assert jit_order < 0.01 and port > jit_order, (jit_order, port)


@pytest.mark.parametrize("what", ["cpu", "float64", "no_pitch"])
def test_begin_kernel_refuses(what):
    """The wrapper raises ValueError on CPU tensors and on a float64 state
    beside a float32 density grid (the kernel has float64 instantiations,
    but takes one working type), and never runs the plain version.  A
    geometry without a pitch (dx = dy = 0, no edge arrays: the kernel reads
    no facet edge) passes every check of its configuration and is refused
    only at the device check, as a CPU state with a pitch is."""
    dtype = "float64" if what == "float64" else "float32"
    state, geom, tab, win = port_args(
        "mixed", "threefry", "grid" if what == "float64" else "regions",
        "analytic", None, dtype)
    if what == "no_pitch":
        geom = dataclasses.replace(geom, dx=0.0, dy=0.0)
    if what == "float64":
        geom = dataclasses.replace(geom, density=geom.density.float())
    message = {"cpu": "needs CUDA tensors", "float64": "one working type",
               "no_pitch": "needs CUDA tensors"}[what]
    launches = begin_kernel.begin_timestep_kernel.launches
    with pytest.raises(ValueError, match=message):
        begin_kernel.begin_timestep_kernel(state, geom, tab, DT, KEY, **win)
    assert begin_kernel.begin_timestep_kernel.launches == launches


def test_begin_census_chooses_by_engine(monkeypatch):
    """begin_census: the kernel engine takes begin_timestep_kernel, the
    plain engine transport.begin_timestep (its state and (~dead).sum())."""
    state, geom, tab, win = port_args("mixed", "threefry", "grid",
                                      "analytic", WINDOWS["block"],
                                      "float32")
    calls = []
    monkeypatch.setattr(begin_kernel, "begin_timestep_kernel",
                        lambda *a: calls.append(a) or ("kernel", None))
    assert begin_kernel.begin_census("kernel", state, geom, tab, DT, KEY,
                                     **win) == ("kernel", None)
    assert calls == [(state, geom, tab, DT, KEY, 24, 24)]
    got, live = begin_kernel.begin_census("plain", state, geom, tab, DT, KEY,
                                          **win)
    want = transport.begin_timestep(state, geom, tab, DT, KEY, **win)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert live.shape == (1,) and live.dtype == torch.int64
    assert int(live) == int((~state.dead).sum())
    assert len(calls) == 1


@pytest.mark.parametrize("decomposition", [None, "spatial2d"])
def test_steps_choose_begin_by_engine(monkeypatch, decomposition):
    """The steps start each census through begin_census: on the plain
    engine transport.begin_timestep once a census and shard, its live
    count the step's processed count; on the kernel engine the begin
    kernel, which on the CPU raises before any census runs."""
    from test_torch_flight import make_cfg

    cfg = make_cfg(tt, "scatter", n=60, nx=16, iters=1, dtype="float32")
    def make():
        if decomposition is None:
            return driver.Simulation(cfg, device="cpu", quiet=True)
        return driver.make_simulation(cfg, decomposition, ["cpu"] * 4,
                                      quiet=True)

    monkeypatch.setattr(transport.begin_timestep, "calls", 0)
    sim = make()
    m = sim.step(1)
    assert transport.begin_timestep.calls == (
        1 if decomposition is None else 4)
    assert m.nprocessed == cfg.nparticles
    sim = make()
    sim.engine = "kernel"
    with pytest.raises(ValueError, match="begin kernel needs CUDA"):
        sim.step(1)
    assert transport.begin_timestep.calls == (
        1 if decomposition is None else 4)


@pytest.mark.cuda
@pytest.mark.parametrize("deck,scheme,density,xs,window", CASES,
                         ids=CASE_IDS)
def test_begin_kernel_matches_plain_on_card(deck, scheme, density, xs,
                                            window):
    """The begin kernel against transport.begin_timestep on the card, in
    float32: all 14 fields and the live count exactly equal, the caller's
    state unchanged, the launch counted; again over 70,000 lanes
    (several blocks a thread's stride) made of the same lanes repeated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state, geom, tab, win = port_args(deck, scheme, density, xs,
                                      WINDOWS[window], "float32", "cuda")
    reps = -(-70_000 // N)
    big = ParticleState(**{f: getattr(state, f).repeat(reps)
                           for f in STATE_FIELDS})
    for s in (state, big):
        before = s.clone()
        launches = begin_kernel.begin_timestep_kernel.launches
        got, live = begin_kernel.begin_timestep_kernel(s, geom, tab, DT, KEY,
                                                       **win)
        want = transport.begin_timestep(s, geom, tab, DT, KEY, **win)
        torch.cuda.synchronize()
        assert begin_kernel.begin_timestep_kernel.launches == launches + 1
        for f in STATE_FIELDS:
            assert torch.equal(bits(getattr(got, f)),
                               bits(getattr(want, f))), f
            assert torch.equal(getattr(s, f), getattr(before, f)), f
        assert int(live) == int((~s.dead).sum())
