"""Source injection in the port: the inject kernel's refusals and
parameter layout, the shards' choice of injection by engine
(census.new_shard, for `Simulation` and for a decomposition's shards)
and, on the card, the kernel against the plain version.

`inject_kernel.inject_particles_kernel` computes in one launch of
csrc/inject.cu what `particles.inject_particles` computes in eager
operations.  The `cuda` tests hold the kernel to the plain version on the
card, all 14 fields bitwise (bit patterns), over float32 and float64,
threefry and pcg64si, a uniform and a stretched mesh, the global and the
cell-local frame (cell-local in float32 only, as `Simulation` uses it),
at 1, 1,024 and 70,000 lanes, over a spatial shard's vector of pids
against `particles.inject_fields`, and over the scatter, csp and stream
decks at their own particle counts through `Simulation` on the kernel
engine (one counted launch each); they skip without a card:

    python -m pytest tests/test_torch_inject.py -q -m cuda --noconftest
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import census, driver, inject_kernel, parallel
from neutral_tpu_torch.mesh import build_mesh
from neutral_tpu_torch.particles import (STATE_FIELDS, inject_fields,
                                         inject_particles, source_cells)

ROOT = Path(__file__).resolve().parent.parent
NX = 48
LANES = (1, 1024, 70_000)
MESHES = {"uniform": {}, "stretched": {"mesh_stretch_x": 1.03,
                                       "mesh_stretch_y": 0.97}}
CARD_CASES = [(d, r, m, f) for d in ("float32", "float64")
              for r in inject_kernel.SCHEMES for m in MESHES
              for f in ("global", "cell-local")
              if d == "float32" or f == "global"]


def deck(dtype="float32", mesh="uniform", rng="threefry"):
    """A 48^2 deck on a 3.7 x 2.3 domain (a pitch that no float holds
    exactly), its source box over the whole domain, so that lanes land
    in every cell and beside its edges."""
    P, S = tt.ProblemRegion, tt.SourceBox
    return tt.SimConfig(nx=NX, ny=NX, width=3.7, height=2.3, dt=1e-7,
                        niters=1, nparticles=100, initial_energy=1.0e3,
                        source=S(0.0, 0.0, 1.0, 1.0),
                        problems=(P(1.0e4, 0, 0, 1, 1),), dtype=dtype,
                        tally_dtype=dtype, rng=rng, **MESHES[mesh])


def inject_args(cfg, frame: str, device) -> dict:
    """inject_particles' keyword arguments for `cfg` in `frame` (the
    cell-local frame with the uniform pitch, on any mesh)."""
    local = ((cfg.width / cfg.nx, cfg.height / cfg.ny)
             if frame == "cell-local" else None)
    return dict(source_x0=cfg.source.xpos * cfg.width,
                source_y0=cfg.source.ypos * cfg.height,
                source_width=cfg.source.width * cfg.width,
                source_height=cfg.source.height * cfg.height,
                initial_energy=cfg.initial_energy, dt=cfg.dt,
                dtype=getattr(torch, cfg.dtype), rng_scheme=cfg.rng,
                local_coords=local, device=device)


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bit patterns (-0.0 differs from 0.0); others as
    they are."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bitwise(got, want) -> None:
    for f in STATE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.device == b.device, f
        assert torch.equal(bits(a), bits(b)), (
            f"{f}: {int((bits(a) != bits(b)).sum())} of {a.numel()} lanes "
            "differ")


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what,match", [
    ("cpu", "inject kernel needs CUDA"),
    ("float16", "no torch.float16 instantiation"),
    ("scheme", "unknown rng scheme 'philox'")])
def test_inject_kernel_refuses(what, match):
    """The wrapper raises ValueError on a CPU mesh, on a working type it
    has no instantiation of and on an unknown draw scheme, launches
    nothing and never runs the plain version."""
    cfg = deck()
    mesh = build_mesh(cfg, torch.float32, "cpu")
    kw = inject_args(cfg, "global", "cpu")
    if what == "float16":
        kw["dtype"] = torch.float16
    if what == "scheme":
        kw["rng_scheme"] = "philox"
    launches = inject_kernel.inject_particles_kernel.launches
    with pytest.raises(ValueError, match=match):
        inject_kernel.inject_particles_kernel(mesh, nparticles=10, **kw)
    assert inject_kernel.inject_particles_kernel.launches == launches


@pytest.mark.parametrize("engine", ["kernel", "plain"])
@pytest.mark.parametrize("kind", ["scatter", "csp"])
def test_simulation_injects_by_engine(monkeypatch, engine, kind):
    """Simulation injects through inject_particles_kernel on the kernel
    engine, once, with inject_particles' own arguments (the cell-local
    frame on the sweep transport in float32, the global one on the
    flight transport), and through inject_particles on the plain engine,
    without calling the kernel; here a stand-in that runs the plain
    version takes the kernel's place, so both give the plain state."""
    from test_torch_flight import make_cfg

    cfg = make_cfg(tt, kind, n=200, nx=16, iters=1, dtype="float32")
    calls = []

    def stand_in(mesh, **kw):
        calls.append(kw)
        return inject_particles(mesh, **kw)

    monkeypatch.setattr(census, "inject_particles_kernel", stand_in)
    monkeypatch.setattr(driver, "pick_engine", lambda *a: engine)
    plain_calls = inject_particles.calls
    sim = driver.Simulation(cfg, device="cpu", quiet=True)
    assert sim.engine == engine
    # the plain version counts its calls: here the stand-in's, or the
    # plain engine's own
    assert inject_particles.calls == plain_calls + 1
    assert sim.coords() == ("cell-local" if kind == "scatter" else "global")
    want = inject_particles(
        sim.mesh, nparticles=cfg.nparticles,
        initial_energy=cfg.initial_energy, dt=cfg.dt, dtype=torch.float32,
        device=sim.device, **sim.source())
    assert_bitwise(sim.state, want)
    if engine == "plain":
        assert calls == []
        return
    assert len(calls) == 1
    kw = calls[0]
    assert kw["nparticles"] == cfg.nparticles and kw["pid"] is None
    assert kw["dtype"] == torch.float32 and kw["device"] == sim.device
    assert kw["local_coords"] == ((sim.geom.dx, sim.geom.dy)
                                  if kind == "scatter" else None)


def shard_pids(cfg, device, slabs=2) -> list:
    """The pid vector of each of `slabs` y-slabs of `cfg`: the pids whose
    birth cell lies in the slab (SpatialSimulation's partition), computed
    here from source_cells."""
    mesh = build_mesh(cfg, getattr(torch, cfg.dtype), device)
    kw = inject_args(cfg, "global", device)
    pid = torch.arange(cfg.nparticles, device=device)
    _, _, _, celly = source_cells(
        mesh, pid, source_x0=kw["source_x0"], source_y0=kw["source_y0"],
        source_width=kw["source_width"], source_height=kw["source_height"],
        dtype=kw["dtype"], rng_scheme=cfg.rng)
    rows = cfg.ny // slabs
    return [pid[celly // rows == s] for s in range(slabs)]


@pytest.mark.parametrize("engine", ["kernel", "plain"])
def test_shards_inject_their_pids_by_engine(monkeypatch, engine):
    """A decomposition's shards inject as Simulation does, by engine: the
    kernel engine once a shard through inject_particles_kernel with the
    shard's pid vector (here a stand-in that runs the plain version), the
    plain engine through inject_particles with the same vector; every
    shard holds bitwise inject_fields of its pids."""
    cfg = deck().with_(nparticles=500)
    calls = []

    def stand_in(mesh, **kw):
        calls.append(kw)
        return inject_particles(mesh, **kw)

    monkeypatch.setattr(census, "inject_particles_kernel", stand_in)
    monkeypatch.setattr(driver, "pick_engine", lambda *a: engine)
    plain_calls = inject_particles.calls
    sim = parallel.SpatialSimulation(cfg, devices=["cpu"] * 2, quiet=True)
    assert inject_particles.calls == plain_calls + 2
    assert len(calls) == (2 if engine == "kernel" else 0)
    want = shard_pids(cfg, "cpu")
    assert sum(p.numel() for p in want) == cfg.nparticles
    for s, (sh, pid) in enumerate(zip(sim.shards, want)):
        assert pid.numel() > 0
        if calls:
            assert torch.equal(calls[s]["pid"], pid)
            assert calls[s]["nparticles"] == pid.numel()
        assert_bitwise(sh.state, inject_fields(
            sim.mesh, pid, torch.ones(pid.shape, dtype=torch.bool),
            initial_energy=cfg.initial_energy, dt=cfg.dt,
            dtype=torch.float32, **sim.source()))
    assert sim.coords() == "cell-local"


def test_inject_kernel_refuses_a_pid_vector_it_cannot_read():
    """A pid vector of another dtype, length or device raises before any
    launch (the CPU mesh is refused first, so the check runs on a mesh
    whose device check passes only on a card)."""
    cfg = deck()
    mesh = build_mesh(cfg, torch.float32, "cpu")
    kw = inject_args(cfg, "global", "cpu")
    with pytest.raises(ValueError, match="needs CUDA"):
        inject_kernel.inject_particles_kernel(
            mesh, nparticles=3, pid=torch.arange(3), **kw)


def c_struct_fields(source: str, name: str) -> list[tuple[str, str]]:
    """(C type, field name) of each member of struct `name` in a CUDA
    source, in order."""
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", source,
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        field = re.search(r"\w+$", decl)
        ctype = re.sub(r"^const\s+", "", decl[:field.start()].strip())
        out.append((re.sub(r"\s+", " ", ctype), field.group()))
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_inject_params_match_csrc(dtype):
    """The ctypes mirror of InjectParamsT<Real> names the C struct's
    fields in its order, each of the matching type (a pointer, the 64-bit
    lane count, an int, or the working type), and lays them out as C
    does (the library checks the size at load)."""
    from test_torch_float64_kernels import c_layout

    real = getattr(torch, dtype)
    cls, _ = inject_kernel._LAYOUTS[real]
    source = (ROOT / "neutral_tpu_torch" / "csrc" / "inject.cu").read_text()
    c_fields = c_struct_fields(source, "InjectParamsT")
    assert [n for _, n in c_fields] == [n for n, _ in cls._fields_]
    want = {"long long": ctypes.c_int64, "int": ctypes.c_int,
            "Real": ctypes.c_float if dtype == "float32" else
            ctypes.c_double}
    for (ctype, name), (_, ty) in zip(c_fields, cls._fields_):
        assert ty is (ctypes.c_void_p if ctype.endswith("*")
                      else want[ctype]), name
    offsets, size = c_layout(cls._fields_)
    for name, _ in cls._fields_:
        assert getattr(cls, name).offset == offsets[name], name
    assert ctypes.sizeof(cls) == size
    assert [n for n, _ in cls._fields_][:len(STATE_FIELDS)] == list(
        STATE_FIELDS)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,scheme,mesh,frame", CARD_CASES,
                         ids=["-".join(c) for c in CARD_CASES])
def test_inject_kernel_matches_plain_on_card(dtype, scheme, mesh, frame):
    """The inject kernel against inject_particles on the card: all 14
    fields bitwise at 1, 1,024 and 70,000 lanes, one counted launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = deck(dtype, mesh, scheme)
    m = build_mesh(cfg, getattr(torch, dtype), "cuda")
    assert m.uniform == (mesh == "uniform")
    kw = inject_args(cfg, frame, torch.device("cuda"))
    for n in LANES:
        launches = inject_kernel.inject_particles_kernel.launches
        got = inject_kernel.inject_particles_kernel(m, nparticles=n, **kw)
        want = inject_particles(m, nparticles=n, **kw)
        torch.cuda.synchronize()
        assert inject_kernel.inject_particles_kernel.launches == launches + 1
        assert got.n == n
        assert_bitwise(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scatter", "csp", "stream"])
def test_inject_kernel_matches_plain_on_decks(name):
    """The benchmark decks as they are (scatter 10M lanes in the
    cell-local frame, csp and stream 1M in the global one): Simulation on
    the kernel engine injects in one counted launch, bitwise what
    inject_particles gives for its mesh and source."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = driver.load_config(str(ROOT / "problems" / f"{name}.params"))
    kernel = inject_kernel.inject_particles_kernel
    launches, plain_calls = kernel.launches, inject_particles.calls
    card = torch.cuda.current_device()
    on_card = kernel.cards[card]
    sim = driver.Simulation(cfg, device="cuda", engine="kernel", quiet=True)
    assert kernel.launches == launches + 1
    assert kernel.cards[card] == on_card + 1
    assert inject_particles.calls == plain_calls
    assert sim.coords() == ("cell-local" if name == "scatter" else "global")
    want = inject_particles(
        sim.mesh, nparticles=cfg.nparticles,
        initial_energy=cfg.initial_energy, dt=cfg.dt, dtype=sim.dtype,
        device=sim.device, **sim.source())
    torch.cuda.synchronize()
    assert sim.state.n == cfg.nparticles
    assert_bitwise(sim.state, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,scheme", [
    (d, r) for d in ("float32", "float64") for r in inject_kernel.SCHEMES])
def test_inject_kernel_pid_vector_matches_plain_on_card(dtype, scheme):
    """The inject kernel over a spatial shard's vector of pids against
    inject_fields of the same pids on the card: all 14 fields bitwise, in
    float32 and float64, under both schemes, one counted launch a shard;
    a pid vector it cannot read raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = deck(dtype, "uniform", scheme).with_(nparticles=70_000)
    cuda = torch.device("cuda")
    m = build_mesh(cfg, getattr(torch, dtype), cuda)
    kw = inject_args(cfg, "global", cuda)
    for pid in shard_pids(cfg, cuda):
        launches = inject_kernel.inject_particles_kernel.launches
        got = inject_kernel.inject_particles_kernel(
            m, nparticles=pid.numel(), pid=pid, **kw)
        plain = dict(kw)
        del plain["device"]
        want = inject_fields(m, pid, torch.ones(pid.shape, dtype=torch.bool,
                                                device=cuda), **plain)
        torch.cuda.synchronize()
        assert inject_kernel.inject_particles_kernel.launches == launches + 1
        assert 0 < got.n < cfg.nparticles
        assert_bitwise(got, want)
    for bad in (pid.to(torch.int32), pid[:-1], pid.cpu()):
        with pytest.raises(ValueError, match="pid must be"):
            inject_kernel.inject_particles_kernel(
                m, nparticles=pid.numel(), pid=bad, **kw)
