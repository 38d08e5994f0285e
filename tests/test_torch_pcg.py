"""PCG64si draws in the port (neutral_tpu_torch.rng) and pcg64si decks,
against neutral_tpu.

The draws are compared bitwise with `neutral_tpu.rng` for keys near 0,
near 2^32 and at random (1e15 * master_key passes 2^32 from the first
timestep, so an int64 product that overflowed would show there first),
and with the known-answer vectors of tests/test_pcg.py.  Decks: injection
equals JAX's, and the port's float64 plain engine gives per-step counts
exactly equal to JAX's float64 XLA engine on the four deck families of
tests/test_torch_flight.py.  The `cuda` tests hold the sweep and flight
kernels' pcg64si mode to their plain versions on the card and skip
without one; JAX is imported only inside the tests that compare with it:

    python -m pytest tests/test_torch_pcg.py -q -m cuda --noconftest
"""

import functools
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver, rng as trng

from test_torch_driver import kernel_matches_plain_on_card
from test_torch_flight import FAMILIES, make_cfg

KEY_RANGES = {"near_0": (0, 64), "near_2_32": (2**32 - 64, 2**32),
              "random": (0, 2**32)}


def _keys(kind, n=4096):
    """(pid, master_key, counter) as uint32 arrays from a numpy seed."""
    lo, hi = KEY_RANGES[kind]
    rs = np.random.RandomState(11)
    return [rs.randint(lo, hi, size=n, dtype=np.uint64).astype(np.uint32)
            for _ in range(3)]


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _words(hi, lo):
    return [(int(h) << 32) | int(l) for h, l in zip(hi.tolist(), lo.tolist())]


def test_pcg_raw_matches_kats():
    """The KAT vectors (seed -> first outputs) through the port's path."""
    from neutral_tpu import rng as jrng
    from test_pcg import VECS

    seeds = [v[0] for v in VECS]
    a_hi, a_lo, b_hi, b_lo = trng.pcg64si_raw(
        _t([s >> 32 for s in seeds]), _t([s & 0xFFFFFFFF for s in seeds]))
    assert _words(a_hi, a_lo) == [v[1] for v in VECS]
    assert _words(b_hi, b_lo) == [jrng.pcg64si_py((s + 1) % 2**64)
                                  for s in seeds]


@pytest.mark.parametrize("kind", KEY_RANGES)
def test_pcg_pair_matches_python_oracle(kind):
    """The pair seed and both first outputs against neutral_tpu's Python
    integer oracle (pcg64si_pair_py of seeds s and s + 1)."""
    from neutral_tpu import rng as jrng

    pk, mk, cc = _keys(kind, n=256)
    seeds = [(10**15 * int(m) + 10**4 * int(p) + 2 * int(c)) % 2**64
             for p, m, c in zip(pk, mk, cc)]
    s_hi, s_lo = trng._pcg_pair_seed(_t(pk), _t(mk), _t(cc))
    assert _words(s_hi, s_lo) == seeds
    a_hi, a_lo, b_hi, b_lo = trng.pcg64si_raw(s_hi, s_lo)
    assert _words(a_hi, a_lo) == [jrng.pcg64si_pair_py(s)[0] for s in seeds]
    assert _words(b_hi, b_lo) == [
        jrng.pcg64si_pair_py((s + 1) % 2**64)[0] for s in seeds]


@pytest.mark.parametrize("width", ["f32", "f64"])
@pytest.mark.parametrize("kind", KEY_RANGES)
def test_pcg_uniform2_bitwise(kind, width):
    import jax.numpy as jnp
    from neutral_tpu import rng as jrng

    pk, mk, cc = _keys(kind)
    jfn = {"f32": jrng.uniform2_pcg_f32, "f64": jrng.uniform2_pcg_f64}[width]
    tfn = {"f32": trng.uniform2_pcg_f32, "f64": trng.uniform2_pcg_f64}[width]
    want = jfn(jnp.asarray(pk), jnp.asarray(mk), jnp.asarray(cc))
    got = tfn(_t(pk), _t(mk), _t(cc))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      w.view(np.uint8))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_inject_pcg64si_matches_jax(dtype):
    """Injection under pcg64si, with the tolerances of
    tests/test_torch_xs_mesh_particles.py: cells and the other fields
    equal to JAX's; positions to an ulp (XLA on the CPU contracts
    x0 + r * width into a fused multiply-add) and the angle to an ulp of
    XLA's cos/sin."""
    import jax.numpy as jnp
    import neutral_tpu as nt

    kw = dict(nparticles=3000, source_x0=0.2, source_y0=0.25,
              source_width=0.6, source_height=0.5, initial_energy=1.0e3,
              dt=1e-7, rng_scheme="pcg64si")
    js = nt.inject_particles(
        nt.build_mesh(nt.SimConfig(nx=97, ny=61), dtype=getattr(jnp, dtype)),
        dtype=getattr(jnp, dtype), **kw)
    ts = tt.inject_particles(
        tt.build_mesh(tt.SimConfig(nx=97, ny=61),
                      dtype=getattr(torch, dtype)),
        dtype=getattr(torch, dtype), **kw)
    t = tt.state_to_numpy(ts)
    for f in ("cellx", "celly", "pid", "dead", "counter", "energy",
              "weight", "dt_to_census"):
        np.testing.assert_array_equal(t[f], np.asarray(getattr(js, f)), f)
    rtol = 1e-13 if dtype == "float64" else 1e-6
    for f in ("x", "y", "omega_x", "omega_y"):
        np.testing.assert_allclose(t[f], np.asarray(getattr(js, f)),
                                   rtol=rtol, atol=rtol)


@functools.cache
def run_port(kind, transport_name):
    cfg = make_cfg(tt, kind).with_(rng="pcg64si")
    sim = driver.Simulation(cfg, device="cpu", transport=transport_name,
                            quiet=True)
    stats = [(m.nfacets, m.ncollisions, m.nprocessed)
             for m in (sim.step(s) for s in range(1, cfg.niters + 1))]
    return sim.host_tally(), stats


@pytest.mark.parametrize("kind", FAMILIES)
def test_plain_engine_pcg64si_matches_jax_xla_f64(kind):
    """float64, pcg64si: per-step facet, collision and processed counts
    exactly equal to JAX's float64 XLA engine; tallies to 1e-12."""
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver

    t_tally, t_stats = run_port(kind, "sweep")
    cfg = make_cfg(nt, kind).with_(rng="pcg64si", engine="xla")
    sim = jdriver.Simulation(cfg, quiet=True)
    j_stats = [(m.nfacets, m.ncollisions, m.nprocessed)
               for m in (sim.step(s) for s in range(1, cfg.niters + 1))]
    j_tally = np.asarray(sim.tally, np.float64)
    assert t_stats == j_stats
    assert j_tally.sum() != 0.0
    np.testing.assert_allclose(t_tally.sum(), j_tally.sum(), rtol=1e-12)


@pytest.mark.parametrize("kind", FAMILIES)
def test_flight_path_pcg64si_counts_equal_sweep_path(kind):
    """Draws happen only at collisions, so under pcg64si too the flight
    and sweep transports run the same histories: per-step counts exactly
    equal, tallies to summation order."""
    f_tally, f_stats = run_port(kind, "flight")
    s_tally, s_stats = run_port(kind, "sweep")
    assert f_stats == s_stats
    np.testing.assert_allclose(f_tally.sum(), s_tally.sum(), rtol=1e-11)


def test_pcg64si_deck_validates_against_pcg_golden(tmp_path):
    """A `rng pcg64si` deck takes its golden from neutral_pcg.tests: the
    shipped scatter deck finds problems/neutral_pcg.tests, and a cut-down
    deck whose golden there is JAX's float64 XLA tally prints `PASSED
    validation.` from the port's float32 CLI."""
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver

    body = open("problems/scatter.params").read() + "rng pcg64si\n"
    full = tmp_path / "scatter.params"
    full.write_text(body)
    assert tt.load_config(str(full)).expected_tally == 3.413463975002e-02

    small = tmp_path / "mini" / "mini.params"
    small.parent.mkdir()
    small.write_text(body.replace("10000000", "2000").replace("4000", "64"))
    jcfg = nt.load_config(str(small)).with_(
        engine="xla", dtype="float64", tally_dtype="float64")
    ref = jdriver.Simulation(jcfg, quiet=True).run()
    (small.parent / "neutral_pcg.tests").write_text(
        f"mini.params result={ref:.12e}\n")
    (small.parent / "neutral.tests").write_text("mini.params result=1.0\n")
    out = subprocess.run([sys.executable, "-m", "neutral_tpu_torch",
                          str(small), "--device", "cpu"], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    assert "PASSED validation." in out, out
    total = float(re.search(r"Final global_energy_tally (\S+)", out)[1])
    assert abs(total - ref) <= 1e-3 * abs(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("deck", ["scatter", "stream", "split"])
def test_pcg64si_kernel_matches_plain_on_card(deck, tmp_path):
    """The sweep kernel (scatter) and the flight kernel (stream, split)
    under pcg64si against their plain versions at 65,536 particles."""
    path = tmp_path / f"{deck}.params"
    shutil.copy(f"problems/{deck}.params", path)
    with open(path, "a") as f:
        f.write("rng pcg64si\n")
    cfg = tt.load_config(str(path)).with_(nparticles=65536,
                                          expected_tally=None)
    sim, _ = kernel_matches_plain_on_card(cfg)
    assert sim.geom.rng_scheme == "pcg64si"
    assert sim.transport == ("sweep" if deck == "scatter" else "flight")
