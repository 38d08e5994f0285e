"""Cross-sections, mesh and injection of the port against neutral_tpu.

Same inputs on both sides (numpy-seeded energies, the shipped decks, the
same injection arguments).  Host-side mesh math is identical code, so it
must agree exactly; device arithmetic may differ by an ulp between XLA and
PyTorch (sqrt/cos/sin), hence the stated tolerances.
"""

import glob

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import neutral_tpu as nt
from neutral_tpu import mesh as jmesh
import neutral_tpu_torch as tt
from neutral_tpu_torch import mesh as tmesh

DECKS = sorted(glob.glob("problems/*.params"))
TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-14),
                                        ("float32", 2e-7)])
def test_analytic_lookup_matches_jax(dtype, rtol):
    rs = np.random.RandomState(7)
    # Log-uniform over the table's span, plus its first and last keys.
    e = np.concatenate([10.0 ** rs.uniform(-1.0, 8.0, size=20_000),
                        [1.0e-2 + 1e-8, 1.0, 1.0e3, 1.0e8]]).astype(dtype)
    want = nt.CrossSection.resonance(dtype=getattr(jnp, dtype),
                                     analytic=True).lookup(jnp.asarray(e))
    got = tt.CrossSection.resonance(dtype=TORCH_DTYPES[dtype],
                                    analytic=True).lookup(
        torch.from_numpy(e))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol)


def test_table_lookup_modes_match_jax():
    """Quartic and searchsorted table modes (plain path only), float64."""
    e = 10.0 ** np.random.RandomState(8).uniform(-1.0, 8.0, size=5000)
    for quartic in (True, False):
        j = nt.CrossSection.resonance(dtype=jnp.float64)
        t = tt.CrossSection.resonance(dtype=torch.float64)
        j.quartic = t.quartic = quartic
        np.testing.assert_allclose(
            t.lookup(torch.from_numpy(e)).numpy(),
            np.asarray(j.lookup(jnp.asarray(e))), rtol=1e-14)


@pytest.mark.parametrize("deck", DECKS)
def test_density_and_region_bounds_exact(deck):
    jcfg = nt.load_config(deck)
    tcfg = tt.load_config(deck)
    assert tmesh.region_cell_bounds(tcfg) == jmesh.region_cell_bounds(jcfg)
    np.testing.assert_array_equal(tmesh.build_density(tcfg),
                                  jmesh.build_density(jcfg))


def _inject_both(dtype, local):
    kw = dict(nparticles=3000, source_x0=0.2, source_y0=0.25,
              source_width=0.6, source_height=0.5, initial_energy=1.0e3,
              dt=1e-7)
    jcfg = nt.SimConfig(nx=97, ny=61)
    tcfg = tt.SimConfig(nx=97, ny=61)
    lc = (1.0 / 97, 1.0 / 61) if local else None
    js = nt.inject_particles(nt.build_mesh(jcfg, dtype=getattr(jnp, dtype)),
                             dtype=getattr(jnp, dtype), local_coords=lc,
                             **kw)
    ts = tt.inject_particles(tt.build_mesh(tcfg, dtype=TORCH_DTYPES[dtype]),
                             dtype=TORCH_DTYPES[dtype], local_coords=lc,
                             **kw)
    return js, ts


@pytest.mark.parametrize("dtype,local,rtol", [("float64", False, 1e-13),
                                              ("float32", False, 1e-6),
                                              ("float32", True, 1e-6)])
def test_inject_particles_matches_jax(dtype, local, rtol):
    js, ts = _inject_both(dtype, local)
    t = tt.state_to_numpy(ts)
    for f in ("cellx", "celly", "pid", "dead", "counter", "energy",
              "weight", "dt_to_census", "mfp_to_collision", "deposit"):
        np.testing.assert_array_equal(t[f], np.asarray(getattr(js, f)))
    for f in ("omega_x", "omega_y"):
        np.testing.assert_allclose(t[f], np.asarray(getattr(js, f)),
                                   rtol=rtol, atol=rtol)
    for f in ("x", "y"):
        # Cell-local offsets are x - cellx * dx: XLA on the CPU contracts
        # that into a fused multiply-add and PyTorch rounds the product
        # first, so they agree to rtol of the domain extent (1.0), not of
        # the offset.
        np.testing.assert_allclose(t[f], np.asarray(getattr(js, f)),
                                   rtol=0.0 if local else rtol,
                                   atol=rtol if local else 0.0)


def test_state_numpy_round_trip_through_jax_state():
    # A JAX state with dead padding lanes, as the JAX driver makes it.
    js = nt.inject_particles(
        nt.build_mesh(nt.SimConfig(nx=97, ny=61), dtype=jnp.float32),
        nparticles=3000, source_x0=0.2, source_y0=0.25, source_width=0.6,
        source_height=0.5, initial_energy=1.0e3, dt=1e-7,
        dtype=jnp.float32, local_coords=(1.0 / 97, 1.0 / 61), pad_to=3072)
    d = {f: np.asarray(getattr(js, f)) for f in tt.particles.STATE_FIELDS}
    ts = tt.state_from_numpy(d)
    assert ts.pid.dtype == torch.int64 and ts.dead.dtype == torch.bool
    assert ts.n == 3072        # padding lanes are kept
    back = tt.state_to_numpy(ts)
    for f, a in d.items():
        assert back[f].dtype == a.dtype, f
        np.testing.assert_array_equal(back[f], a)
