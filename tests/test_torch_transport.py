"""The port's plain event engine (neutral_tpu_torch.transport) against the
JAX engine (neutral_tpu.transport.run_timestep), timestep by timestep.

The four deck families of tests/test_transport.py (scatter, stream, csp,
split; 48x48 mesh) run with analytic cross-sections and analytic region
density on both sides, from the same JAX-injected state.  In float64 the
branch decisions must agree everywhere: per-step facet, collision and
processed counts are exactly equal and the tally agrees to summation-order
rounding.  This module holds the plain version of the CUDA sweep kernel.
"""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import neutral_tpu as nt
from neutral_tpu import mesh as jmesh
import neutral_tpu_torch as tt
from neutral_tpu_torch import transport

from test_transport import make_problem

FAMILIES = ["scatter", "stream", "csp", "split"]


@functools.cache
def run_both(kind: str, dtype: str, initial_energy: float | None = None):
    """Both engines on family `kind` (born at `initial_energy` eV when it
    is given): per step the counts, dead masks and the port's energies,
    then JAX's and the port's tallies."""
    cfg = make_problem(kind)
    if initial_energy is not None:
        cfg = dataclasses.replace(cfg, initial_energy=initial_energy)
    jdt = getattr(jnp, dtype)
    regions = jmesh.region_cell_bounds(cfg)
    dx, dy = cfg.width / cfg.nx, cfg.height / cfg.ny
    jgeom = nt.Geometry(cfg.nx, cfg.ny, cfg.nx, cfg.ny, dx=dx, dy=dy,
                        regions=regions, same_xs=True)
    jtab = nt.CrossSection.resonance(dtype=jdt, analytic=True)
    mesh = nt.build_mesh(cfg, dtype=jdt)
    local = (dx, dy) if dtype == "float32" else None
    jstate = nt.inject_particles(
        mesh, nparticles=cfg.nparticles,
        source_x0=cfg.source.xpos * cfg.width,
        source_y0=cfg.source.ypos * cfg.height,
        source_width=cfg.source.width * cfg.width,
        source_height=cfg.source.height * cfg.height,
        initial_energy=cfg.initial_energy, dt=cfg.dt, dtype=jdt,
        local_coords=local)

    tstate = tt.state_from_numpy(
        {f: np.asarray(getattr(jstate, f)) for f in tt.particles.STATE_FIELDS})
    tgeom = transport.Geometry(nx=cfg.nx, ny=cfg.ny, dx=dx, dy=dy,
                               regions=regions, same_xs=True)
    ttab = tt.CrossSection.resonance(dtype=getattr(torch, dtype),
                                     analytic=True)
    assert transport.use_local_coords(tgeom, getattr(torch, dtype)) == \
        (local is not None)

    jtally = jnp.zeros(cfg.nx * cfg.ny, jdt)
    ttally = torch.zeros(cfg.nx * cfg.ny, dtype=getattr(torch, dtype))
    steps = []
    for step in range(1, cfg.niters + 1):
        jstate, jtally, counts, nproc, _ = nt.run_timestep(
            jstate, jtally, mesh, jtab, jtab, jgeom, cfg.dt,
            jnp.uint32(step), 1.0 / cfg.nparticles)
        jnf, jnc = counts.totals()
        tstate, tnf, tnc, tnproc, _ = transport.run_timestep(
            tstate, ttally, tgeom, ttab, ttab, cfg.dt, step,
            1.0 / cfg.nparticles)
        steps.append(dict(jax=(jnf, jnc, int(nproc)), torch=(tnf, tnc, tnproc),
                          jdead=np.asarray(jstate.dead),
                          tdead=tstate.dead.numpy(),
                          tenergy=tstate.energy.numpy()))
    return steps, np.asarray(jtally), ttally.numpy()


@pytest.mark.parametrize("kind", FAMILIES)
def test_plain_engine_matches_jax_f64(kind):
    steps, jtally, ttally = run_both(kind, "float64")
    for s in steps:
        assert s["torch"] == s["jax"]
        np.testing.assert_array_equal(s["tdead"], s["jdead"])
    assert jtally.sum() != 0.0
    np.testing.assert_allclose(ttally, jtally, rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("kind", FAMILIES)
def test_plain_engine_tracks_jax_f32(kind):
    """float32 in the cell-local frame.

    XLA on the CPU rounds float32 differently from PyTorch: its log and
    sqrt differ by an ulp on some inputs, and it rewrites a division by a
    constant into a multiplication by the rounded reciprocal (the energy
    loss `... / ((A+1)*(A+1))` of every scatter).  A history whose branch
    flips on such an ulp diverges from there, so the counts agree to 1%.
    The rounded reciprocal biases every scatter's energy the same way,
    and JAX's float32 scatter tally ends about 2e-4 from its float64 one;
    the port divides as the reference does, and its float32 tally is held
    to 1e-4 of the float64 tally.
    """
    steps, _, ttally = run_both(kind, "float32")
    _, jtally64, _ = run_both(kind, "float64")
    for s in steps:
        for j, t in zip(s["jax"], s["torch"]):
            assert abs(t - j) <= 0.01 * j, s
    ref = jtally64.sum()
    assert ref != 0.0
    assert abs(ttally.astype(np.float64).sum() - ref) <= 1e-4 * abs(ref)
