"""Event-based Monte Carlo transport: the plain PyTorch engine.

Port of `neutral_tpu/transport.py`.  One *event sweep* advances every live
particle through exactly one event (facet crossing, collision or census)
with masked lanes; sweeps repeat until every particle has reached census
or died.  Physics per event follows the reference (omp3/neutral.c,
formulas cited inline); each lane carries its own RNG draw counter, so
histories do not depend on how lanes are batched or ordered.

This is the plain version of the CUDA sweep kernel (sweep_kernel.py,
csrc/sweep.cu): it runs on the CPU in the tests and is the comparison the
kernel is checked against on the card.  It keeps `neutral_tpu`'s
operation order and its casts of every constant to the working dtype, so
that float64 runs reproduce the JAX engine's event counts exactly and
float32 runs on one device reproduce the kernel's per-lane state bitwise.
Division by a constant goes through `xs.div` (a true division on every
backend).

Covered: analytic density regions or a density grid, a uniform pitch or
per-cell edge arrays (non-uniform meshes and fast_math 0 decks, whose
geometry has no pitch), analytic or table cross-sections, threefry or
pcg64si draws, float32 or float64, and the spatial window of a decomposed
run (`x_off`/`y_off`, the counterparts of `neutral_tpu`'s
`x_off_dyn`/`y_off_dyn`; parallel/spatial.py).
The TPU engine's `gate` and carried `density` arguments belong to its
rings and its grid-mode stale freeze, and are not ported.

The window: a shard of a spatial decomposition owns the cells
[x_off, x_off + geom.nx) x [y_off, y_off + geom.ny) of the global
geom.global_nx x geom.global_ny mesh.  Its tally and a grid deck's density
are window-local (row-major over geom.nx columns); regions and reflection
stay global.  A lane whose cell lies outside the window is frozen: it takes
no event until migration moves it to its owner.  A lane that leaves the
window does so by a facet event, whose flush lands in the cell it left,
inside the window.  With both offsets None (one device, or the replicated
decomposition) the code path is the unwindowed one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import rng
from .constants import (AVOGADROS, BARNS, EV_TO_J, MASS_NO,
                        MIN_ENERGY_OF_INTEREST, MOLAR_MASS,
                        OPEN_BOUND_CORRECTION, PARTICLE_MASS)
from .particles import ParticleState
from .xs import CrossSection, const, div

# Derived scalar constants (float64 Python values; cast at use sites).
_INV_MOLAR = AVOGADROS / MOLAR_MASS
_A = MASS_NO
_AVG_SCATTER_FRAC = (_A * _A + _A + 1.0) / ((_A + 1.0) * (_A + 1.0))
_SPEED_COEF = 2.0 * EV_TO_J / PARTICLE_MASS


@dataclass(frozen=True)
class Geometry:
    """Static geometry of the whole-domain problem.

    * ``dx``/``dy`` — uniform cell pitches; facet distances use
      ``edge = cell * pitch`` (or the cell-local frame, see
      use_local_coords).  0 on a non-uniform mesh and under fast_math 0:
      facet distances then gather ``edgex``/``edgey``.
    * ``edgex``/``edgey`` — the whole mesh's (nx+1,) and (ny+1,) edge
      coordinates in the state dtype, on the state's device, indexed by
      global cell (mesh.build_edges).
    * ``regions`` — ``((ix0, ix1, iy0, iy1, density), ...)`` global
      cell-index rectangles, later entries overriding earlier ones over a
      background of 0 (mesh.region_cell_bounds); None for a grid deck.
    * ``same_xs`` — the absorb table equals the scatter table, so one
      lookup serves both.
    * ``rects`` — disjoint constant-density cell rectangles covering the
      domain (flight.disjoint_rects), for the flight transport; None for a
      grid deck, which the flight transport refuses.
    * ``density`` — a grid deck's flat (ny*nx,) density in the state
      dtype, on the state's device (mesh.density_grid), with
      ``regions=None``; under a spatial window, the window's block.
    * ``nx``/``ny`` — the extent of the tally (and of ``density``): the
      whole mesh, or a spatial window's block; ``global_nx``/``global_ny``
      — the whole mesh, where reflection happens (default: nx/ny).
    """
    nx: int
    ny: int
    dx: float
    dy: float
    regions: tuple | None
    rng_scheme: str = "threefry"
    same_xs: bool = False
    rects: tuple | None = None
    density: torch.Tensor | None = field(default=None, compare=False)
    edgex: torch.Tensor | None = field(default=None, compare=False)
    edgey: torch.Tensor | None = field(default=None, compare=False)
    global_nx: int | None = None
    global_ny: int | None = None

    def __post_init__(self):
        if self.global_nx is None:
            object.__setattr__(self, "global_nx", self.nx)
        if self.global_ny is None:
            object.__setattr__(self, "global_ny", self.ny)


def use_local_coords(geom: Geometry, dtype: torch.dtype) -> bool:
    """Whether the facet-stepping engine keeps particle x/y as CELL-LOCAL
    offsets instead of global coordinates.

    float32 positions measured from the domain origin resolve a 4000-cell
    mesh to only ~1e-3 of a cell near the far edge; near-facet collisions
    then turn into spurious facet crossings (~100x on the scatter deck).
    Offsets from the particle's own cell keep ~1e-7 of a cell everywhere.
    float64 keeps global coordinates, and so do the flight transport in
    every dtype (flight.flight_core) and a geometry without a pitch
    (non-uniform meshes, fast_math 0), as in neutral_tpu.
    """
    return bool(geom.dx) and dtype == torch.float32


def window_cells(state: ParticleState, geom: Geometry, x_off=None,
                 y_off=None):
    """(lx, ly, in_window): each lane's window-local cell, and whether it
    lies inside the window (None when both offsets are None: no window)."""
    if x_off is None and y_off is None:
        return state.cellx, state.celly, None
    lx = state.cellx - (x_off or 0)
    ly = state.celly - (y_off or 0)
    return lx, ly, (lx >= 0) & (lx < geom.nx) & (ly >= 0) & (ly < geom.ny)


def _flat_cell(lx: torch.Tensor, ly: torch.Tensor,
               geom: Geometry) -> torch.Tensor:
    return (ly * geom.nx + lx).clamp(0, geom.nx * geom.ny - 1)


def _density_of(cellx: torch.Tensor, celly: torch.Tensor,
                flat_cell: torch.Tensor, geom: Geometry,
                dtype: torch.dtype) -> torch.Tensor:
    """Per-lane material density: the analytic region rectangles (global
    cells), or a gather from the grid deck's density at the window-local
    flat cell (neutral_tpu's grid branch)."""
    if geom.regions is None:
        return geom.density[flat_cell]
    density = torch.zeros(cellx.shape, dtype=dtype, device=cellx.device)
    for (ix0, ix1, iy0, iy1, d) in geom.regions:
        inside = ((cellx >= ix0) & (cellx < ix1) &
                  (celly >= iy0) & (celly < iy1))
        density = torch.where(inside, const(d, dtype), density)
    return density


def _facet_edges(state: ParticleState, geom: Geometry):
    """(ex_lo, ex_hi, ey_lo, ey_hi) bounding edges of each particle's cell:
    from the pitch, or gathered from the edge arrays by global cell when
    the geometry has none (neutral_tpu's gather branch)."""
    if not geom.dx:
        gnx, gny = geom.global_nx, geom.global_ny
        return (geom.edgex[state.cellx.clamp(0, gnx - 1)],
                geom.edgex[(state.cellx + 1).clamp(0, gnx)],
                geom.edgey[state.celly.clamp(0, gny - 1)],
                geom.edgey[(state.celly + 1).clamp(0, gny)])
    dtype = state.dtype
    dx = const(geom.dx, dtype)
    dy = const(geom.dy, dtype)
    if use_local_coords(geom, dtype):
        return 0.0, dx, 0.0, dy
    cx = state.cellx.to(dtype)
    cy = state.celly.to(dtype)
    return cx * dx, (cx + 1.0) * dx, cy * dy, (cy + 1.0) * dy


def _speed_of(energy: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(const(_SPEED_COEF, energy.dtype) * energy)


def _heating_response(energy, sig_a, sig_t):
    """Energy deposited per unit (weight * path * macro_total)
    (calculate_energy_deposition, omp3/neutral.c:474-495)."""
    absorb_frac = sig_a / sig_t
    avg_exit_scatter = energy * const(_AVG_SCATTER_FRAC, energy.dtype)
    return energy - (1.0 - absorb_frac) * avg_exit_scatter


def begin_timestep(state: ParticleState, geom: Geometry,
                   scatter_tab: CrossSection, dt: float,
                   master_key: int, x_off=None, y_off=None) -> ParticleState:
    """Per-timestep (re)initialisation: reset the census clock and sample
    fresh mean free paths with draw counter 0 (omp3/neutral.c:127-131);
    every lane's counter becomes 1.  `x_off`/`y_off` localise a grid deck's
    density gather to the window (every live lane sits on its owner shard
    when a step starts).  `begin_timestep.calls` counts its calls; callers
    may reset it."""
    begin_timestep.calls += 1
    dtype = state.dtype
    live = ~state.dead
    lx, ly, _ = window_cells(state, geom, x_off, y_off)
    density = _density_of(state.cellx, state.celly, _flat_cell(lx, ly, geom),
                          geom, dtype)
    sig_s = scatter_tab.lookup(state.energy)
    # neutral_tpu's _macroscopic: density * INV_MOLAR * sig * BARNS.
    mac_s = density * const(_INV_MOLAR, dtype) * sig_s * const(BARNS, dtype)
    r0, _ = rng.uniform2_scheme(state.pid, master_key, 0, dtype,
                                geom.rng_scheme)
    mfp = -torch.log(r0) / mac_s
    return ParticleState(
        x=state.x, y=state.y, omega_x=state.omega_x, omega_y=state.omega_y,
        energy=state.energy, weight=state.weight,
        dt_to_census=torch.where(live, const(dt, dtype),
                                 torch.zeros_like(state.dt_to_census)),
        mfp_to_collision=torch.where(live, mfp, state.mfp_to_collision),
        deposit=state.deposit,
        cellx=state.cellx, celly=state.celly, dead=state.dead,
        pid=state.pid,
        counter=torch.ones_like(state.counter),
    )


begin_timestep.calls = 0


def collision_physics(state: ParticleState, geom: Geometry,
                      scatter_tab: CrossSection, master_key: int,
                      is_coll, mac_a, mac_t, number_density):
    """Collision event physics (omp3/neutral.c:209-300): absorption
    (weight reduction, death below MIN_ENERGY_OF_INTEREST) or elastic
    scatter, then a fresh mean free path at the new energy.  Counter c
    is consumed by the collision; c+1 only if the particle survives.

    Returns (omega_x, omega_y, energy, weight, died, mfp, counter).
    """
    dtype = state.dtype
    n = state.n
    # Both pair draws of the event in one call (counter c, and c+1 for
    # colliding lanes): half the per-operation overhead of two calls.
    counter = state.counter + is_coll.to(torch.int64)
    u0, u1 = rng.uniform2_scheme(torch.cat([state.pid, state.pid]),
                                 master_key,
                                 torch.cat([state.counter, counter]),
                                 dtype, geom.rng_scheme)
    rn1a, rn1b, rn2a = u0[:n], u1[:n], u0[n:]
    p_absorb = mac_a / mac_t
    absorbed = rn1a < p_absorb
    weight = torch.where(is_coll & absorbed,
                         state.weight * (1.0 - p_absorb), state.weight)
    died = is_coll & absorbed & (
        state.energy < const(MIN_ENERGY_OF_INTEREST, dtype))

    a = const(_A, dtype)
    mu_cm = 1.0 - 2.0 * rn1b
    e_new = div(state.energy * ((a * a + (2.0 * a) * mu_cm) + 1.0),
                (a + 1.0) * (a + 1.0))
    cos_t = 0.5 * ((a + 1.0) * torch.sqrt(e_new / state.energy)
                   - (a - 1.0) * torch.sqrt(state.energy / e_new))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    scattered = is_coll & (~absorbed)
    omega_x = torch.where(scattered,
                          state.omega_x * cos_t - state.omega_y * sin_t,
                          state.omega_x)
    omega_y = torch.where(scattered,
                          state.omega_x * sin_t + state.omega_y * cos_t,
                          state.omega_y)
    energy = torch.where(scattered, e_new, state.energy)

    # Re-sample the mean free path of surviving collisions with the
    # post-collision energy's scattering cross-section in the same cell.
    sig_s2 = scatter_tab.lookup(energy)
    mac_s2 = number_density * sig_s2 * const(BARNS, dtype)
    coll_alive = is_coll & (~died)
    counter = counter + coll_alive.to(torch.int64)
    mfp = torch.where(coll_alive, -torch.log(rn2a) / mac_s2,
                      state.mfp_to_collision)
    return omega_x, omega_y, energy, weight, died, mfp, counter


def sweep_core(state: ParticleState, geom: Geometry,
               scatter_tab: CrossSection, absorb_tab: CrossSection,
               master_key: int, inv_ntotal: float,
               tally_dtype: torch.dtype, x_off=None, y_off=None):
    """One event per live lane — pure math, no tally update.

    Under a window (`x_off`/`y_off`), lanes outside it are not live and
    keep their state bitwise, and flat_cell is window-local.  Returns
    (state', flush_mask, flat_cell, tally_contrib, is_facet, is_coll); the
    caller owns the tally update and the counts.
    """
    dtype = state.dtype
    live = (~state.dead) & (state.dt_to_census > 0.0)

    # ---- local material state ------------------------------------------
    lx, ly, in_window = window_cells(state, geom, x_off, y_off)
    if in_window is not None:
        live = live & in_window
    flat_cell = _flat_cell(lx, ly, geom)
    density = _density_of(state.cellx, state.celly, flat_cell, geom, dtype)
    sig_s = scatter_tab.lookup(state.energy)
    sig_a = sig_s if geom.same_xs else absorb_tab.lookup(state.energy)
    sig_t = sig_s + sig_a
    number_density = density * const(_INV_MOLAR, dtype)
    mac_s = number_density * sig_s * const(BARNS, dtype)
    mac_a = number_density * sig_a * const(BARNS, dtype)
    mac_t = mac_s + mac_a
    cell_mfp = 1.0 / mac_t
    speed = _speed_of(state.energy)

    # ---- three candidate distances (omp3/neutral.c:423-471) ---------------
    ex_lo, ex_hi, ey_lo, ey_hi = _facet_edges(state, geom)
    obc = const(OPEN_BOUND_CORRECTION, dtype)
    u_x_inv = 1.0 / (state.omega_x * speed)
    u_y_inv = 1.0 / (state.omega_y * speed)
    dt_x = torch.where(state.omega_x >= 0.0,
                       (ex_hi - state.x) * u_x_inv,
                       (ex_lo - obc - state.x) * u_x_inv)
    dt_y = torch.where(state.omega_y >= 0.0,
                       (ey_hi - state.y) * u_y_inv,
                       (ey_lo - obc - state.y) * u_y_inv)
    x_facet = dt_x < dt_y
    d_facet = torch.where(x_facet, dt_x, dt_y) * speed

    d_coll = state.mfp_to_collision * cell_mfp
    d_census = speed * state.dt_to_census

    is_coll = (d_coll < d_facet) & (d_coll < d_census) & live
    is_facet = (~is_coll) & (d_facet < d_census) & live
    is_census = live & (~is_coll) & (~is_facet)

    dist = torch.where(is_coll, d_coll,
                       torch.where(is_facet, d_facet, d_census))

    # ---- segment energy deposition (pre-event state) ----------------------
    ed = (state.weight * dist * (sig_t * const(BARNS, dtype))
          * _heating_response(state.energy, sig_a, sig_t) * number_density)
    deposit = state.deposit + torch.where(live, ed, 0.0)

    # ---- move to the event site -------------------------------------------
    x = state.x + torch.where(live, dist * state.omega_x, 0.0)
    y = state.y + torch.where(live, dist * state.omega_y, 0.0)

    # ---- collision branch (omp3/neutral.c:209-300) ------------------------
    (omega_x, omega_y, energy, weight, died, mfp,
     counter) = collision_physics(state, geom, scatter_tab, master_key,
                                  is_coll, mac_a, mac_t, number_density)
    dt_to_census = state.dt_to_census - torch.where(is_coll, d_coll / speed,
                                                    0.0)

    # ---- facet branch (omp3/neutral.c:303-380) ----------------------------
    mfp = torch.where(is_facet, mfp - d_facet / cell_mfp, mfp)
    dt_to_census = dt_to_census - torch.where(is_facet, d_facet / speed, 0.0)

    # ---- census branch (omp3/neutral.c:383-405) ---------------------------
    mfp = torch.where(is_census, mfp - d_census / cell_mfp, mfp)
    dt_to_census = torch.where(is_census, 0.0, dt_to_census)

    # ---- tally flush: leaving a cell, dying, or reaching census ------------
    flush = is_facet | is_census | died
    contrib = torch.where(flush, deposit, 0.0).to(tally_dtype)
    contrib = contrib * const(inv_ntotal, tally_dtype)
    deposit = torch.where(flush, 0.0, deposit)

    # ---- facet cell transition / boundary reflection (post-collision
    # omega, pre-move cell; the global boundary) --------------------------
    fx = is_facet & x_facet
    fy = is_facet & (~x_facet)
    pos_x = omega_x > 0.0
    neg_x = omega_x < 0.0
    pos_y = omega_y > 0.0
    neg_y = omega_y < 0.0
    gnx, gny = geom.global_nx, geom.global_ny
    refl_x = ((fx & pos_x & (state.cellx >= gnx - 1))
              | (fx & neg_x & (state.cellx <= 0)))
    refl_y = ((fy & pos_y & (state.celly >= gny - 1))
              | (fy & neg_y & (state.celly <= 0)))
    step_x = ((fx & pos_x & (state.cellx < gnx - 1)).to(torch.int32)
              - (fx & neg_x & (state.cellx > 0)).to(torch.int32))
    step_y = ((fy & pos_y & (state.celly < gny - 1)).to(torch.int32)
              - (fy & neg_y & (state.celly > 0)).to(torch.int32))
    omega_x = torch.where(refl_x, -omega_x, omega_x)
    omega_y = torch.where(refl_y, -omega_y, omega_y)
    cellx = state.cellx + step_x
    celly = state.celly + step_y
    if use_local_coords(geom, dtype):
        # Re-base the cell-local position onto the new cell.
        x = x - step_x.to(dtype) * const(geom.dx, dtype)
        y = y - step_y.to(dtype) * const(geom.dy, dtype)

    new_state = ParticleState(
        x=x, y=y, omega_x=omega_x, omega_y=omega_y, energy=energy,
        weight=weight, dt_to_census=dt_to_census, mfp_to_collision=mfp,
        deposit=deposit, cellx=cellx, celly=celly, dead=state.dead | died,
        pid=state.pid, counter=counter)
    return new_state, flush, flat_cell, contrib, is_facet, is_coll


def event_sweep(state: ParticleState, tally: torch.Tensor, geom: Geometry,
                scatter_tab: CrossSection, absorb_tab: CrossSection,
                master_key: int, inv_ntotal: float, x_off=None, y_off=None):
    """Advance every live particle through exactly one event.

    The tally (flat, ny*nx, window-local under a window) is updated in
    place with `index_add_` (the reference's flush sites
    omp3/neutral.c:248-250, 325-327, 400-402).  Returns (state', nfacets,
    ncollisions) with the counts as 0-d tensors.
    """
    state, flush, flat_cell, contrib, is_facet, is_coll = sweep_core(
        state, geom, scatter_tab, absorb_tab, master_key, inv_ntotal,
        tally.dtype, x_off=x_off, y_off=y_off)
    tally.index_add_(0, flat_cell[flush], contrib[flush])
    return state, is_facet.sum(), is_coll.sum()


def working_mask(state: ParticleState, geom: Geometry | None = None,
                 x_off=None, y_off=None) -> torch.Tensor:
    """Lanes with events left to process (inside the window, if any)."""
    w = (~state.dead) & (state.dt_to_census > 0.0)
    _, _, in_window = window_cells(state, geom, x_off, y_off)
    return w if in_window is None else w & in_window


def sweep_chunk(state: ParticleState, tally: torch.Tensor, geom: Geometry,
                scatter_tab: CrossSection, absorb_tab: CrossSection,
                master_key: int, inv_ntotal: float, max_sweeps: int,
                x_off=None, y_off=None):
    """Run event sweeps until no lane has work left, or `max_sweeps`.

    Under a window, lanes that leave it freeze and the chunk ends when
    only frozen lanes remain; the caller migrates them.  Returns (state,
    nfacets, ncollisions, nsweeps, n_work) with Python-int counts; n_work
    > 0 means more sweeps are needed.  `tally` is updated in place.
    """
    nf = torch.zeros((), dtype=torch.int64, device=tally.device)
    nc = torch.zeros((), dtype=torch.int64, device=tally.device)
    nsweeps = 0
    n_work = int(working_mask(state, geom, x_off, y_off).sum())
    while n_work > 0 and nsweeps < max_sweeps:
        state, f, c = event_sweep(state, tally, geom, scatter_tab,
                                  absorb_tab, master_key, inv_ntotal,
                                  x_off=x_off, y_off=y_off)
        nf += f
        nc += c
        nsweeps += 1
        n_work = int(working_mask(state, geom, x_off, y_off).sum())
    return state, int(nf), int(nc), nsweeps, n_work


def run_timestep(state: ParticleState, tally: torch.Tensor, geom: Geometry,
                 scatter_tab: CrossSection, absorb_tab: CrossSection,
                 dt: float, master_key: int, inv_ntotal: float,
                 max_sweeps: int = 1_000_000):
    """One full census timestep (solve_transport_2d/handle_particles,
    omp3/neutral.c:19-206).  Returns (state, nfacets, ncollisions,
    nprocessed, nsweeps); `tally` is updated in place."""
    state = begin_timestep(state, geom, scatter_tab, dt, master_key)
    nprocessed = int((~state.dead).sum())
    state, nf, nc, nsweeps, _ = sweep_chunk(
        state, tally, geom, scatter_tab, absorb_tab, master_key,
        inv_ntotal, max_sweeps)
    return state, nf, nc, nprocessed, nsweeps
