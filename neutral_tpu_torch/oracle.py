"""Sequential history-based oracle (NumPy/Python, float64).

A copy of `neutral_tpu/oracle.py` that reads the port's constants and
pure-Python draws (`rng.uniform2_py`), so that it runs where JAX is not
installed, such as beside the card.  It is an independent, deliberately
simple statement of the reference semantics: one particle at a time, one
event at a time, the control flow of the reference's per-thread history
loop (omp3/neutral.c:78-198), with the same operation order as
`neutral_tpu.oracle`, so both give the same counts and the same tally bit
for bit.  It pins the vectorised engines in tests and on the card: for
small problems the port's plain engine in float64 reproduces its
per-history event sequence (facet and collision counts exactly, the tally
to accumulation-order rounding).

It is thousands of times slower than the vectorised engines; keep its
problems small.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import rng
from .config import SimConfig
from .constants import (AVOGADROS, BARNS, EV_TO_J, MASS_NO,
                        MIN_ENERGY_OF_INTEREST, MOLAR_MASS,
                        OPEN_BOUND_CORRECTION, PARTICLE_MASS)
from .mesh import build_density, build_edges
from .xs import make_resonance_table

_INV_MOLAR = AVOGADROS / MOLAR_MASS
_A = MASS_NO


@dataclass
class OracleResult:
    tally: np.ndarray
    nfacets: int = 0
    ncollisions: int = 0
    nprocessed: int = 0


def _cs_lookup(keys: np.ndarray, values: np.ndarray, energy: float) -> float:
    ind = int(np.searchsorted(keys, energy, side="right")) - 1
    ind = min(max(ind, 0), len(keys) - 2)
    return values[ind] + ((energy - keys[ind]) / (keys[ind + 1] - keys[ind])) \
        * (values[ind + 1] - values[ind])


@dataclass
class OracleParticle:
    x: float
    y: float
    omega_x: float
    omega_y: float
    energy: float
    weight: float
    dt_to_census: float
    mfp_to_collision: float
    cellx: int
    celly: int
    dead: bool = False


def inject(nparticles: int, *, edgex: np.ndarray, edgey: np.ndarray,
           source_x0: float, source_y0: float, source_w: float,
           source_h: float, initial_energy: float,
           dt: float) -> list[OracleParticle]:
    out = []
    nx = len(edgex) - 1
    ny = len(edgey) - 1
    for k in range(nparticles):
        r0, r1 = rng.uniform2_py(k, 0, 0)
        x = source_x0 + r0 * source_w
        y = source_y0 + r1 * source_h
        cellx = min(max(int(np.searchsorted(edgex, x, side="right")) - 1, 0),
                    nx - 1)
        celly = min(max(int(np.searchsorted(edgey, y, side="right")) - 1, 0),
                    ny - 1)
        t0, _ = rng.uniform2_py(k, 0, 1)
        theta = 2.0 * np.pi * t0
        out.append(OracleParticle(
            x=x, y=y, omega_x=np.cos(theta), omega_y=np.sin(theta),
            energy=initial_energy, weight=1.0, dt_to_census=dt,
            mfp_to_collision=0.0, cellx=cellx, celly=celly))
    return out


def run_config(cfg: SimConfig
               ) -> tuple[np.ndarray, list[dict], list[OracleParticle]]:
    """Every step of a deck through `inject` and `run_timestep`: its mesh
    edges and region density (mesh.build_edges, build_density), the
    generated resonance table for both cross-sections and threefry draws.
    Returns the (ny, nx) tally, one dict of facets `nf`, collisions `nc`
    and particles processed `nproc` per step, and the particles."""
    edgex, edgey = build_edges(cfg)
    density = build_density(cfg)
    table = make_resonance_table()
    parts = inject(cfg.nparticles, edgex=edgex, edgey=edgey,
                   source_x0=cfg.source.xpos * cfg.width,
                   source_y0=cfg.source.ypos * cfg.height,
                   source_w=cfg.source.width * cfg.width,
                   source_h=cfg.source.height * cfg.height,
                   initial_energy=cfg.initial_energy, dt=cfg.dt)
    tally = np.zeros((cfg.ny, cfg.nx))
    stats = []
    for tt in range(1, cfg.niters + 1):
        r = run_timestep(parts, tally, edgex=edgex, edgey=edgey,
                         density=density, cs_scatter=table, cs_absorb=table,
                         dt=cfg.dt, master_key=tt, ntotal=cfg.nparticles)
        stats.append(dict(nf=r.nfacets, nc=r.ncollisions, nproc=r.nprocessed))
    return tally, stats, parts


def run_timestep(particles: list[OracleParticle], tally: np.ndarray, *,
                 edgex: np.ndarray, edgey: np.ndarray, density: np.ndarray,
                 cs_scatter: tuple[np.ndarray, np.ndarray],
                 cs_absorb: tuple[np.ndarray, np.ndarray],
                 dt: float, master_key: int, ntotal: int) -> OracleResult:
    """Track every particle until census/death for one timestep."""
    res = OracleResult(tally=tally)
    nx = density.shape[1]
    ny = density.shape[0]
    inv_ntotal = 1.0 / ntotal
    sk, sv = cs_scatter
    ak, av = cs_absorb

    for pid, p in enumerate(particles):
        if p.dead:
            continue
        res.nprocessed += 1
        counter = 0

        def draw():
            nonlocal counter
            r = rng.uniform2_py(pid, master_key, counter)
            counter += 1
            return r

        local_density = density[p.celly, p.cellx]
        sig_s = _cs_lookup(sk, sv, p.energy)
        sig_a = _cs_lookup(ak, av, p.energy)
        number_density = local_density * _INV_MOLAR
        mac_s = number_density * sig_s * BARNS
        mac_a = number_density * sig_a * BARNS
        speed = np.sqrt(2.0 * p.energy * EV_TO_J / PARTICLE_MASS)
        deposit = 0.0

        # begin-of-step: census clock + fresh mean-free-paths
        p.dt_to_census = dt
        r0, _ = draw()
        p.mfp_to_collision = -np.log(r0) / mac_s

        while p.dt_to_census > 0.0:
            cell_mfp = 1.0 / (mac_s + mac_a)

            # distance to facet
            u_x_inv = 1.0 / (p.omega_x * speed)
            u_y_inv = 1.0 / (p.omega_y * speed)
            if p.omega_x >= 0.0:
                dt_x = (edgex[p.cellx + 1] - p.x) * u_x_inv
            else:
                dt_x = (edgex[p.cellx] - OPEN_BOUND_CORRECTION - p.x) * u_x_inv
            if p.omega_y >= 0.0:
                dt_y = (edgey[p.celly + 1] - p.y) * u_y_inv
            else:
                dt_y = (edgey[p.celly] - OPEN_BOUND_CORRECTION - p.y) * u_y_inv
            x_facet = dt_x < dt_y
            d_facet = (dt_x if x_facet else dt_y) * speed

            d_coll = p.mfp_to_collision * cell_mfp
            d_census = speed * p.dt_to_census

            sig_t = sig_s + sig_a

            def seg_deposit(dist):
                absorb_frac = sig_a / sig_t
                avg_exit = p.energy * ((_A * _A + _A + 1.0)
                                       / ((_A + 1.0) * (_A + 1.0)))
                heating = p.energy - (1.0 - absorb_frac) * avg_exit
                return (p.weight * dist * (sig_t * BARNS) * heating
                        * number_density)

            def flush():
                nonlocal deposit
                res.tally[p.celly, p.cellx] += deposit * inv_ntotal
                deposit = 0.0

            if d_coll < d_facet and d_coll < d_census:
                # ---- collision ----
                res.ncollisions += 1
                deposit += seg_deposit(d_coll)
                p.x += d_coll * p.omega_x
                p.y += d_coll * p.omega_y
                p_absorb = mac_a / (mac_s + mac_a)
                r1a, r1b = draw()
                if r1a < p_absorb:
                    p.weight *= (1.0 - p_absorb)
                    if p.energy < MIN_ENERGY_OF_INTEREST:
                        p.dead = True
                        flush()
                        break
                else:
                    mu_cm = 1.0 - 2.0 * r1b
                    e_new = p.energy * (_A * _A + 2.0 * _A * mu_cm + 1.0) \
                        / ((_A + 1.0) * (_A + 1.0))
                    cos_t = 0.5 * ((_A + 1.0) * np.sqrt(e_new / p.energy)
                                   - (_A - 1.0) * np.sqrt(p.energy / e_new))
                    sin_t = np.sqrt(1.0 - cos_t * cos_t)
                    ox = p.omega_x * cos_t - p.omega_y * sin_t
                    oy = p.omega_x * sin_t + p.omega_y * cos_t
                    p.omega_x, p.omega_y = ox, oy
                    p.energy = e_new
                sig_s = _cs_lookup(sk, sv, p.energy)
                sig_a = _cs_lookup(ak, av, p.energy)
                mac_s = number_density * sig_s * BARNS
                mac_a = number_density * sig_a * BARNS
                r2a, _ = draw()
                p.mfp_to_collision = -np.log(r2a) / mac_s
                p.dt_to_census -= d_coll / speed
                speed = np.sqrt(2.0 * p.energy * EV_TO_J / PARTICLE_MASS)
            elif d_facet < d_census:
                # ---- facet crossing ----
                res.nfacets += 1
                p.mfp_to_collision -= d_facet / cell_mfp
                p.dt_to_census -= d_facet / speed
                deposit += seg_deposit(d_facet)
                flush()
                p.x += d_facet * p.omega_x
                p.y += d_facet * p.omega_y
                if x_facet:
                    if p.omega_x > 0.0:
                        if p.cellx >= nx - 1:
                            p.omega_x = -p.omega_x
                        else:
                            p.cellx += 1
                    elif p.omega_x < 0.0:
                        if p.cellx <= 0:
                            p.omega_x = -p.omega_x
                        else:
                            p.cellx -= 1
                else:
                    if p.omega_y > 0.0:
                        if p.celly >= ny - 1:
                            p.omega_y = -p.omega_y
                        else:
                            p.celly += 1
                    elif p.omega_y < 0.0:
                        if p.celly <= 0:
                            p.omega_y = -p.omega_y
                        else:
                            p.celly -= 1
                local_density = density[p.celly, p.cellx]
                number_density = local_density * _INV_MOLAR
                mac_s = number_density * sig_s * BARNS
                mac_a = number_density * sig_a * BARNS
            else:
                # ---- census ----
                p.x += d_census * p.omega_x
                p.y += d_census * p.omega_y
                p.mfp_to_collision -= d_census / cell_mfp
                deposit += seg_deposit(d_census)
                flush()
                p.dt_to_census = 0.0
                break

    return res
