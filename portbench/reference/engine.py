"""The plain reference of a solve: the upstream `neutral` history loop,
vectorised over the compared particles, in plain PyTorch.

Independent of the program under test.  It reads a deck from the
benchmark's configuration file (`Deck.from_file`) and works out again,
from the deck and each census's master key, everything the program
derives: the mesh edges and each cell's density, the generated resonance
cross-section table, every particle's injection, each census's start,
every event (facet crossing, collision, census) and every tally flush.
The formulas and their order are those of the upstream's omp3 backend
(neutral.c: injection 576-625, the census start 127-131, the three
events 209-405, the deposit 474-495, the lookup 513-516) in global
coordinates, in float64 by default: the upstream's own precision.

Each history draws from Threefry-2x64 with 20 rounds, keyed by (particle
id, master key) with the counter (draw index, 0) (Random123, as
neutral.c:632-652); injection takes master key 0.  Here the 64-bit words
live in int64 tensors, whose additions and left shifts wrap modulo 2^64.

One lane per compared particle (a sample, or every particle of the
deck).  A census runs every working lane through one event per iteration
until each has reached census or died; whenever half of the lanes it
works on have finished, it gathers the rest into a smaller working set,
so its cost follows the histories' events rather than the number of
lanes times the longest history.  `dtype` sets the working precision of
every float: the comparison's control passes bfloat16, where histories
can stall, so `max_iterations` bounds a census and the lanes still
working are marked `unfinished`.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, fields

import numpy as np
import torch

# Public physical constants and the upstream's dummy material
# (neutral_data.h:17-27).
EV_TO_J = 1.60217646e-19
AVOGADROS = 6.02214085774e23
BARNS = 1.0e-28
PARTICLE_MASS = 1.674927471213e-27
MASS_NO = 1.0e2
MOLAR_MASS = 1.0e-2
MIN_ENERGY_OF_INTEREST = 1.0e0
OPEN_BOUND_CORRECTION = 1.0e-13
INV_MOLAR = AVOGADROS / MOLAR_MASS

# The upstream's dummy resonance table (capture.cs and elastic_scatter.cs
# are byte-identical): energy[r] = 1e8 (r/29999)^4 + 1e-2 eV and
# value[r] = 1e3 (30000 - r)/29999 + 1 barns, r = 1..29999.
TABLE_ROWS = 30000

# Threefry-2x64 (Salmon et al., SC'11): rotations and key-schedule parity.
ROTATIONS = (16, 42, 12, 31, 16, 32, 24, 21)
PARITY = 0x1BD11BDAA9FC1A22
ROUNDS = 20
M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Deck:
    """A problem deck: the upstream's `.params` keys and its regions."""
    nx: int
    ny: int
    dt: float
    iterations: int
    nparticles: int
    initial_energy: float
    source: tuple          # (xpos, ypos, width, height), fractions
    problems: tuple        # ((density, xpos, ypos, width, height), ...)
    width: float = 1.0
    height: float = 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "Deck":
        s = d["source_box"]
        return cls(nx=int(d["nx"]), ny=int(d["ny"]), dt=float(d["dt"]),
                   iterations=int(d["iterations"]),
                   nparticles=int(d["nparticles"]),
                   initial_energy=float(d["initial_energy"]),
                   source=(s["xpos"], s["ypos"], s["width"], s["height"]),
                   problems=tuple((p["density"], p["xpos"], p["ypos"],
                                   p["width"], p["height"])
                                  for p in d["problems"]),
                   width=float(d.get("width", 1.0)),
                   height=float(d.get("height", 1.0)))

    @classmethod
    def from_file(cls, path: str) -> "Deck":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def edges(deck: Deck) -> tuple[np.ndarray, np.ndarray]:
    """Uniform cell edges, i * (extent / n), float64."""
    return (np.arange(deck.nx + 1, dtype=np.float64) * (deck.width / deck.nx),
            np.arange(deck.ny + 1, dtype=np.float64)
            * (deck.height / deck.ny))


def density_grid(deck: Deck) -> np.ndarray:
    """(ny, nx) density: later regions overwrite earlier ones, a cell
    belonging to a region when its centre lies in the half-open box."""
    cx = (np.arange(deck.nx) + 0.5) * (deck.width / deck.nx)
    cy = (np.arange(deck.ny) + 0.5) * (deck.height / deck.ny)
    grid = np.zeros((deck.ny, deck.nx))
    for density, xp, yp, w, h in deck.problems:
        x0, y0 = xp * deck.width, yp * deck.height
        mx = (cx >= x0) & (cx < x0 + w * deck.width)
        my = (cy >= y0) & (cy < y0 + h * deck.height)
        grid[np.ix_(my, mx)] = density
    return grid


def resonance_table() -> tuple[np.ndarray, np.ndarray]:
    r = np.arange(1, TABLE_ROWS, dtype=np.float64)
    return (1.0e8 * (r / (TABLE_ROWS - 1)) ** 4 + 1.0e-2,
            1.0e3 * ((TABLE_ROWS - r) / (TABLE_ROWS - 1)) + 1.0)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (64 - r)) & ((1 << r) - 1))


def key_tensor(key: int, device) -> torch.Tensor:
    """A master key (a u64) as a 0-d int64 tensor holding its bits."""
    return torch.tensor(key - (1 << 64) if key >= 1 << 63 else key,
                        dtype=torch.int64, device=device)


def threefry(counter: torch.Tensor, key0: torch.Tensor, key1: torch.Tensor):
    """Threefry-2x64-20 of the block (counter, 0) under (key0, key1):
    both output words as int64 tensors holding the u64 bits."""
    ks = (key0, key1, key0 ^ key1 ^ PARITY)
    x0 = counter + ks[0]
    x1 = ks[1].expand_as(x0).clone()
    for r in range(ROUNDS):
        x0 = x0 + x1
        x1 = _rotl(x1, ROTATIONS[r % 8]) ^ x0
        if (r + 1) % 4 == 0:
            j = (r + 1) // 4
            x0 = x0 + ks[j % 3]
            x1 = x1 + ks[(j + 1) % 3] + j
    return x0, x1


def to_unit(word: torch.Tensor) -> torch.Tensor:
    """u = (double)u64 * 2^-64 + 2^-65, strictly inside (0, 1)."""
    hi = ((word >> 32) & M32).to(torch.float64)
    lo = (word & M32).to(torch.float64)
    return (hi * 4294967296.0 + lo) * 2.0 ** -64 + 2.0 ** -65


def draw(pid: torch.Tensor, key, counter, dtype):
    """The pair of uniforms of draw `counter` of each history under the
    master key `key` (an int or a key_tensor)."""
    if not isinstance(counter, torch.Tensor):
        counter = torch.full_like(pid, counter)
    if not isinstance(key, torch.Tensor):
        key = key_tensor(key, pid.device)
    w0, w1 = threefry(counter, pid, key)
    return to_unit(w0).to(dtype), to_unit(w1).to(dtype)


class Tables:
    """The deck's geometry and cross-sections on a device, in `dtype`."""

    def __init__(self, deck: Deck, dtype, device):
        ex, ey = edges(deck)
        keys, values = resonance_table()
        self.edgex = torch.tensor(ex, dtype=dtype, device=device)
        self.edgey = torch.tensor(ey, dtype=dtype, device=device)
        self.density = torch.tensor(density_grid(deck).reshape(-1),
                                    dtype=dtype, device=device)
        # searchsorted runs on the float64 keys, whatever `dtype` is
        self.keys64 = torch.tensor(keys, device=device)
        self.keys = self.keys64.to(dtype)
        self.values = torch.tensor(values, dtype=dtype, device=device)

    def sigma(self, energy: torch.Tensor) -> torch.Tensor:
        """Interpolated microscopic cross-section at `energy` (barns)."""
        n = self.keys.shape[0]
        i = (torch.searchsorted(self.keys64, energy.to(torch.float64),
                                right=True) - 1).clamp(0, n - 2)
        k0, k1 = self.keys[i], self.keys[i + 1]
        v0, v1 = self.values[i], self.values[i + 1]
        return v0 + ((energy - k0) / (k1 - k0)) * (v1 - v0)


@dataclass
class Lanes:
    """One lane per sampled particle, global coordinates."""
    pid: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    omega_x: torch.Tensor
    omega_y: torch.Tensor
    energy: torch.Tensor
    weight: torch.Tensor
    dt_to_census: torch.Tensor
    mfp_to_collision: torch.Tensor
    cellx: torch.Tensor
    celly: torch.Tensor
    dead: torch.Tensor
    counter: torch.Tensor

    def numpy(self) -> dict:
        """Every field as a host array, floats in float64."""
        out = {}
        for f in fields(self):
            t = getattr(self, f.name).cpu()
            out[f.name] = (t.double() if t.is_floating_point() else t).numpy()
        return out


def inject(deck: Deck, pid: torch.Tensor, dtype) -> Lanes:
    """Position from draw (pid, 0, 0), cell by edge search, isotropic
    angle from draw (pid, 0, 1), unit weight (neutral.c:576-625)."""
    sx, sy, sw, sh = deck.source
    r0a, r0b = draw(pid, 0, 0, torch.float64)
    x = sx * deck.width + r0a * (sw * deck.width)
    y = sy * deck.height + r0b * (sh * deck.height)
    ex, ey = (torch.tensor(e, device=pid.device) for e in edges(deck))
    cellx = (torch.searchsorted(ex, x, right=True) - 1).clamp(0, deck.nx - 1)
    celly = (torch.searchsorted(ey, y, right=True) - 1).clamp(0, deck.ny - 1)
    r1a, _ = draw(pid, 0, 1, torch.float64)
    theta = 2.0 * math.pi * r1a
    zeros = torch.zeros(pid.shape, dtype=dtype, device=pid.device)
    return Lanes(pid=pid, x=x.to(dtype), y=y.to(dtype),
                 omega_x=torch.cos(theta).to(dtype),
                 omega_y=torch.sin(theta).to(dtype),
                 energy=zeros + deck.initial_energy, weight=zeros + 1.0,
                 dt_to_census=zeros + deck.dt, mfp_to_collision=zeros.clone(),
                 cellx=cellx, celly=celly,
                 dead=torch.zeros(pid.shape, dtype=torch.bool,
                                  device=pid.device),
                 counter=torch.zeros_like(pid))


@dataclass
class Solve:
    """A solve of the compared particles: their final lanes, and per lane
    and census whether it was live at the census's start, its facets and
    collisions, and the energy it flushed into each quadrant of the mesh
    (quadrant 2 * (y in the upper half) + (x in the right half)), already
    divided by the deck's particle count, as the tally holds it; with
    `grid`, also the whole (ny * nx,) tally that these particles flush."""
    lanes: Lanes
    live: torch.Tensor           # (steps, K) bool
    facets: torch.Tensor         # (steps, K) int64
    collisions: torch.Tensor     # (steps, K) int64
    quadrant_tally: torch.Tensor  # (K, 4) float64
    unfinished: torch.Tensor     # (K,) bool: stopped at max_iterations
    iterations: list
    tally: torch.Tensor | None = None   # (ny * nx,) float64


def solve(deck: Deck, pid: torch.Tensor, keys: list[int], dtype=torch.float64,
          max_iterations: int | None = None, grid: bool = False) -> Solve:
    """Inject the particles `pid` and run one census per master key."""
    tabs = Tables(deck, dtype, pid.device)
    lanes = inject(deck, pid, dtype)
    k = pid.shape[0]
    dev = pid.device
    live_rows, facet_rows, coll_rows, iters = [], [], [], []
    quad = torch.zeros((k, 4), dtype=torch.float64, device=dev)
    tally = (torch.zeros(deck.nx * deck.ny, dtype=torch.float64, device=dev)
             if grid else None)
    unfinished = torch.zeros(k, dtype=torch.bool, device=dev)
    for key in keys:
        census = Census(lanes, tabs, deck, key, dtype, quad, tally)
        live_rows.append(~lanes.dead)
        iters.append(census.run(max_iterations))
        unfinished |= census.active_all
        facet_rows.append(census.nf_all)
        coll_rows.append(census.nc_all)
    return Solve(lanes, torch.stack(live_rows), torch.stack(facet_rows),
                 torch.stack(coll_rows), quad, unfinished, iters, tally)


class Census:
    """One census timestep of every lane, in place (neutral.c:19-206).

    `event` advances every lane of the working set (`w`, the lanes `idx`
    of the census) by one event and writes them back into the same
    tensors, with no host read, so that on a card it is captured as a
    CUDA graph and replayed: the same arithmetic without a host launch per
    operation.  A lane that no longer works is left unchanged by `event`;
    once half of the working set is such, `run` stores the set back and
    gathers the working lanes into a smaller one (and captures anew).
    No arithmetic crosses lanes, so the working set's size changes no
    lane's result."""

    CHECK_EVERY = 32          # events between host reads of the working
    LEAST_SET = 4096          # lanes below which the set is not shrunk

    def __init__(self, p: Lanes, tabs: Tables, deck: Deck, key: int, dtype,
                 quad: torch.Tensor, tally: torch.Tensor | None = None):
        dev = p.pid.device
        self.p, self.tabs, self.deck = p, tabs, deck
        self.quad_all, self.tally = quad, tally
        self.dtype = dtype
        self.key = key_tensor(key, dev)
        k = p.pid.shape[0]
        self.nf_all = torch.zeros(k, dtype=torch.int64, device=dev)
        self.nc_all = torch.zeros(k, dtype=torch.int64, device=dev)
        self.zero = torch.zeros((), dtype=dtype, device=dev)
        self.A = torch.tensor(MASS_NO, dtype=dtype, device=dev)
        self.inv_molar = torch.tensor(INV_MOLAR, dtype=dtype, device=dev)
        self.barns = torch.tensor(BARNS, dtype=dtype, device=dev)
        self.speed_num = torch.tensor(2.0 * EV_TO_J, dtype=dtype, device=dev)
        self.mass = torch.tensor(PARTICLE_MASS, dtype=dtype, device=dev)
        self.obc = torch.tensor(OPEN_BOUND_CORRECTION, dtype=dtype,
                                device=dev)
        A = self.A
        self.avg_exit = (A * A + A + 1.0) / ((A + 1.0) * (A + 1.0))
        # the census start: the clock and a fresh mean free path (draw 0)
        live = ~p.dead
        nd, sig_s = self.macro(p.energy, p.celly * deck.nx + p.cellx)
        r0, _ = draw(p.pid, self.key, 0, dtype)
        p.dt_to_census = torch.where(
            live, torch.tensor(deck.dt, dtype=dtype, device=dev), self.zero)
        p.mfp_to_collision = torch.where(
            live, -torch.log(r0) / (nd * sig_s * self.barns),
            p.mfp_to_collision)
        p.counter = torch.ones_like(p.counter)
        self.deposit_all = torch.zeros_like(p.energy)
        self.active_all = live & (p.dt_to_census > 0.0)
        self.select(torch.arange(k, device=dev))

    # per lane: the Lanes' fields, and the census's own
    OWN = ("deposit", "active", "nf", "nc")

    def select(self, idx: torch.Tensor) -> None:
        """Make the lanes `idx` the working set."""
        self.idx, self.k = idx, idx.shape[0]
        self.w = Lanes(**{f.name: getattr(self.p, f.name)[idx]
                          for f in fields(Lanes)})
        for name in self.OWN:
            setattr(self, name, getattr(self, name + "_all")[idx])
        self.quad = torch.zeros((self.k, 4), dtype=torch.float64,
                                device=idx.device)

    def store(self) -> None:
        """Write the working set back into the census's lanes."""
        for f in fields(Lanes):
            getattr(self.p, f.name)[self.idx] = getattr(self.w, f.name)
        for name in self.OWN:
            getattr(self, name + "_all")[self.idx] = getattr(self, name)
        self.quad_all.index_add_(0, self.idx, self.quad)
        self.quad.zero_()

    def macro(self, energy, cell):
        """Number density and the microscopic cross-section (one table
        serves capture and scatter)."""
        return (self.tabs.density[cell] * self.inv_molar,
                self.tabs.sigma(energy))

    def capture(self):
        """The working set's event as a CUDA graph's replay, after one
        real event run eagerly (which `run` counts)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.event()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.event()
        return graph.replay

    def run(self, max_iterations: int | None) -> int:
        """Events until no lane works (or `max_iterations`); returns the
        events run, a little past the last one needed."""
        step, n = None, 0
        while max_iterations is None or n < max_iterations:
            if step is None or n % self.CHECK_EVERY == 0:
                working = int(self.active.sum())
                if working == 0:
                    break
                if step is None or (2 * working <= self.k
                                    and self.k > self.LEAST_SET):
                    self.store()
                    self.select(torch.nonzero(self.active_all)[:, 0])
                    step = self.event
                    if self.p.pid.is_cuda:
                        step = self.capture()
                        n += 1
                        continue
            step()
            n += 1
        self.store()
        return n

    def event(self) -> None:
        """Every working lane through one event (neutral.c:209-405)."""
        p, tabs, deck, dtype = self.w, self.tabs, self.deck, self.dtype
        nx, ny, k, A, zero = deck.nx, deck.ny, self.k, self.A, self.zero
        active = self.active
        cell = p.celly * nx + p.cellx
        nd, sig_s = self.macro(p.energy, cell)
        sig_a = sig_s
        mac_s, mac_a = nd * sig_s * self.barns, nd * sig_a * self.barns
        cell_mfp = 1.0 / (mac_s + mac_a)
        speed = torch.sqrt(self.speed_num * p.energy / self.mass)

        # distance to the facet (neutral.c:423-471)
        ux_inv = 1.0 / (p.omega_x * speed)
        uy_inv = 1.0 / (p.omega_y * speed)
        dt_x = torch.where(p.omega_x >= 0.0,
                           (tabs.edgex[p.cellx + 1] - p.x) * ux_inv,
                           (tabs.edgex[p.cellx] - self.obc - p.x) * ux_inv)
        dt_y = torch.where(p.omega_y >= 0.0,
                           (tabs.edgey[p.celly + 1] - p.y) * uy_inv,
                           (tabs.edgey[p.celly] - self.obc - p.y) * uy_inv)
        x_facet = dt_x < dt_y
        d_facet = torch.where(x_facet, dt_x, dt_y) * speed
        d_coll = p.mfp_to_collision * cell_mfp
        d_census = speed * p.dt_to_census

        is_coll = active & (d_coll < d_facet) & (d_coll < d_census)
        is_facet = active & ~is_coll & (d_facet < d_census)
        is_census = active & ~is_coll & ~is_facet
        dist = torch.where(is_coll, d_coll,
                           torch.where(is_facet, d_facet, d_census))

        # the segment's deposit, pre-event state (neutral.c:474-495)
        sig_t = sig_s + sig_a
        heating = p.energy - (1.0 - sig_a / sig_t) * (p.energy * self.avg_exit)
        deposit = self.deposit + torch.where(
            active, p.weight * dist * (sig_t * self.barns) * heating * nd,
            zero)
        x = p.x + torch.where(active, dist * p.omega_x, zero)
        y = p.y + torch.where(active, dist * p.omega_y, zero)

        # collision (neutral.c:209-300): draw c, and c + 1 if it survives
        u0, u1 = draw(torch.cat([p.pid, p.pid]), self.key,
                      torch.cat([p.counter, p.counter + 1]), dtype)
        r1a, r1b, r2a = u0[:k], u1[:k], u0[k:]
        p_absorb = mac_a / (mac_s + mac_a)
        absorbed = is_coll & (r1a < p_absorb)
        weight = torch.where(absorbed, p.weight * (1.0 - p_absorb), p.weight)
        died = absorbed & (p.energy < MIN_ENERGY_OF_INTEREST)
        scattered = is_coll & ~absorbed
        mu = 1.0 - 2.0 * r1b
        e_new = p.energy * (A * A + 2.0 * A * mu + 1.0) / ((A + 1.0)
                                                           * (A + 1.0))
        cos_t = 0.5 * ((A + 1.0) * torch.sqrt(e_new / p.energy)
                       - (A - 1.0) * torch.sqrt(p.energy / e_new))
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        omega_x = torch.where(scattered, p.omega_x * cos_t - p.omega_y * sin_t,
                              p.omega_x)
        omega_y = torch.where(scattered, p.omega_x * sin_t + p.omega_y * cos_t,
                              p.omega_y)
        energy = torch.where(scattered, e_new, p.energy)
        survived = is_coll & ~died
        _, sig_s2 = self.macro(energy, cell)
        mfp = torch.where(survived, -torch.log(r2a) / (nd * sig_s2
                                                       * self.barns),
                          p.mfp_to_collision)
        dt_left = torch.where(survived, p.dt_to_census - d_coll / speed,
                              p.dt_to_census)

        # facet (neutral.c:303-380) and census (383-405)
        mfp = torch.where(is_facet | is_census, mfp - dist / cell_mfp, mfp)
        dt_left = torch.where(is_facet, dt_left - d_facet / speed,
                              torch.where(is_census, zero, dt_left))

        # flushes: leaving a cell, reaching census, dying
        flush = is_facet | is_census | died
        q = (2 * (p.celly >= ny // 2) + (p.cellx >= nx // 2)).long()
        contrib = torch.where(flush, deposit.to(torch.float64)
                              * (1.0 / deck.nparticles), 0.0)
        self.quad.scatter_add_(1, q[:, None], contrib[:, None])
        if self.tally is not None:
            self.tally.index_add_(0, cell, contrib)
        deposit = torch.where(flush, zero, deposit)

        # the facet's new cell, or a reflection at the domain's edge
        fx, fy = is_facet & x_facet, is_facet & ~x_facet
        px, mx = omega_x > 0.0, omega_x < 0.0
        py, my = omega_y > 0.0, omega_y < 0.0
        refl_x = fx & ((px & (p.cellx >= nx - 1)) | (mx & (p.cellx <= 0)))
        refl_y = fy & ((py & (p.celly >= ny - 1)) | (my & (p.celly <= 0)))
        step_x = ((fx & px & (p.cellx < nx - 1)).long()
                  - (fx & mx & (p.cellx > 0)).long())
        step_y = ((fy & py & (p.celly < ny - 1)).long()
                  - (fy & my & (p.celly > 0)).long())

        # every lane's new state, into the same tensors
        for t, v in ((p.x, x), (p.y, y),
                     (p.omega_x, torch.where(refl_x, -omega_x, omega_x)),
                     (p.omega_y, torch.where(refl_y, -omega_y, omega_y)),
                     (p.energy, energy), (p.weight, weight),
                     (p.mfp_to_collision, mfp), (p.dt_to_census, dt_left),
                     (p.cellx, p.cellx + step_x), (p.celly, p.celly + step_y),
                     (p.counter, p.counter + is_coll.long()
                      + survived.long()),
                     (p.dead, p.dead | died), (self.deposit, deposit),
                     (self.active, active & ~is_census & ~died)):
            t.copy_(v)
        self.nf += is_facet.long()
        self.nc += is_coll.long()
