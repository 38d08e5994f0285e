"""Particle state (structure of arrays) and source injection.

Port of `neutral_tpu/particles.py`.  `ParticleState` holds the same 14
per-lane tensors as the JAX package.  Besides the reference's fields:

  * pid      — immutable global particle id; the RNG stream key.
  * counter  — per-history RNG draw counter for the current timestep.
  * deposit  — energy deposited since the last tally flush.

`pid` and `counter` are int64 tensors here (the JAX package's are uint32;
values stay below 2^32).  PyTorch's uint32 support is partial, and the
RNG (rng.py) works on int64 anyway.

`state_from_numpy` / `state_to_numpy` convert to and from the field dict
of an npz checkpoint (io_utils; uint32 pid/counter, bool dead, int32
cells, as `neutral_tpu.io_utils.save_checkpoint` writes it), so a JAX
state or a JAX npz checkpoint feeds the port directly, and back.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from . import rng
from .mesh import Mesh2D
from .xs import const, to_int

STATE_FIELDS = ("x", "y", "omega_x", "omega_y", "energy", "weight",
                "dt_to_census", "mfp_to_collision", "deposit",
                "cellx", "celly", "dead", "pid", "counter")


@dataclass
class ParticleState:
    x: torch.Tensor
    y: torch.Tensor
    omega_x: torch.Tensor
    omega_y: torch.Tensor
    energy: torch.Tensor
    weight: torch.Tensor
    dt_to_census: torch.Tensor
    mfp_to_collision: torch.Tensor
    deposit: torch.Tensor
    cellx: torch.Tensor          # int32, global cell index
    celly: torch.Tensor          # int32
    dead: torch.Tensor           # bool
    pid: torch.Tensor            # int64
    counter: torch.Tensor        # int64

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    def clone(self) -> "ParticleState":
        return ParticleState(**{f.name: getattr(self, f.name).clone()
                                for f in fields(self)})


def state_from_numpy(d, device=None, dtype=None) -> ParticleState:
    """ParticleState from a field dict of numpy arrays (a JAX state's
    fields, or the arrays of an npz checkpoint), its float fields in
    `dtype` (default: as stored).

    All lanes are kept, including the dead padding lanes the JAX driver
    adds: they are inert in every sweep.
    """
    out = {}
    for f in STATE_FIELDS:
        a = np.asarray(d[f])
        if f in ("pid", "counter"):
            a = a.astype(np.int64)
        t = torch.tensor(a, device=device)     # a copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[f] = t
    return ParticleState(**out)


def merge_states(states: list[ParticleState]) -> dict[str, np.ndarray]:
    """One field dict, in pid order, of states that hold every particle
    between them (one device's state, or a decomposed run's shards): one
    lane per pid, its live lane where it has one.  The dead lanes that
    migration leaves behind and the padding of grown shards are dropped; a
    state with one lane per pid in pid order comes back as it is."""
    parts = [state_to_numpy(s) for s in states]
    d = {f: np.concatenate([p[f] for p in parts]) for f in STATE_FIELDS}
    order = np.lexsort((d["dead"], d["pid"]))     # by pid, live first
    pid = d["pid"][order]
    first = np.ones(pid.shape, dtype=bool)
    first[1:] = pid[1:] != pid[:-1]
    return {f: a[order[first]] for f, a in d.items()}


def state_to_numpy(state: ParticleState) -> dict[str, np.ndarray]:
    """The field dict in `neutral_tpu`'s dtypes (uint32 pid/counter)."""
    out = {}
    for f in STATE_FIELDS:
        a = getattr(state, f).cpu().numpy()
        if f in ("pid", "counter"):
            a = a.astype(np.uint32)
        out[f] = a
    return out


def _find_cell(edges: torch.Tensor, pos: torch.Tensor, ncells: int,
               extent: float, uniform: bool) -> torch.Tensor:
    """Index i with edges[i] <= pos < edges[i+1], clipped to [0, ncells-1]
    (the reference's edge scan, omp3/neutral.c:589-607).

    Uniform meshes floor-divide to a candidate and then correct it once
    against the stored edges, so rounding in the division cannot shift it.
    """
    if not uniform:
        idx = torch.searchsorted(edges, pos, right=True) - 1
        return idx.clamp(0, ncells - 1).to(torch.int32)
    inv = const(float(ncells) / float(extent), pos.dtype)
    cand = to_int(torch.floor(pos * inv), torch.int32).clamp(0, ncells - 1)
    lo = edges[cand]
    hi = edges[cand + 1]
    cand = cand + (pos >= hi).to(torch.int32) - (pos < lo).to(torch.int32)
    return cand.clamp(0, ncells - 1)


def source_cells(mesh: Mesh2D, pid: torch.Tensor, *, source_x0: float,
                 source_y0: float, source_width: float,
                 source_height: float, dtype: torch.dtype,
                 rng_scheme: str = "threefry"):
    """(x, y, cellx, celly) of the injection draws for the given pids:
    position from draw (pid, master_key=0, counter=0)."""
    r0a, r0b = rng.uniform2_scheme(pid, 0, 0, dtype, rng_scheme)
    x = const(source_x0, dtype) + r0a * const(source_width, dtype)
    y = const(source_y0, dtype) + r0b * const(source_height, dtype)
    cellx = _find_cell(mesh.edgex, x, mesh.nx, mesh.width, mesh.uniform)
    celly = _find_cell(mesh.edgey, y, mesh.ny, mesh.height, mesh.uniform)
    return x, y, cellx, celly


def inject_fields(mesh: Mesh2D, pid: torch.Tensor, alive: torch.Tensor, *,
                  source_x0: float, source_y0: float, source_width: float,
                  source_height: float, initial_energy: float, dt: float,
                  dtype: torch.dtype = torch.float32,
                  rng_scheme: str = "threefry",
                  local_coords: tuple[float, float] | None = None
                  ) -> ParticleState:
    """Injection state for an explicit pid vector and alive mask."""
    x, y, cellx, celly = source_cells(
        mesh, pid, source_x0=source_x0, source_y0=source_y0,
        source_width=source_width, source_height=source_height,
        dtype=dtype, rng_scheme=rng_scheme)

    if local_coords is not None:
        # Cell-local offsets (transport.use_local_coords), clipped into
        # the cell in the working precision.
        dx, dy = (const(v, dtype) for v in local_coords)
        x = torch.clamp(x - cellx.to(dtype) * dx, 0.0, dx)
        y = torch.clamp(y - celly.to(dtype) * dy, 0.0, dy)

    # Angle from draw (pid, 0, counter=1): theta = 2*pi*rn.
    r1a, _ = rng.uniform2_scheme(pid, 0, 1, dtype, rng_scheme)
    theta = const(2.0 * np.pi, dtype) * r1a
    omega_x = torch.cos(theta)
    omega_y = torch.sin(theta)

    zeros = torch.zeros(pid.shape, dtype=dtype, device=pid.device)
    return ParticleState(
        x=x, y=y, omega_x=omega_x, omega_y=omega_y,
        energy=torch.where(alive, const(initial_energy, dtype), zeros),
        weight=torch.where(alive, 1.0, zeros),
        dt_to_census=torch.where(alive, const(dt, dtype), zeros),
        mfp_to_collision=zeros.clone(),
        deposit=zeros.clone(),
        cellx=cellx, celly=celly,
        dead=~alive,
        pid=pid,
        counter=torch.zeros(pid.shape, dtype=torch.int64, device=pid.device),
    )


def inject_particles(mesh: Mesh2D, *, nparticles: int, source_x0: float,
                     source_y0: float, source_width: float,
                     source_height: float, initial_energy: float, dt: float,
                     dtype: torch.dtype = torch.float32,
                     rng_scheme: str = "threefry",
                     local_coords: tuple[float, float] | None = None,
                     device=None, pid: torch.Tensor | None = None
                     ) -> ParticleState:
    """Vectorized source injection (the reference's init,
    omp3/neutral.c:576-625): position from draw (pid, 0, 0), cell from an
    edge search, isotropic angle from draw (pid, 0, 1), unit weight, zero
    mean free paths, for the pids 0..nparticles-1 or, given `pid`, for
    that int64 vector of nparticles pids (a decomposition's shard).

    Source geometry is in physical coordinates; `local_coords=(dx, dy)`
    stores x/y as cell-local offsets.  No padding lanes: the kernel takes
    any lane count.

    The plain engine's shards inject through this function, the kernel
    engine's through `inject_kernel.inject_particles_kernel`, one launch
    of csrc/inject.cu that gives the same 14 fields bit for bit
    (census.new_shard chooses, for `Simulation`'s one shard and for each
    of a decomposition's).  `inject_particles.calls` counts its calls;
    callers may reset it.
    """
    inject_particles.calls += 1
    if pid is None:
        pid = torch.arange(int(nparticles), dtype=torch.int64, device=device)
    alive = torch.ones(pid.shape, dtype=torch.bool, device=pid.device)
    return inject_fields(
        mesh, pid, alive, source_x0=source_x0, source_y0=source_y0,
        source_width=source_width, source_height=source_height,
        initial_energy=initial_energy, dt=dt, dtype=dtype,
        rng_scheme=rng_scheme, local_coords=local_coords)


inject_particles.calls = 0
