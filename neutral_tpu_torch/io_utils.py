"""VisIt dumps and npz checkpoints (port of `neutral_tpu/io_utils.py`).

* BOV (Brick-of-Values) dumps readable by VisIt/ParaView, the counterpart
  of the reference harness's `write_all_ranks_to_visit` (main.c:129-139,
  194-198): a `.bov` header and a `.dat` of little-endian float64 per
  field, byte for byte as neutral_tpu writes them.
* The particle-density histogram (the reference's plot_particle_density,
  main.c:169-200): live particles per cell, counted on the state's device.
* Checkpoints: the whole simulation state is the 14 particle fields, the
  tally and the step, so one compressed npz round-trips a run bitwise
  (draws are keyed by (pid, step), so a restored run replays the same
  histories).  The format is neutral_tpu's npz: a checkpoint of either
  package restores in the other.  Its `coords` tag says whether x/y are
  cell-local (the float32 sweep transport on a uniform pitch) or global,
  and a restore into a run of the other kind raises.  neutral_tpu's Orbax
  directories are JAX's own and are not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .particles import STATE_FIELDS, ParticleState


def write_bov(basename: str, data: np.ndarray, *, variable: str,
              time: float = 0.0) -> None:
    """Write `<basename>.bov` + `<basename>.dat` for a (ny, nx) field."""
    arr = np.asarray(data)
    if arr.ndim != 2:
        raise ValueError(f"BOV writer expects a 2D field, got {arr.shape}")
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    ny, nx = arr.shape
    datfile = basename + ".dat"
    arr.tofile(datfile)
    with open(basename + ".bov", "w") as f:
        f.write(f"TIME: {time}\n")
        f.write(f"DATA_FILE: {os.path.basename(datfile)}\n")
        f.write(f"DATA_SIZE: {nx} {ny} 1\n")
        f.write("DATA_FORMAT: DOUBLE\n")
        f.write(f"VARIABLE: {variable}\n")
        f.write("DATA_ENDIAN: LITTLE\n")
        f.write("CENTERING: zone\n")
        f.write("BRICK_ORIGIN: 0. 0. 0.\n")
        f.write(f"BRICK_SIZE: {nx}. {ny}. 1.\n")


def particle_density(state: ParticleState, nx: int, ny: int) -> np.ndarray:
    """Live particles per cell of the nx x ny mesh, as a (ny, nx) float64
    host array (global cells; out-of-range ones clipped, as neutral_tpu
    does)."""
    live = ~state.dead
    flat = (state.celly[live].to(torch.int64) * nx
            + state.cellx[live].to(torch.int64)).clamp(0, nx * ny - 1)
    counts = torch.bincount(flat, minlength=nx * ny)
    return counts.cpu().numpy().reshape(ny, nx).astype(np.float64)


def save_checkpoint(path: str, fields: dict, tally: np.ndarray, step: int,
                    elapsed_sim_time: float, coords: str = "global") -> None:
    """Write the 14 particle fields (numpy, particles.state_to_numpy's
    dtypes), the global tally, the step and the simulated time as one
    compressed npz, published atomically (no torn checkpoint)."""
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: checkpoints are npz files (.npz); "
                         "neutral_tpu's Orbax directories are not ported")
    payload = {f: np.asarray(fields[f]) for f in STATE_FIELDS}
    payload["tally"] = np.asarray(tally)
    payload["step"] = np.int64(step)
    payload["elapsed_sim_time"] = np.float64(elapsed_sim_time)
    payload["coords"] = np.bytes_(coords)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, expect_coords: str = "global"):
    """(fields, tally, step, elapsed_sim_time) of an npz checkpoint, as host
    arrays; raises if it stores other coordinates than `expect_coords`."""
    with np.load(path) as z:
        coords = (z["coords"].item().decode()
                  if "coords" in z.files else "global")
        if coords != expect_coords:
            raise ValueError(
                f"checkpoint stores {coords!r} coordinates but this "
                f"simulation uses {expect_coords!r} (dtype/fast_math "
                "mismatch between save and restore configs)")
        fields = {f: z[f] for f in STATE_FIELDS}
        return (fields, z["tally"], int(z["step"]),
                float(z["elapsed_sim_time"]))
