"""Particle-parallel transport over shards that each see the whole mesh.

Port of `neutral_tpu/parallel/sharding.py`'s replicated mode, the
reference's own distribution on `master` (shard particles, replicate the
mesh, sum tallies at the end: main.c:62-75, omp3/neutral.c:530).  The
particles are split by pid into contiguous ranges, one per shard, so a
shard boundary never changes a particle's RNG stream.  Each shard keeps a
private full-domain partial tally; `host_tally` sums the partials once, as
omp3's final reduction does.  No lane ever leaves its shard, so the loop
of common.py runs with no window and no migration, and a shard whose
lanes have all finished stops launching without waiting for the others.
A restore gives each shard the lanes of its pid range, and shard 0 the
whole restored tally.
"""

from __future__ import annotations

import numpy as np
import torch

from ..census import new_shard
from .common import DecomposedSimulation


class ShardedSimulation(DecomposedSimulation):
    """Replicated-mesh run: pids split in contiguous ranges over shards."""

    decomposition = "replicated"

    def pids_per_shard(self) -> int:
        return -(-self.cfg.nparticles // self.nshards)

    def make_shards(self) -> list:
        n, per = self.cfg.nparticles, self.pids_per_shard()
        return [new_shard(self, self.devices[i], self.geom, torch.arange(
                    min(i * per, n), min((i + 1) * per, n),
                    device=self.devices[i]))
                for i in self.local]

    def restore_owner(self, fields: dict) -> np.ndarray:
        return np.minimum(np.asarray(fields["pid"], dtype=np.int64)
                          // self.pids_per_shard(), self.nshards - 1)

    def tally_part(self, tally: np.ndarray, s: int) -> np.ndarray:
        return np.asarray(tally) if s == 0 else np.zeros_like(tally)

    def host_tally(self) -> np.ndarray:
        """Flat (ny*nx,) global tally: the sum of the shards' partials in
        shard order, in float64 on the host."""
        return sum(t.astype(np.float64) for t in self.shard_tallies())
