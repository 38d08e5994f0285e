"""Decomposed runs: shards on one card or several (port of
`neutral_tpu/parallel/`): the replicated mesh (`ShardedSimulation`), y-slabs
(`SpatialSimulation`) and 2D blocks (`Spatial2DSimulation`)."""

from .common import shard_devices  # noqa: F401
from .sharding import ShardedSimulation  # noqa: F401
from .spatial import (Spatial2DSimulation, SpatialSimulation,  # noqa: F401
                      factor_grid)
