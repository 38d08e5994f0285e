"""Decomposed runs: shards on one card or several, in one process or
several (port of `neutral_tpu/parallel/`): the replicated mesh
(`ShardedSimulation`), y-slabs (`SpatialSimulation`) and 2D blocks
(`Spatial2DSimulation`); `initialise_distributed` joins a run over
several processes (distributed.py)."""

from . import distributed  # noqa: F401
from .common import shard_devices  # noqa: F401
from .distributed import initialise_distributed  # noqa: F401
from .sharding import ShardedSimulation  # noqa: F401
from .spatial import (Spatial2DSimulation, SpatialSimulation,  # noqa: F401
                      factor_grid)
