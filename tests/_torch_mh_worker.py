"""One process of a two-process run of the port on the CPU, for
tests/test_torch_multiprocess.py (the counterpart of _mh_worker.py).

Usage: python tests/_torch_mh_worker.py <process_id> <num_processes> <port> <outdir>

It joins the process group (gloo on 127.0.0.1:<port>), then runs every
case of the test in turn, each over the 4 global shards of
`["cpu"] * 4`, 2 of them in this process:

* the scatter-like and csp-like decks of tests/test_torch_parallel.py
  under each decomposition, two steps through `step`: it writes its
  shards' 14 fields, and the global tally and per-step counts, into
  <outdir>/<kind>_<decomposition>_<process_id>.npz;
* a checkpoint of the csp-like spatial2d run after step 2, into
  <outdir>/csp_spatial2d.npz (written by process 0);
* the stream-like deck on 2D blocks with `visit_dump` through `run`, in
  <outdir>/visit<process_id>/ (process 0 writes the files);
* 3 shards over 2 processes, which must raise before any state is built.

It imports nothing of JAX.
"""

import datetime
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import neutral_tpu_torch as tt  # noqa: E402
from neutral_tpu_torch.parallel import distributed  # noqa: E402
from neutral_tpu_torch.parallel import (ShardedSimulation,  # noqa: E402
                                        Spatial2DSimulation)
from neutral_tpu_torch.particles import STATE_FIELDS  # noqa: E402

from test_torch_parallel import CLASSES, make_cfg  # noqa: E402

rank, nprocs, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
distributed.initialise_distributed(f"127.0.0.1:{port}", nprocs, rank,
                                   timeout=datetime.timedelta(seconds=60))
assert distributed.world() == nprocs and distributed.rank() == rank

CPU4 = ["cpu"] * 4

for kind in ("scatter", "csp"):
    for decomposition, cls in CLASSES.items():
        sim = cls(make_cfg(tt, kind), devices=CPU4, quiet=True)
        assert list(sim.local) == [2 * rank, 2 * rank + 1]
        steps = [sim.step(t) for t in (1, 2)]
        out = {f"{s}_{f}": getattr(sh.state, f).numpy()
               for s, sh in zip(sim.local, sim.shards) for f in STATE_FIELDS}
        out["tally"] = sim.host_tally()
        out["stats"] = [(m.nfacets, m.ncollisions, m.nprocessed)
                        for m in steps]
        out["nexchanged"] = [m.nexchanged for m in steps]
        out["nmigrated"] = [m.nmigrated for m in steps]
        out["exchange_phase"] = ["exchange" in m.phases for m in steps]
        np.savez(os.path.join(outdir, f"{kind}_{decomposition}_{rank}.npz"),
                 **out)
        if (kind, decomposition) == ("csp", "spatial2d"):
            sim.checkpoint(os.path.join(outdir, "csp_spatial2d.npz"), 2)

visit = os.path.join(outdir, f"visit{rank}")
os.mkdir(visit)
os.chdir(visit)
sim = Spatial2DSimulation(make_cfg(tt, "stream", visit_dump=True),
                          devices=CPU4, quiet=True)
sim.run()
os.chdir(outdir)
np.save(f"visit_nexchanged_{rank}.npy",
        [m.nexchanged for m in sim.step_metrics])

try:
    ShardedSimulation(make_cfg(tt, "scatter"), devices=["cpu"] * 3,
                      quiet=True)
except ValueError as e:
    print(f"RAISED {e}", flush=True)
print(f"DONE {rank}", flush=True)
