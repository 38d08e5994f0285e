"""Utility CLI: `python -m neutral_tpu_torch.tools <command>` (port of
`neutral_tpu/tools.py`).

Commands:
  gen-cs [outdir]     write elastic_scatter.cs / capture.cs from the
                      generating formula (the reference's resonance.py; the
                      two files hold the same data, as in the reference)
  gen-golden <deck>   run the native engine on a deck and print a
                      `neutral.tests` golden line for it
  compare <deck>      run the native engine and the port's plain engine in
                      float64 on a (small) deck: per-step event counts must
                      be equal and the tallies agree to a relative 1e-10
                      (AGREE, exit code 0; else DISAGREE, exit code 1)
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import load_config
from .constants import CS_CAPTURE_FILENAME, CS_SCATTER_FILENAME

AGREE_RTOL = 1e-10


def cmd_gen_cs(args) -> int:
    from .xs import make_resonance_table, write_cs_file

    keys, values = make_resonance_table()
    for name in (CS_SCATTER_FILENAME, CS_CAPTURE_FILENAME):
        path = os.path.join(args.outdir, name)
        write_cs_file(path, keys, values)
        print(f"wrote {path} ({len(keys)} rows)")
    return 0


def cmd_gen_golden(args) -> int:
    from . import native

    cfg = load_config(args.deck)
    if args.nparticles:
        cfg = cfg.with_(nparticles=args.nparticles)
    if args.rng:
        cfg = cfg.with_(rng=args.rng)
    total = native.NativeSimulation(cfg).run()
    print(f"{args.deck} result={total:.12e}")
    return 0


def cmd_compare(args) -> int:
    import numpy as np
    import torch

    from . import native
    from .driver import Simulation

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print(f"tools compare: --device {args.device}, but "
              "torch.cuda.is_available() is False; pass --device cpu",
              file=sys.stderr)
        return 2
    cfg = load_config(args.deck).with_(dtype="float64", tally_dtype="float64")
    if args.nparticles:
        cfg = cfg.with_(nparticles=args.nparticles)
    if args.mesh_scale:
        cfg = cfg.with_(nx=cfg.nx // args.mesh_scale,
                        ny=cfg.ny // args.mesh_scale)

    nsim = native.NativeSimulation(cfg)
    nat = [nsim.step(tt) for tt in range(1, cfg.niters + 1)]
    nat_tally = float(nsim.tally.sum())

    sim = Simulation(cfg, device=args.device, engine="plain",
                     transport=args.transport, quiet=True)
    port = [(m.nfacets, m.ncollisions, m.nprocessed)
            for m in (sim.step(tt) for tt in range(1, cfg.niters + 1))]
    port_tally = float(np.sum(sim.host_tally()))

    ok = True
    for tt, (ne, pe) in enumerate(zip(nat, port), 1):
        match = tuple(ne) == tuple(pe)
        ok &= match
        print(f"step {tt}: native ev={tuple(ne)} port ev={tuple(pe)} "
              f"{'OK' if match else 'MISMATCH'}")
    rel = abs(nat_tally - port_tally) / max(abs(nat_tally), 1e-300)
    print(f"tally native={nat_tally:.15e} port={port_tally:.15e} "
          f"rel={rel:.2e}")
    ok = ok and rel < AGREE_RTOL
    print(f"AGREE (port {sim.transport} transport on {sim.device})" if ok
          else "DISAGREE")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="neutral_tpu_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen-cs", help="write the .cs data files")
    g.add_argument("outdir", nargs="?", default=".")
    g.set_defaults(fn=cmd_gen_cs)

    g = sub.add_parser("gen-golden", help="golden tally via the native engine")
    g.add_argument("deck")
    g.add_argument("--nparticles", type=int, default=None)
    g.add_argument("--rng", default=None, choices=["threefry", "pcg64si"],
                   help="draw scheme (pcg64si: the goldens of "
                        "problems/neutral_pcg.tests)")
    g.set_defaults(fn=cmd_gen_golden)

    g = sub.add_parser("compare",
                       help="native engine vs the port's plain engine")
    g.add_argument("deck")
    g.add_argument("--nparticles", type=int, default=None)
    g.add_argument("--mesh-scale", type=int, default=None,
                   help="divide nx/ny (keeps comparisons quick)")
    g.add_argument("--transport", default="sweep",
                   choices=["sweep", "flight"],
                   help="the port's transport (flight: the same collision "
                        "draws, facet counts from analytic cell crossings)")
    g.add_argument("--device", default="cuda",
                   help="torch device of the port's run (default: cuda; "
                        "--device cpu runs it on the CPU)")
    g.set_defaults(fn=cmd_compare)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
