#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (neutral_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. Device: needs `torch.cuda.is_available()` (no CPU run); prints the
   card's name and `nvidia-smi`'s name and power limit.
2. Build: compiles csrc/*.cu with nvcc (neutral_tpu_torch/build.py), timed.
3. Kernel against plain version on the card: the scatter deck's geometry
   and physics (4000^2 mesh, float32) at 65,536, at 1,000,000 and at the
   deck's own 10,000,000 particles (the main path's step-1 state); one
   begin_timestep state goes through the CUDA sweep kernel and through the
   plain PyTorch engine.  Facet and collision totals and all 14 per-lane
   state fields must be exactly equal; the tally sums agree to a relative
   1e-5 (atomics add in another order).  Both times are printed.  A third
   kernel run with 64 events per launch must match too (many launches per
   census).
4. Main path: `neutral_tpu_torch.driver.main(["problems/scatter.params"])`
   in-process at full size (10M particles, 4000^2, 2 steps).  It must
   print `PASSED validation.`, the kernel must have launched, and the plain
   engine must not have run.
5. Result: a JSON line on the kernels, then the JSON result line.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time

DECK = "problems/scatter.params"
COMPARE_SIZES = (65_536, 1_000_000, 10_000_000)


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out = out
        self.buf = io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def differing_field(a, b, torch, fields):
    """The first of `fields` in which states a and b differ, or None."""
    for f in fields:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            return f
    return None


def compare(nparticles: int, torch, driver, transport, sweep_kernel,
            fields):
    """Phase 3 at one size: returns (kernel_ms, plain_ms, max_abs_err).

    Besides the timed runs, the kernel runs once more with 64 events per
    launch, so that one census takes many launches; its state must be
    equal too (the main path's census fits in one launch)."""
    cfg = driver.load_config(DECK).with_(nparticles=nparticles,
                                         expected_tally=None)
    sim = driver.Simulation(cfg, device="cuda", engine="plain", quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    inv = 1.0 / cfg.nparticles

    def timed(fn, **kw):
        state, tally = start.clone(), torch.zeros_like(sim.tally)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, nf, nc, _ = fn(state, tally, sim.geom, sim.cs_scatter,
                              sim.cs_absorb, 1, inv, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, state, nf, nc, tally

    timed(sweep_kernel.sweep_chunk_kernel)            # warm-up
    k_ms, ks, knf, knc, kt = timed(sweep_kernel.sweep_chunk_kernel)
    p_ms, ps, pnf, pnc, pt = timed(sweep_kernel.sweep_chunk_plain)
    print(f"[compare n={nparticles}] kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms; facets {knf} / {pnf}, collisions {knc} / {pnc}",
          flush=True)
    if (knf, knc) != (pnf, pnc):
        fail(f"n={nparticles}: event counts differ: kernel {(knf, knc)} "
             f"plain {(pnf, pnc)}")
    if knc == 0:
        fail(f"n={nparticles}: no collisions, the comparison is empty")
    f = differing_field(ks, ps, torch, fields)
    if f is not None:
        n_bad = int((getattr(ks, f) != getattr(ps, f)).sum())
        fail(f"n={nparticles}: state.{f} differs on {n_bad} lanes")
    ksum, psum = float(kt.double().sum()), float(pt.double().sum())
    max_abs_err = float((kt.double() - pt.double()).abs().max())
    rel = abs(ksum - psum) / abs(psum)
    print(f"[compare n={nparticles}] all {len(fields)} per-lane state fields "
          "equal; tally sums "
          f"{ksum:.9e} / {psum:.9e} (rel {rel:.3e}), max abs err per cell "
          f"{max_abs_err:.3e}")
    if not rel <= 1e-5:
        fail(f"n={nparticles}: tally sums differ by {rel:.3e} (> 1e-5)")
    launches0 = sweep_kernel.sweep_chunk_kernel.launches
    _, cs, cnf, cnc, _ = timed(sweep_kernel.sweep_chunk_kernel,
                               max_events=64)
    nl = sweep_kernel.sweep_chunk_kernel.launches - launches0
    if nl < 2 or (cnf, cnc) != (pnf, pnc) or differing_field(
            cs, ps, torch, fields) is not None:
        fail(f"n={nparticles}: the census in {nl} launches of 64 events "
             "differs from the plain version")
    print(f"[compare n={nparticles}] 64 events per launch: {nl} launches, "
          "counts and per-lane state equal")
    return k_ms, p_ms, max_abs_err


def main() -> int:
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test runs only on a CUDA device", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi: {smi}", flush=True)

    from neutral_tpu_torch import build, driver, sweep_kernel, transport
    from neutral_tpu_torch.particles import STATE_FIELDS

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    path, log = build.build()
    sweep_kernel.load_library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if re.search(r"registers|spill|bytes stack", line):
            print(f"[build] {line.strip()}")

    # ---- 3. kernel against plain version --------------------------------
    results = {n: compare(n, torch, driver, transport, sweep_kernel,
                          STATE_FIELDS)
               for n in COMPARE_SIZES}

    # ---- 4. main path ---------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    sweep_kernel.sweep_chunk_kernel.launches = 0
    sweep_kernel.sweep_chunk_plain.calls = 0
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = driver.main([DECK])
    wall = time.perf_counter() - t0
    launches = sweep_kernel.sweep_chunk_kernel.launches
    plain_calls = sweep_kernel.sweep_chunk_plain.calls
    out = tee.buf.getvalue()
    if rc != 0:
        fail(f"driver.main returned {rc}")
    if "PASSED validation." not in out:
        fail("the full scatter deck did not print 'PASSED validation.'")
    if launches <= 0 or plain_calls != 0:
        fail(f"main path: {launches} kernel launches, {plain_calls} plain "
             "runs (want > 0 and 0)")
    total = float(re.search(r"Final global_energy_tally (\S+)", out)[1])
    if not math.isfinite(total):
        fail(f"tally sum {total} is not finite")
    steps = re.findall(r"Step time\s+(\S+)s\nWallclock.*\nFacets\s+(\d+)\n"
                       r"Collisions\s+(\d+)", out)
    for i, (st, nf, nc) in enumerate(steps, 1):
        st, ev = float(st), int(nf) + int(nc)
        print(f"[main] step {i}: {ev} events in {st:.4f} s = "
              f"{ev / st:.4e} events/s")
    print(f"[main] {launches} kernel launches, 0 plain runs, tally "
          f"{total:.12e}, wall {wall:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- 5. result ------------------------------------------------------
    k_ms, p_ms, err = results[COMPARE_SIZES[-1]]
    print(f"[device] nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"kernels": [{
        "name": "sweep_kernel",
        "route": "cuda",
        "source": "neutral_tpu_torch/csrc/sweep.cu",
        "replaces": "neutral_tpu/pallas_sweep.py:59",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "shape": f"scatter deck, {COMPARE_SIZES[-1]} particles, 4000x4000 "
                 "mesh, one census; ms and plain_ms are whole-census times",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
