"""The benchmark of `neutral_tpu_torch`: replicas of a deck solved back to
back on the card, one client in a closed loop.

A cell of BENCHMARK.json names a configuration (configs/<config>.json: a
deck of the upstream `neutral` mini-app, as run) and a traffic
(traffic/<traffic>.json: the working and tally types and the transport).
A run:

1. set-up: imports torch and the port, loads the kernel library (built
   into the checkout at its first run), makes the configuration and
   solves one warm-up replica;
2. the window: solves replicas back to back for `--seconds` seconds, to
   the first solve boundary after them.  A solve is what a user's run of
   the deck does once the process is up: `driver.make_simulation` (mesh,
   cross-sections, injection, kernel buffers), `step(key)` for each of
   the deck's censuses, and the global tally read to the host
   (`host_tally`).  Replica r keys its census s by
   check.master_key(seed, r, s), so only the histories change;
3. the check (check.py): one solve of the window, drawn from the seed,
   and the particles that the cell's limits file names (a sample, or
   every particle), against the plain reference, once the window has
   closed and its memory peak is read;
4. the result: the cell's end-to-end metrics (`--trace 0`) or its
   per-layer metrics (`--trace 1`, the window under torch.profiler), each
   read by metrics/<name>.py from the window's records.  No result is
   printed if JAX or the JAX package has been loaded by then.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "neutral_tpu")
SPAN = "portbench."


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(name: str, bench: dict | None = None) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration and
    traffic files, and the metrics it reports (by --trace)."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json "
                         f"(have {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {"name": name, "chips": w["chips"],
            "config": load_json(ROOT, configs[w["config"]]["file"]),
            "traffic": load_json(HERE, "traffic", f"{w['traffic']}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def sim_config(config: dict, traffic: dict):
    """The port's SimConfig of a configuration file under a traffic."""
    from neutral_tpu_torch import ProblemRegion, SimConfig, SourceBox
    s = config["source_box"]
    return SimConfig(
        nx=config["nx"], ny=config["ny"], dt=config["dt"],
        niters=config["iterations"], nparticles=config["nparticles"],
        initial_energy=config["initial_energy"],
        width=config.get("width", 1.0), height=config.get("height", 1.0),
        source=SourceBox(s["xpos"], s["ypos"], s["width"], s["height"]),
        problems=tuple(ProblemRegion(p["density"], p["xpos"], p["ypos"],
                                     p["width"], p["height"])
                       for p in config["problems"]),
        rng=config.get("rng", "threefry"),
        fast_math=bool(config.get("fast_math", 1)),
        dtype=traffic["dtype"], tally_dtype=traffic["tally_dtype"])


@dataclass
class Record:
    """A run's record of its window."""
    setup_s: float = 0.0
    window_s: float = 0.0
    solves: list = field(default_factory=list)   # dicts, one a solve
    memory_peak_bytes: int = 0
    trace: dict | None = None
    kept: dict | None = None                     # the compared solve
    setup_parts: dict = field(default_factory=dict)  # seconds by stage


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def refuse_forbidden(when: str) -> None:
    """Exit, with no result, if JAX or the JAX package is loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"portbench: {', '.join(bad)} loaded {when}", file=sys.stderr)
        raise SystemExit(3)


# -- the window ---------------------------------------------------------------

def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def solve(device, cfg, traffic: dict, seed: int, replica: int,
          keep: dict | None = None) -> dict:
    """One solve of replica `replica` on `device`, timed from its start to
    the global tally on the host.  `keep` ({"pids", "grid"}): also keep
    what the check compares of it (kept_lanes)."""
    from neutral_tpu_torch import driver
    from torch.profiler import record_function
    from .check import master_key

    t0 = time.perf_counter()
    with record_function(SPAN + "solve_setup"):
        sim = driver.make_simulation(cfg, "replicated", [device], quiet=True,
                                     transport=traffic["transport"])
        sync(device)
    t1 = time.perf_counter()
    steps = []
    for s in range(1, cfg.niters + 1):
        with record_function(SPAN + "census"):
            m = sim.step(master_key(seed, replica, s))
        steps.append({"live": m.nprocessed, "facets": m.nfacets,
                      "collisions": m.ncollisions, "phases": m.phases,
                      "launches": m.nlaunches})
    t2 = time.perf_counter()
    with record_function(SPAN + "tally_read"):
        tally = sim.host_tally()
    t3 = time.perf_counter()
    out = {"replica": replica, "solve_s": t3 - t0,
           "setup_ms": (t1 - t0) * 1e3, "tally_ms": (t3 - t2) * 1e3,
           "steps": steps,
           "transport": sim.transport, "engine": sim.engine}
    if keep is not None:
        out["kept"] = kept_lanes(sim, keep, tally, cfg)
        out["kept"]["steps"] = [(st["live"], st["facets"], st["collisions"])
                                for st in steps]
    del sim
    return out


def kept_lanes(sim, keep: dict, tally, cfg) -> dict:
    """The program's rows of the compared particles (global coordinates,
    host arrays), the tally's quadrant sums and, with keep["grid"], the
    whole tally."""
    import numpy as np
    import torch
    from .check import FIELDS
    local = sim.coords() == "cell-local"
    parts = []
    for st in sim.states():
        sel = torch.isin(st.pid, torch.as_tensor(keep["pids"],
                                                 device=st.pid.device))
        row = {f: getattr(st, f)[sel].cpu() for f in FIELDS}
        row = {f: (v.double() if v.is_floating_point() else v).numpy()
               for f, v in row.items()}
        if local:
            row["x"] = row["x"] + row["cellx"] * (cfg.width / cfg.nx)
            row["y"] = row["y"] + row["celly"] * (cfg.height / cfg.ny)
        parts.append(row)
    rows = {f: np.concatenate([p[f] for p in parts]) for f in FIELDS}
    grid = np.asarray(tally).reshape(cfg.ny, cfg.nx)
    hy, hx = cfg.ny // 2, cfg.nx // 2
    quads = [float(grid[:hy, :hx].sum()), float(grid[:hy, hx:].sum()),
             float(grid[hy:, :hx].sum()), float(grid[hy:, hx:].sum())]
    out = {"rows": rows, "quadrants": quads}
    if keep["grid"]:
        out["tally"] = np.asarray(tally, dtype=np.float64).reshape(-1)
    return out


def keep_plan(cell: dict, seed: int, nparticles: int) -> dict:
    """What the check compares of a solve: the particles (check.sample of
    the limits file's "sample") and whether the whole tally."""
    from . import check as chk
    limits = chk.load_limits(cell["name"])
    return {"pids": chk.sample(seed, nparticles, limits["sample"]),
            "grid": "tally_gap" in limits}


def run_window(cell: dict, seed: int, seconds: float, trace: bool, *,
               device: str = "cuda", t_start: float | None = None,
               config_override: dict | None = None) -> Record:
    """Set-up, the window and what the check needs, on one device."""
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("imports", time.perf_counter())]
    import torch
    from .check import kept_replica
    config = {**cell["config"], **(config_override or {})}
    traffic = cell["traffic"]
    dev = torch.device(device)
    if dev.type == "cuda":
        from neutral_tpu_torch import build
        build.load()
    marks.append(("kernel_library", time.perf_counter()))
    cfg = sim_config(config, traffic)
    keep_all = keep_plan(cell, seed, cfg.nparticles)
    # warm-up: one replica, every shape this cell's solves use
    warm = solve(dev, cfg, traffic, seed, -1, keep=keep_all)
    marks.append(("warm_solve", time.perf_counter()))
    keep = kept_replica(seed, warm["solve_s"], seconds)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    rec = Record()
    t0 = time.perf_counter()
    rec.setup_s = t0 - t_start
    rec.setup_parts = {name: t - t_prev for (name, t), t_prev
                       in zip(marks, [t_start] + [t for _, t in marks])}
    from torch.profiler import record_function
    with record_function(SPAN + "window"):
        replica = 0
        while True:
            s = solve(dev, cfg, traffic, seed, replica,
                      keep=keep_all if replica == keep else None)
            rec.kept = s.pop("kept", rec.kept)
            rec.solves.append(s)
            replica += 1
            if time.perf_counter() - t0 >= seconds:
                break
    rec.window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
        from .trace import summarise
        rec.trace = summarise(prof.profiler.kineto_results.events())
        del prof
    if rec.kept is None:              # a window shorter than foreseen
        rec.kept = warm["kept"]
        rec.kept["replica"] = -1
    else:
        rec.kept["replica"] = keep
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    refuse_forbidden("once the window had closed")
    return rec


def cache_dirs() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (before torch is imported): the port builds its library into
    neutral_tpu_torch/build/ itself."""
    base = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


# -- the check ----------------------------------------------------------------

def judge(cell: dict, rec: Record, seed: int, device: str,
          config_override: dict | None = None) -> tuple[bool, dict, dict]:
    """The compared solve of `rec` against the plain reference, on
    `device`; returns (correct, the numbers beside their limits, the
    numbers)."""
    import torch
    from . import check as chk
    from .reference import engine
    config = {**cell["config"], **(config_override or {})}
    traffic = cell["traffic"]
    deck = engine.Deck.from_dict(config)
    limits = chk.load_limits(cell["name"])
    pids = chk.sample(seed, deck.nparticles, limits["sample"])
    keys = [chk.master_key(seed, rec.kept["replica"], s)
            for s in range(1, deck.iterations + 1)]
    ref = engine.solve(deck, torch.as_tensor(pids, device=device), keys,
                       grid="tally_gap" in limits)
    numbers = chk.compare(rec.kept, ref, nparticles=deck.nparticles,
                          dtype=traffic["dtype"],
                          tally_dtype=traffic["tally_dtype"],
                          extent=max(deck.width, deck.height))
    ok, shown = chk.verdict(numbers, limits)
    return ok, shown, numbers


# -- metrics ------------------------------------------------------------------

def load_reader(name: str):
    """metrics/<name>.py's `read`."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics(cell: dict, rec: Record, trace: bool) -> dict:
    """The cell's metrics that the window's records give."""
    out = {}
    ctx = Context(cell, rec)
    for m in cell["per_layer" if trace else "end_to_end"]:
        v = load_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


class Context:
    """What a metric reader reads: the cell and the run's record."""

    def __init__(self, cell: dict, rec: Record):
        self.cell, self.record = cell, rec
        self.config, self.traffic = cell["config"], cell["traffic"]

    @property
    def solves(self) -> list:
        return self.record.solves

    def phase_ms(self, key: str) -> float | None:
        """A program phase's milliseconds a solve, summed over its
        censuses, meaned over the solves; None where no census has it."""
        vals = [sum(st["phases"][key] for st in s["steps"]
                    if key in st["phases"]) for s in self.solves
                if any(key in st["phases"] for st in s["steps"])]
        return 1e3 * sum(vals) / len(vals) if vals else None

    def cards(self) -> list:
        """Every traced card's summary, with its window's length."""
        if not self.record.trace:
            return []
        return [{**c, "window_s": self.record.trace["window_s"]}
                for c in self.record.trace["cards"].values()]

    def least_census_s(self) -> float:
        """Least seconds of the window's censuses on the card
        (roofline.solve_seconds)."""
        from .roofline import solve_seconds
        c, t = self.config, self.traffic
        return sum(solve_seconds(
            [(st["live"], st["facets"], st["collisions"])
             for st in s["steps"]], c["nparticles"], c["nx"] * c["ny"],
            t["dtype"], t["tally_dtype"], c.get("rng", "threefry"))
            for s in self.solves)


# -- the command -------------------------------------------------------------

def power_limits() -> list:
    """Each card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             config_override: dict | None = None, out=None) -> dict:
    """A whole run of `cell` on `device`: the window, the check and the
    result's line.  Returns the result."""
    out = out or sys.stdout
    rec = run_window(cell, seed, seconds, trace, device=device,
                     t_start=t_start, config_override=config_override)
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ok, shown, numbers = judge(cell, rec, seed, device, config_override)
    check_s = time.perf_counter() - t_check
    result = {"correct": ok, "attempted": len(rec.solves),
              "failed": 0 if ok else 1,
              "metrics": metrics(cell, rec, trace),
              "device": device_info(cell, rec, trace, device)}
    if trace:
        result["breakdown"] = breakdown(rec)
    solves = [s["solve_s"] for s in rec.solves]
    events = sum(st["facets"] + st["collisions"]
                 for s in rec.solves for st in s["steps"])
    record = {"cell": cell["name"], "seed": seed, "trace": trace,
              "solves": len(solves), "window_s": rec.window_s,
              "setup_s": rec.setup_s, "setup_parts": rec.setup_parts,
              "events_per_s": events / rec.window_s,
              "solve_s_quartiles": statistics.quantiles(solves, n=4)
              if len(solves) > 1 else solves,
              "solve_s_max": max(solves),
              "setup_ms_median": statistics.median(
                  s["setup_ms"] for s in rec.solves),
              "tally_ms_quartiles": statistics.quantiles(
                  [s["tally_ms"] for s in rec.solves], n=4)
              if len(solves) > 1 else [rec.solves[0]["tally_ms"]],
              "transport": rec.solves[0]["transport"],
              "engine": rec.solves[0]["engine"],
              "memory_peak_bytes": rec.memory_peak_bytes,
              "compared_replica": rec.kept["replica"],
              "idle_by_card": [1.0 - c["busy_s"] / c["window_s"]
                               for c in Context(cell, rec).cards()],
              "check_s": check_s, "check_detail": numbers["detail"],
              "cards": power_limits() if device != "cpu" else []}
    result["check"] = shown
    # the reference and the readers ran after the window: look again
    refuse_forbidden("before the result")
    print(json.dumps(record), file=out)
    print(json.dumps(result), file=out, flush=True)
    for name, v in shown.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    return result


def device_info(cell: dict, rec: Record, trace: bool, device: str) -> dict:
    import torch
    info = {"platform": "gpu" if device != "cpu" else "cpu",
            "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                     else "cpu"),
            "count": cell["chips"],
            "memory_peak_bytes": rec.memory_peak_bytes}
    if trace:
        cards = Context(cell, rec).cards()
        info["busy_s"] = (sum(c["busy_s"] for c in cards) / len(cards)
                          if cards else 0.0)
        info["window_s"] = rec.trace["window_s"]
    return info


def breakdown(rec: Record) -> dict:
    """The device operations that took most time and the idle seconds by
    the benchmark span open, meaned over the traced cards."""
    from .trace import top
    ops, idle, n = {}, {}, 0
    for c in (rec.trace or {}).get("cards", {}).values():
        n += 1
        for k, v in c["ops"].items():
            ops[k] = ops.get(k, 0.0) + v
        for k, v in c["idle"].items():
            idle[k] = idle.get(k, 0.0) + v
    n = max(n, 1)
    return {"device_ops": top({k: v / n for k, v in ops.items()}),
            "idle_gaps": top({k: v / n for k, v in idle.items()})}
