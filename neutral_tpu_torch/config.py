"""Simulation configuration.

Gathers everything the driver and the transport step need into one
immutable dataclass, decoupled from the params-file grammar (params.py) so
configs can also be constructed programmatically (tests, sweeps).  Same
grammar and defaults as `neutral_tpu.config`; the port keeps its own copy
because importing anything under `neutral_tpu` imports JAX.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

from . import params as params_mod


@dataclass(frozen=True)
class SourceBox:
    """Particle source region, in fractions of the domain extent."""
    xpos: float
    ypos: float
    width: float
    height: float


@dataclass(frozen=True)
class ProblemRegion:
    """A rectangular density region (later regions overwrite earlier ones)."""
    density: float
    xpos: float
    ypos: float
    width: float
    height: float


@dataclass(frozen=True)
class SimConfig:
    # Mesh
    nx: int
    ny: int
    width: float = 1.0
    height: float = 1.0

    # Time stepping
    dt: float = 1.0e-7
    niters: int = 1
    sim_end: float = 1.0

    # Particles
    nparticles: int = 1000
    initial_energy: float = 1.0e3

    source: SourceBox = SourceBox(0.0, 0.0, 1.0, 1.0)
    problems: tuple[ProblemRegion, ...] = ()
    # Deck grammar beyond the reference (a (ny, nx) density grid, and
    # non-uniform edges from files or a geometric stretch).  Parsed here
    # exactly as in neutral_tpu.  Non-uniform decks run the plain engine's
    # edge-array sweep, as they run JAX's XLA sweep.
    density_file: str = ""
    edgex_file: str = ""
    edgey_file: str = ""
    mesh_stretch_x: float = 1.0
    mesh_stretch_y: float = 1.0

    # Numerics
    dtype: str = "float32"          # particle/compute dtype
    tally_dtype: str = "float32"    # energy-deposition tally dtype
    fast_math: bool = True          # analytic xs/density/edge evaluation
    rng: str = "threefry"           # threefry | pcg64si (stream scheme)

    # IO / misc
    visit_dump: bool = False
    expected_tally: float | None = None   # golden value for validation
    params_path: str = ""

    def with_(self, **kw) -> "SimConfig":
        return replace(self, **kw)

    @property
    def uses_density_grid(self) -> bool:
        """Material density comes from a (ny, nx) grid, not analytic regions:
        grid decks (density_file) and the fast_math 0 verification mode,
        whose transport gathers each cell's density."""
        return bool(self.density_file) or not self.fast_math

    @property
    def uniform_mesh(self) -> bool:
        """True when cell edges are uniformly spaced (edge[i] = i*pitch)."""
        return (not self.edgex_file and not self.edgey_file
                and self.mesh_stretch_x == 1.0
                and self.mesh_stretch_y == 1.0)


def load_config(problem_path: str) -> SimConfig:
    """Build a SimConfig from a reference-format problem deck.

    Reads the app-level deck, then overlays harness-level keys
    (width/height/sim_end) from a sibling arch.params if one exists, else
    from the deck itself, else defaults (1.0/1.0/1.0 — the geometry the
    reference goldens were generated under).
    """
    pf = params_mod.parse_params(problem_path)
    arch = params_mod.find_arch_params(problem_path)

    def harness(name: str, default: float) -> float:
        if name in pf.scalars:
            return pf.get_double(name)
        if arch is not None and name in arch.scalars:
            return arch.get_double(name)
        return default

    rng_scheme = pf.get_string("rng", "threefry")
    src_entry = pf.get_key_value("source")
    if src_entry is None:
        raise ValueError(f"{problem_path}: no 'source' entry")
    src = dict(src_entry)
    source = SourceBox(src["xpos"], src["ypos"], src["width"], src["height"])

    problems = []
    for entry in pf.problem_entries():
        d = dict(entry)
        problems.append(ProblemRegion(
            density=d["density"], xpos=d["xpos"], ypos=d["ypos"],
            width=d["width"], height=d["height"]))

    expected = _find_expected_tally(problem_path, rng=rng_scheme)

    def deck_path(key: str) -> str:
        p = pf.get_string(key, "")
        if p and not os.path.isabs(p):
            p = os.path.join(
                os.path.dirname(os.path.abspath(problem_path)), p)
        return p

    return SimConfig(
        density_file=deck_path("density_file"),
        edgex_file=deck_path("edgex_file"),
        edgey_file=deck_path("edgey_file"),
        mesh_stretch_x=pf.get_double("mesh_stretch_x", 1.0),
        mesh_stretch_y=pf.get_double("mesh_stretch_y", 1.0),
        nx=pf.get_int("nx"),
        ny=pf.get_int("ny"),
        width=harness("width", 1.0),
        height=harness("height", 1.0),
        dt=pf.get_double("dt"),
        niters=pf.get_int("iterations"),
        sim_end=harness("sim_end", 1.0),
        nparticles=pf.get_int("nparticles"),
        initial_energy=pf.get_double("initial_energy"),
        source=source,
        problems=tuple(problems),
        visit_dump=bool(pf.get_int("visit_dump", 0)),
        # A deck key of the port's alone: neutral_tpu sets fast_math only
        # from code (SimConfig(fast_math=False)).
        fast_math=bool(pf.get_int("fast_math", 1)),
        rng=rng_scheme,
        expected_tally=expected,
        params_path=problem_path,
    )


def _find_expected_tally(problem_path: str,
                         rng: str = "threefry") -> float | None:
    """Look up the golden tally for this deck in a `neutral.tests` file.

    Same contract as the reference (omp3/neutral.c:541-545): a file of
    `<deck-path> result=<value>` lines at problems/neutral.tests relative
    to the working directory, or next to the deck.  A pcg64si deck looks
    in `neutral_pcg.tests` first, then falls back to the threefry file.
    """
    names = (["neutral_pcg.tests", "neutral.tests"]
             if rng == "pcg64si" else ["neutral.tests"])
    deck_dir = os.path.dirname(os.path.abspath(problem_path))
    cands = [os.path.join(d, n) for n in names
             for d in (deck_dir, "problems")]
    base = os.path.basename(problem_path)
    for cand in cands:
        if not os.path.isfile(cand):
            continue
        with open(cand) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if os.path.basename(parts[0]) != base:
                    continue
                for tok in parts[1:]:
                    if tok.startswith("result="):
                        return float(tok.split("=", 1)[1])
    return None
