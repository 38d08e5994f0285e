"""Parameter-file parser (a copy of `neutral_tpu/params.py`).

Reads the same two-level text grammar as the reference application so its
shipped problem decks work unmodified (reference grammar: key/value lines with
`#` comments, plus multi-pair entries `name k0=v0 k1=v1 ...` used by `source`
and `problem_N` — see the reference's problems/csp.params and the arch
harness's params.h call sites at its neutral_data.c:24-43):

    nparticles        1000000  # trailing comments allowed
    source xpos=0.1 ypos=0.1 width=0.2 height=0.2
    problem_0 density=1.0e-30 energy=0.0 xpos=0.0 ypos=0.0 width=1.0 height=1.0

The harness-level deck (the reference's `../arch.params`, which supplies
width / height / sim_end) is replaced by an optional `arch` section: those
keys may appear directly in the problem deck or in a sibling `arch.params`
file; built-in defaults (width=1.0, height=1.0, sim_end=1.0) reproduce the
geometry under which the reference goldens were generated (verified
analytically against the `stream` and `csp` goldens).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field


@dataclass
class ParamFile:
    """Parsed parameter deck: scalar entries and multi-pair key-value entries."""

    scalars: dict[str, str] = field(default_factory=dict)
    # name -> list of (key, value) preserving order; repeated names (e.g.
    # problem_0, problem_1) are distinct names so no collision occurs.
    keyvalues: dict[str, list[tuple[str, float]]] = field(default_factory=dict)
    path: str = ""

    # -- scalar accessors ----------------------------------------------------
    def get_int(self, name: str, default: int | None = None) -> int:
        if name not in self.scalars:
            if default is None:
                raise KeyError(f"parameter '{name}' not found in {self.path}")
            return default
        return int(float(self.scalars[name]))

    def get_double(self, name: str, default: float | None = None) -> float:
        if name not in self.scalars:
            if default is None:
                raise KeyError(f"parameter '{name}' not found in {self.path}")
            return default
        return float(self.scalars[name])

    def get_string(self, name: str, default: str | None = None) -> str:
        if name not in self.scalars:
            if default is None:
                raise KeyError(f"parameter '{name}' not found in {self.path}")
            return default
        return self.scalars[name]

    def get_key_value(self, name: str) -> list[tuple[str, float]] | None:
        return self.keyvalues.get(name)

    def problem_entries(self) -> list[list[tuple[str, float]]]:
        """All `problem_N` entries, in N order."""
        out = []
        n = 0
        while f"problem_{n}" in self.keyvalues:
            out.append(self.keyvalues[f"problem_{n}"])
            n += 1
        return out


_KV_RE = re.compile(r"^(\S+)=(\S+)$")


def parse_params(path: str) -> ParamFile:
    """Parse a parameter deck file."""
    pf = ParamFile(path=path)
    with open(path, "r") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            tokens = line.split()
            name = tokens[0]
            rest = tokens[1:]
            if rest and all(_KV_RE.match(t) for t in rest):
                pairs = []
                for t in rest:
                    m = _KV_RE.match(t)
                    pairs.append((m.group(1), float(m.group(2))))
                pf.keyvalues[name] = pairs
            elif len(rest) >= 1:
                pf.scalars[name] = rest[0]
            # bare names with no value are ignored
    return pf


def find_arch_params(problem_path: str) -> ParamFile | None:
    """Locate the harness-level deck next to the problem deck, if present.

    Mirrors the reference's ARCH_ROOT_PARAMS lookup (it resolved
    `../arch.params` relative to the binary); we look for `arch.params` in
    the problem deck's directory and its parent.
    """
    d = os.path.dirname(os.path.abspath(problem_path))
    for cand in (os.path.join(d, "arch.params"),
                 os.path.join(os.path.dirname(d), "arch.params")):
        if os.path.isfile(cand):
            return parse_params(cand)
    return None
