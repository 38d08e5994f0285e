"""The native engine: a history-based C++/OpenMP engine on the host.

Port of `neutral_tpu/native/__init__.py`, with its own copy of
`neutral_native.cpp` (neutral_tpu's code, line for line; one comment cites
the reference by name instead of by a mount path): the same physics and draw streams as the event-based
engines, one history at a time per OpenMP thread to census, float64
throughout.  It is an independent reference (`tools compare`, `tools
gen-golden`, `--backend native`), never a fallback: nothing on the card
path calls it.

The library is built at first use with g++ (neutral_tpu/native/Makefile's
flags) into `neutral_tpu_torch/build/`, under a name that carries a hash
of the source, the flags and the CPU that `-march=native` resolves to, so
an edited source or another machine's build is never loaded.  A compile
error raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "neutral_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-fopenmp",
             "-Wall", "-Wextra")
_FLOAT_FIELDS = ("x", "y", "omega_x", "omega_y", "energy", "weight",
                 "dt_to_census", "mfp_to_collision")


class _Particles(ctypes.Structure):
    _fields_ = ([(f, ctypes.POINTER(ctypes.c_double)) for f in _FLOAT_FIELDS]
                + [(f, ctypes.POINTER(ctypes.c_int32))
                   for f in ("cellx", "celly", "dead")])


def _target() -> str:
    """The -march/-mtune that g++ resolves -march=native to here."""
    out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=True).stdout
    return " ".join(line.split()[-1] for line in out.splitlines()
                    if line.strip().startswith(("-march=", "-mtune=")))


def library_path() -> Path:
    """Where the library of the current source, flags and CPU lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_target().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libneutral_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is up to date; returns its path."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-shared", str(SOURCE), "-o",
                           str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native engine build failed (g++ exit code "
                           f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, lib)
    return lib


_I, _I64, _U64, _D = (ctypes.c_int, ctypes.c_int64, ctypes.c_uint64,
                      ctypes.c_double)
_DP, _UP = ctypes.POINTER(_D), ctypes.POINTER(_U64)
# (restype, argtypes) of each entry point of neutral_native.cpp
_SIGNATURES = {
    "nt_num_threads": (_I, []),
    "nt_threefry2x64": (None, [_U64, _U64, _U64, _U64, _UP, _UP]),
    "nt_draw2": (None, [_U64, _U64, _U64, _DP, _DP]),
    "nt_pcg64si_first": (_U64, [_U64]),
    "nt_inject": (None, [_I64, _DP, _DP, _I, _I, _D, _D, _D, _D, _D, _D,
                         ctypes.POINTER(_Particles), _I]),
    "nt_timestep": (None, [_I64, ctypes.POINTER(_Particles), _DP, _DP, _DP,
                           _I, _I, _DP, _DP, _I, _DP, _DP, _I, _D, _U64,
                           _I64, _DP, _UP, _UP, _UP, _I]),
}


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def threefry2x64(c0: int, c1: int, k0: int, k1: int) -> tuple[int, int]:
    o0, o1 = ctypes.c_uint64(), ctypes.c_uint64()
    load().nt_threefry2x64(c0, c1, k0, k1, ctypes.byref(o0),
                           ctypes.byref(o1))
    return o0.value, o1.value


def pcg64si_first(seed: int) -> int:
    """First output of a freshly seeded PCG64si stream."""
    return load().nt_pcg64si_first(seed)


def draw2(pid: int, master_key: int, counter: int) -> tuple[float, float]:
    r0, r1 = ctypes.c_double(), ctypes.c_double()
    load().nt_draw2(pid, master_key, counter, ctypes.byref(r0),
                    ctypes.byref(r1))
    return r0.value, r1.value


def _ptr(a: np.ndarray, ctype=ctypes.c_double):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeState:
    """Host-side SoA particle arrays (float64) for the native engine."""

    def __init__(self, n: int):
        self.n = n
        for name in _FLOAT_FIELDS:
            setattr(self, name, np.zeros(n, np.float64))
        for name in ("cellx", "celly", "dead"):
            setattr(self, name, np.zeros(n, np.int32))

    def struct(self) -> _Particles:
        return _Particles(
            *(_ptr(getattr(self, f)) for f in _FLOAT_FIELDS),
            *(_ptr(getattr(self, f), ctypes.c_int32)
              for f in ("cellx", "celly", "dead")))


class NativeSimulation:
    """A whole run on the native engine, with the deck's inputs as the
    port's driver loads them: its edges (non-uniform too), density (regions
    or grid), user `.cs` tables (cwd, then the deck's directory) or the
    generated ones, and its draw scheme."""

    def __init__(self, cfg):
        from ..mesh import build_density, build_edges
        from ..xs import find_cs_files, make_resonance_table, read_cs_file

        self.cfg = cfg
        self._scheme = int(cfg.rng == "pcg64si")
        self.density = np.ascontiguousarray(build_density(cfg, np.float64))
        self.edgex, self.edgey = build_edges(cfg)
        paths = find_cs_files(cfg.params_path)
        if paths is not None:
            scatter, absorb = (read_cs_file(p) for p in paths)
        else:
            scatter = absorb = make_resonance_table()
        self.cs_keys, self.cs_vals, self.ca_keys, self.ca_vals = (
            np.ascontiguousarray(a, np.float64) for a in (*scatter, *absorb))
        self.tally = np.zeros(cfg.nx * cfg.ny, np.float64)
        self.state = NativeState(cfg.nparticles)
        load().nt_inject(
            cfg.nparticles, _ptr(self.edgex), _ptr(self.edgey), cfg.nx,
            cfg.ny, cfg.source.xpos * cfg.width,
            cfg.source.ypos * cfg.height, cfg.source.width * cfg.width,
            cfg.source.height * cfg.height, cfg.initial_energy, cfg.dt,
            ctypes.byref(self.state.struct()), self._scheme)

    def step(self, tt: int) -> tuple[int, int, int]:
        """One census timestep; returns (nfacets, ncollisions, nprocessed)."""
        cfg = self.cfg
        nf, nc, npr = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
        load().nt_timestep(
            self.state.n, ctypes.byref(self.state.struct()),
            _ptr(self.density), _ptr(self.edgex), _ptr(self.edgey), cfg.nx,
            cfg.ny, _ptr(self.cs_keys), _ptr(self.cs_vals), len(self.cs_keys),
            _ptr(self.ca_keys), _ptr(self.ca_vals), len(self.ca_keys),
            cfg.dt, tt, cfg.nparticles, _ptr(self.tally), ctypes.byref(nf),
            ctypes.byref(nc), ctypes.byref(npr), self._scheme)
        return nf.value, nc.value, npr.value

    def run(self) -> float:
        for tt in range(1, self.cfg.niters + 1):
            self.step(tt)
        return float(self.tally.sum())
