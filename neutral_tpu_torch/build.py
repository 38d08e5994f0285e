"""Builds the port's CUDA kernels (csrc/*.cu) into one shared library.

nvcc compiles the sources at first use, one process per `.cu` file, all
started together, and links the objects into a library with a plain C
interface, which the kernel wrappers load with ctypes (`load()`); no
PyTorch header is compiled, so a build takes seconds.  The library goes to
`neutral_tpu_torch/build/` under a name that carries a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is not.
The build raises with nvcc's output if it fails.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# -fmad=false: PyTorch's elementwise arithmetic never fuses a*b+c, so the
# kernels must not either, or their branch decisions drift from the plain
# versions' (csrc/common.cuh).
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")


def sources() -> list[Path]:
    """The kernel sources, in a fixed order."""
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def nvcc_path() -> str:
    """nvcc from the CUDA toolkit PyTorch finds (CUDA_HOME), or on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libneutral_kernels_{h.hexdigest()[:16]}.so"


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> str:
    """Wait for every process; raise with its output if one failed."""
    outputs = []
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        outputs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed with exit code {rc}:\n"
                           f"{' '.join(cmd)}\n{out}")
    return "".join(outputs)


def _start(cmd: list[str]) -> tuple[list[str], subprocess.Popen]:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def build() -> tuple[Path, str]:
    """Compile the library unless it is up to date.

    Returns (path, compiler output); the output holds ptxas's register and
    spill report for each kernel.
    """
    lib = library_path()
    log = lib.with_suffix(".log")
    if lib.is_file():
        return lib, log.read_text() if log.is_file() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = []
    procs = []
    for src in sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(_start([nvcc, *NVCC_FLAGS, "-c", str(src),
                             "-o", str(obj)]))
    output = _run(procs)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    output += _run([_start([nvcc, *GENCODE, "-shared", "-o", str(tmp),
                            *(str(o) for o in objs)])])
    for obj in objs:
        obj.unlink()
    log.write_text(output)
    os.replace(tmp, lib)
    return lib, output


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.nt_error_string.argtypes = [ctypes.c_int]
    lib.nt_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.nt_error_string(err).decode()}")
