"""Builds the port's CUDA kernels (csrc/*.cu) into one shared library.

nvcc compiles the sources at first use into a library with a plain C
interface, which sweep_kernel.py loads with ctypes; no PyTorch header is
compiled, so a build takes seconds.  The library goes to
`neutral_tpu_torch/build/` under a name that carries a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is not.
The build raises with nvcc's output if it fails.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# -fmad=false: PyTorch's elementwise arithmetic never fuses a*b+c, so the
# kernel must not either, or its branch decisions drift from the plain
# version's (csrc/sweep.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


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
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources() if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    output = proc.stdout + proc.stderr
    log.write_text(output)
    os.replace(tmp, lib)
    return lib, output
