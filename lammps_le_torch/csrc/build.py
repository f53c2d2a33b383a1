"""Build the Hopper kernels into shared libraries with a plain C interface,
at first use (``fast/kernels.py`` loads them with ctypes).  Each source is
its own library, and the nvcc runs of all sources start together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o lammps_le_torch/build/lib<src>-<hash>.so
         lammps_le_torch/csrc/<src>.cu

``step.cu`` holds the four kernels of the 100k path, ``blocked.cu`` the
Newton-half stencil past the whole-plane gate and the sharded stencil's
window kernel (both include ``stencil.cuh``, the pair stencil they share
with ``step.cu``), ``tiled.cu`` the tiled full stencil (each includes
``common.cuh``), ``probes.cu`` the reciprocal and elementwise-chain
microprobes (``lammps_le_torch/probes``).  A library's name carries a
hash of its source, the headers and the flags, so an edited source is
rebuilt.  ``-fmad=false`` keeps every multiply and add separately
rounded, as in the plain PyTorch versions; division and sqrt stay IEEE
(no ``--use_fast_math``), but for the stencils' reciprocal, which is
approximate by default and chosen at each launch (``kernels.APPROX_RCP``,
both forms built).  Run
``python -m lammps_le_torch.csrc.build`` to build ahead of time with
ptxas's register report.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent
SOURCES = {"step": CSRC / "step.cu", "blocked": CSRC / "blocked.cu",
           "tiled": CSRC / "tiled.cu", "probes": CSRC / "probes.cu"}
HEADERS = (CSRC / "common.cuh", CSRC / "stencil.cuh")
BUILD_DIR = CSRC.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of lammps_le_torch "
                       "are built with the CUDA toolkit's nvcc")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        SOURCES[name].read_bytes()
        + b"".join(h.read_bytes() for h in HEADERS)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(verbose: bool = False) -> dict:
    """Compile every source without a library of its current text, all
    at once.  Returns {name: library path}."""
    out = {name: library_path(name) for name in SOURCES}
    todo = [name for name, path in out.items() if not path.exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = out[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else [])
        cmd += ["-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {SOURCES[name].name} failed "
                          f"({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(err, end="", flush=True)
        os.replace(tmp, out[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


if __name__ == "__main__":
    for path in build(verbose=True).values():
        print(path)
