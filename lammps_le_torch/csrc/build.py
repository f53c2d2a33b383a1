"""Build the Hopper kernels of ``step.cu`` into a shared library with a
plain C interface, at first use (``fast/kernels.py`` loads it with
ctypes).

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o lammps_le_torch/build/libstep-<hash>.so
         lammps_le_torch/csrc/step.cu

The library name carries a hash of the source, so an edited source is
rebuilt.  ``-fmad=false`` keeps every multiply and add separately
rounded, as in the plain PyTorch versions; division and sqrt stay IEEE
(no ``--use_fast_math``).  Run ``python -m lammps_le_torch.csrc.build`` to
build ahead of time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent
SOURCE = CSRC / "step.cu"
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


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libstep-{digest[:12]}.so"


def build(verbose: bool = False) -> Path:
    """Compile step.cu unless a library of the current source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr, end="", flush=True)
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build(verbose=True))
