"""Compile-on-demand loader for the native fastio library
(``lammps_le_tpu/native/build.py``).

Builds ``libfastio-<hash>.so`` from ``fastio.cc`` into the package's
``build/`` directory (gitignored, beside the CUDA libraries) with the
system's C++ compiler at first use; the name carries a hash of the
source, so an edited source is rebuilt.  Returns None when no compiler is
found, and the numpy parser of ``io.data.read_data`` takes over: it gives
the same arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastio.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")

_cached = "unset"


def _lib_path() -> str:
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libfastio-{tag}.so")


def _compile(lib: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build beside the target and rename, so a concurrent loader never
    # opens a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        for cc in ("g++", "c++", "clang++"):
            try:
                r = subprocess.run(
                    [cc, "-O2", "-shared", "-fPIC", _SRC, "-o", tmp],
                    capture_output=True, timeout=120,
                )
            except (OSError, subprocess.TimeoutExpired):
                continue
            if r.returncode == 0:
                os.replace(tmp, lib)
                return True
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_fastio():
    """ctypes handle to libfastio, or None."""
    global _cached
    if _cached != "unset":
        return _cached
    try:
        lib_path = _lib_path()
        if not os.path.exists(lib_path) and not _compile(lib_path):
            _cached = None
            return None
        lib = ctypes.CDLL(lib_path)
        lib.lle_parse_section.restype = ctypes.c_long
        lib.lle_parse_section.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.lle_format_xyz.restype = ctypes.c_long
        lib.lle_format_xyz.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ]
        _cached = lib
    except OSError:
        _cached = None
    return _cached


def parse_rows(lib, text: str, rows: int, cols: int):
    """Parse `rows` data lines of up to `cols` columns into (rows, cols)."""
    import numpy as np

    out = np.zeros((rows, cols), np.float64)
    buf = text.encode()
    n = lib.lle_parse_section(
        buf, len(buf), rows, cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if n != rows:
        raise ValueError(f"native parser consumed {n} of {rows} rows")
    return out
