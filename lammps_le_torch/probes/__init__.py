"""The arithmetic microprobes of the TPU engine's benchmarks, ported:
``probe_rcp`` (benchmarks/probe_rcp.py: approximate vs IEEE reciprocal)
and ``probe_bf16`` (benchmarks/probe_bf16.py: packed bf16 vs f32
elementwise rate).  Their kernels are ``csrc/probes.cu``; each module's
functions run the kernels on CUDA tensors and their plain PyTorch
versions on CPU tensors.  ``LAUNCHES`` counts, per kernel, the calls
that launched it (``rcp_one`` is ``rcp``'s first form, one element a
thread, whose exact kernel prices the IEEE reciprocal; ``empty`` the
launch-floor kernel).

    python -m lammps_le_torch.probes.probe_rcp
    python -m lammps_le_torch.probes.probe_bf16
"""

from __future__ import annotations

import ctypes
import functools
import re
import subprocess
from pathlib import Path

import torch

from ..fast.kernels import _raise, _stream

LAUNCHES = {"rcp_chain": 0, "rcp": 0, "elementwise_chain": 0, "rcp_one": 0,
            "empty": 0}

_LIB = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long


def lib():
    """The built ``csrc/probes.cu`` library, argtypes set (the first call
    builds every source)."""
    global _LIB
    if _LIB is None:
        from ..csrc.build import build

        probes = ctypes.CDLL(str(build()["probes"]))
        probes.lle_rcp_chain.argtypes = [_P, _P, _L, _I, _I, _P]
        probes.lle_rcp.argtypes = [_P, _P, _L, _I, _P]
        probes.lle_rcp_one.argtypes = [_P, _P, _L, _I, _P]
        probes.lle_rcp_floor.argtypes = [_L, _P]
        probes.lle_chain_f32.argtypes = [_P, _P, _L, _I, _P]
        probes.lle_chain_bf16x2.argtypes = [_P, _P, _L, _I, _P]
        for fn in ("lle_rcp_chain", "lle_rcp", "lle_rcp_one",
                   "lle_rcp_floor", "lle_chain_f32", "lle_chain_bf16x2"):
            getattr(probes, fn).restype = _I
        _LIB = probes
    return _LIB


def launch(name, fn, *args):
    """Call the C entry point ``fn`` on PyTorch's current stream; raise if
    the launch is refused, else count it under ``name``."""
    _raise(name, fn(*args, _stream()))
    LAUNCHES[name] += 1


def device_ms(fn, calls: int = 10) -> float:
    """Device ms a call of ``fn``, from CUDA events around ``calls`` calls
    queued behind a sleep kernel after one warm-up call: the host issues
    them all before the first runs, so its time between calls is not
    counted."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~10 ms at <= 2 GHz
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


@functools.lru_cache(maxsize=1)
def sass() -> str:
    """The built library's SASS, as ``cuobjdump -sass`` lists it."""
    from ..csrc.build import build, nvcc

    tool = Path(nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(build()["probes"])],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


_SASS = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")


def listing(text: str, function: str):
    """The instructions of the first function whose mangled name matches
    ``function`` in the SASS ``text``: ([(address, predicated, opcode,
    operands)] in address order)."""
    blocks = re.split(r"\n\s*Function : ", text)
    body = next((b for b in blocks[1:] if re.match(function, b)), None)
    if body is None:
        raise RuntimeError(f"no function matching {function!r} in the SASS")
    return [(int(m.group(1), 16), m.group(2) is not None, m.group(3),
             m.group(4).strip())
            for m in map(_SASS.match, body.splitlines()) if m]


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
