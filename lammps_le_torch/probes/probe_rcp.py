"""Microprobe P1 on the card: the approximate reciprocal (PTX
``rcp.approx.ftz.f32``, one MUFU instruction) against the IEEE one
(``1.0f / x``, the stencils' division) in a division-bound chain, and the
approximate one's largest relative error over the stencils' two divisor
domains (rsq_den in [0.5625, 2.6], rlog in [0.1, 1]).  The counterpart of
``benchmarks/probe_rcp.py``; the kernels are ``csrc/probes.cu``.

    python -m lammps_le_torch.probes.probe_rcp

prints the two chain times, the speedup and the two errors, as the TPU
probe does, on the first CUDA device.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..fast.kernels import _check, _on_cpu, _ptr
from . import device_ms, launch, lib, listing, sass

P = 27008   # the TPU probe's shape: (ROWS, P) f32, REPS steps
ROWS = 8
REPS = 2000
DOMAINS = ((0.5625, 2.6, "rsq_den domain"), (0.1, 1.0, "rlog domain"))


def rcp_chain_ref(x, reps: int):
    """The chain's plain version: acc <- 0, then ``reps`` times acc +=
    (1 / (x + acc)) * 1e-7, in x's type (probe_rcp.py:24-36).  The
    approximate reciprocal has no PyTorch counterpart: this is the exact
    chain."""
    acc = torch.zeros_like(x)
    for _ in range(reps):
        acc = acc + (1.0 / (x + acc)) * 1e-7
    return acc


def rcp_chain(x, approx: bool, reps: int = REPS):
    """The chain of ``reps`` steps on f32 ``x``; the approximate or IEEE
    reciprocal on a CUDA tensor, the plain (exact) chain on a CPU one."""
    if _on_cpu(x):
        return rcp_chain_ref(x, reps)
    _check("x", x, torch.float32)
    out = torch.empty_like(x)
    launch("rcp_chain", lib().lle_rcp_chain, _ptr(x), _ptr(out), x.numel(),
           reps, int(approx))
    return out


def reciprocal(x, approx: bool = True):
    """1/x in one pass: ``rcp.approx.ftz.f32`` (approx) or IEEE-rounded on
    a CUDA tensor; on a CPU tensor the plain ``1.0 / x``."""
    if _on_cpu(x):
        return 1.0 / x
    _check("x", x, torch.float32)
    out = torch.empty_like(x)
    launch("rcp", lib().lle_rcp, _ptr(x), _ptr(out), x.numel(), int(approx))
    return out


def domain(lo: float, hi: float, device="cuda"):
    """The probe's inputs: linspace(lo, hi) over (ROWS, P), rounded to f32
    (probe_rcp.py:66)."""
    xs = np.linspace(lo, hi, ROWS * P).astype(np.float32).reshape(ROWS, P)
    return torch.as_tensor(xs, device=device)


def precision(lo: float, hi: float, approx: bool = True, device="cuda"):
    """(x, 1/x, largest relative error against 1/x in f64) over
    ``domain(lo, hi)`` (probe_rcp.py:59-70)."""
    x = domain(lo, hi, device)
    r = reciprocal(x, approx)
    want = 1.0 / x.double()
    return x, r, float(((r.double() - want).abs() / want.abs()).max())


def time_chain(approx: bool, reps: int = REPS, calls: int = 10):
    """Device ms of one chain over the probe's (ROWS, P) inputs (uniform
    in [0.5, 2.6], probe_rcp.py:44), over ``calls`` calls (``device_ms``)."""
    x = torch.as_tensor(np.random.RandomState(0).uniform(
        0.5, 2.6, (ROWS, P)).astype(np.float32), device="cuda")
    return device_ms(lambda: rcp_chain(x, approx, reps), calls)


def fast_path(text: str, function: str):
    """The opcodes an instance of ``function`` issues on its fast path in
    the SASS ``text``: from its first instruction to the first
    unconditional EXIT, predicated exits not taken, unconditional branches
    taken, and a predicated branch taken where its fall-through calls a
    subroutine (the slow path of an IEEE division) before the next
    unconditional branch or exit."""
    code = listing(text, function)
    index = {addr: k for k, (addr, *_) in enumerate(code)}

    def target(k):
        _, _, op, args = code[k]
        t = re.search(r"0x([0-9a-f]+)", args)
        if t is None or int(t.group(1), 16) not in index:
            raise RuntimeError(f"{function}: branch target of '{op} {args}' "
                               f"not in the listing")
        return index[int(t.group(1), 16)]

    def calls_before_join(k):
        for _, pred, op, _ in code[k:]:
            if op.startswith("CALL"):
                return True
            if not pred and op.startswith(("BRA", "EXIT")):
                return False
        return False

    path, k = [], 0
    while k < len(code):
        _, pred, op, _ = code[k]
        path.append(op)
        if len(path) > 10000:
            raise RuntimeError(f"{function}: no exit on the fast path")
        if op.startswith("EXIT") and not pred:
            return path
        if op.startswith("BRA") and (not pred or calls_before_join(k + 1)):
            k = target(k)
            continue
        k += 1
    raise RuntimeError(f"{function}: the listing ends before an EXIT")


def rcp_price(text: str = None):
    """What the IEEE reciprocal issues a call, from the SASS ``text``
    (default: the built library's): the fast-path instructions of the
    one-pass exact kernel less those of the approximate one, plus the
    approximate one's single MUFU.  Returns (price, exact opcodes,
    approximate opcodes)."""
    text = text or sass()
    exact = fast_path(text, r"\S*10rcp_kernelILb0E")
    approx = fast_path(text, r"\S*10rcp_kernelILb1E")
    if approx.count("MUFU.RCP") != 1:
        raise RuntimeError(f"the approximate reciprocal's fast path is "
                           f"{approx}, not one MUFU.RCP")
    return len(exact) - len(approx) + 1, exact, approx


def main():
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    de = time_chain(False)
    print(f"exact  rcp chain: {de:8.3f} ms ({de / REPS * 1e6:6.2f} "
          f"ns/iter)", flush=True)
    da = time_chain(True)
    print(f"approx rcp chain: {da:8.3f} ms ({da / REPS * 1e6:6.2f} "
          f"ns/iter)", flush=True)
    print(f"speedup {de / da:.2f}x", flush=True)
    for lo, hi, label in DOMAINS:
        err = precision(lo, hi)[2]
        print(f"approx rcp over [{lo}, {hi}] ({label}): max rel err "
              f"{err:.3e}", flush=True)


if __name__ == "__main__":
    main()
