"""Microprobe P2 on the card: the rate of an f32 elementwise chain, and
whether packed bf16 (two values a 32-bit register, one instruction for
both) doubles it.  The counterpart of ``benchmarks/probe_bf16.py``; the
kernels are ``csrc/probes.cu``.

    python -m lammps_le_torch.probes.probe_bf16

prints, as the TPU probe does, the four runs (16 and 8 rows, f32 and
bf16) in T elem-op/s, counting 16 operations a step as the TPU probe
does (the chain has 17), and the two speedups, on the first CUDA device.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..fast.kernels import _on_cpu, _ptr
from . import device_ms, launch, lib, listing, sass

P = 27008   # the TPU probe's shape: (rows, P), REPS steps
REPS = 400
OPS = 16    # operations a step by the TPU probe's count (probe_bf16.py:26)
CHAIN_OPS = 17  # arithmetic operations a step as written (:36-45)
RUNS = ((16, torch.float32, "A f32 16-row"), (16, torch.bfloat16,
                                              "B bf16 16-row"),
        (8, torch.float32, "C f32 8-row"), (8, torch.bfloat16,
                                            "D bf16 8-row"))


def chain_ref(x, reps: int):
    """The chain's plain version in x's type, each constant rounded to
    that type first (probe_bf16.py:36-45); f32 out."""
    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device).to(
            x.dtype)

    up, dn, floor, k6, kf = (c(v) for v in (1.0001, 0.9999, 0.5625, 0.0001,
                                            1e-6))
    a = torch.zeros_like(x)
    for _ in range(reps):
        dx = x - a
        dy = x * up - a
        dz = x * dn - a
        rsq = dx * dx + dy * dy + dz * dz
        den = torch.maximum(rsq, floor)
        r6 = den * den * den
        ff = r6 * k6 - den
        a = a + ff * kf
    return a.to(torch.float32)


def chain(x, dtype, reps: int = REPS):
    """The chain of ``reps`` steps on ``x`` cast to ``dtype`` (float32 or
    bfloat16), f32 out: the kernel on a CUDA tensor (bf16 as packed
    pairs), the plain version on a CPU one."""
    x = x.to(dtype).contiguous()
    if _on_cpu(x):
        return chain_ref(x, reps)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if dtype == torch.float32:
        launch("elementwise_chain", lib().lle_chain_f32, _ptr(x), _ptr(out),
               x.numel(), reps)
    elif dtype == torch.bfloat16:
        if x.numel() % 2:
            raise ValueError(f"the packed bf16 chain takes element pairs, "
                             f"got {x.numel()} elements")
        launch("elementwise_chain", lib().lle_chain_bf16x2, _ptr(x),
               _ptr(out), x.numel(), reps)
    else:
        raise ValueError(f"the chain runs in float32 or bfloat16, not "
                         f"{dtype}")
    return out


_ARITH = ("FADD", "FMUL", "FFMA", "FMNMX", "HADD2", "HMUL2", "HFMA2",
          "HMNMX2")


def step_instructions(text: str = None):
    """{dtype: (arithmetic instructions, all instructions)} a step of the
    compiled chain's main loop, from the SASS ``text`` (default: the built
    library's): the body of the loop's back edge, over its steps (one max
    a step, so the max instructions count the steps the body unrolls)."""
    text = text or sass()
    out = {}
    for dtype, fn, mx in ((torch.float32, r"\S*16chain_f32_kernel",
                           "FMNMX"),
                          (torch.bfloat16, r"\S*19chain_bf16x2_kernel",
                           "HMNMX2")):
        code = listing(text, fn)
        loops = []
        for addr, _, op, args in code:
            t = re.search(r"0x([0-9a-f]+)", args)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                body = [c[2] for c in code if int(t.group(1), 16) <= c[0]
                        <= addr]
                steps = sum(o.startswith(mx) for o in body)
                if steps:
                    loops.append((steps, body))
        if not loops:
            raise RuntimeError(f"no loop with {mx} in {fn}")
        steps, body = max(loops, key=lambda lb: lb[0])
        arith = sum(o.startswith(_ARITH) for o in body)
        out[dtype] = (arith / steps, len(body) / steps)
    return out


def inputs(rows: int, device="cuda"):
    """The probe's inputs: uniform in [1, 2) over (rows, P), seed 0
    (probe_bf16.py:57-58), as f32."""
    return torch.as_tensor(np.random.RandomState(0).uniform(
        1.0, 2.0, (rows, P)).astype(np.float32), device=device)


def run(rows: int, dtype, label: str, reps: int = REPS, calls: int = 10):
    """Device ms of one chain over ``calls`` calls (``device_ms``), printed
    with its rate in T elem-op/s."""
    x = inputs(rows).to(dtype)
    ms = device_ms(lambda: chain(x, dtype, reps), calls)
    rate = OPS * rows * P * reps / (ms * 1e-3) / 1e12
    print(f"{label:22s} rows={rows:3d} {str(dtype)[6:]:9s} {ms:8.3f} ms  "
          f"{rate:6.3f} T elem-op/s", flush=True)
    return ms


def main():
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    a, b, c, d = (run(rows, dtype, label) for rows, dtype, label in RUNS)
    print(f"bf16 speedup at 16 rows: {a / b:.2f}x; at 8 rows: {c / d:.2f}x",
          flush=True)


if __name__ == "__main__":
    main()
