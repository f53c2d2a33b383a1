"""Counter-based threefry2x32 streams, frozen for the reference.

The program draws its Langevin noise and its loop-extrusion events from
threefry2x32 (Salmon et al., SC 2011, 20 rounds) in two ways, and the
reference needs the same bits:

* ``counter_uniform3``: the fast engine's noise, keyed by (run key, step,
  bead): counter (bead, 4 * step + component), the top 24 bits of the
  first output word as a float in [0, 1).
* ``fold_in`` / ``split`` / ``uniform``: ``jax.random``'s threefry key
  schedule and uniform floats (``jax_threefry_partitionable``), which the
  LE fixes use: ``fold_in(k, d) = threefry(k, (0, d))``,
  ``split(k)[i] = threefry(k, (0, i))``, the 32
  bits of element ``i`` are ``x0 ^ x1`` of ``threefry(k, (i >> 32, i))``,
  and a float32 uniform is those bits' top 23 as a mantissa in [1, 2),
  minus 1.

Words are held in int64 and masked to 32 bits (PyTorch has no uint32
arithmetic on every device).  Nothing here imports the program.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, c0, c1):
    """The 20-round threefry2x32 block of key (k0, k1) on counter (c0,
    c1); python ints or int64 tensors (broadcast)."""
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & M32)
    x0 = (c0 + ks[0]) & M32
    x1 = (c1 + ks[1]) & M32
    for block in range(5):
        for r in _ROT[block % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & M32
    return x0, x1


def prng_key(seed: int):
    """The key words of a 64-bit seed: (high word, low word)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (s >> 32) & M32, s & M32


def fold_in(key, data: int):
    return threefry2x32(int(key[0]), int(key[1]), 0, int(data) & M32)


def split(key, num: int = 2):
    return [threefry2x32(int(key[0]), int(key[1]), 0, i) for i in range(num)]


def uniform(key, n: int, device, dtype=torch.float64) -> torch.Tensor:
    """``n`` float32 uniforms in [0, 1) of ``key`` (element i from counter
    (i >> 32, i)), returned in ``dtype``."""
    cnt = torch.arange(int(n), dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(int(key[0]), int(key[1]), cnt >> 32, cnt & M32)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).to(dtype)


def counter_uniform3(key, beads: torch.Tensor, step: int,
                     dtype=torch.float64) -> torch.Tensor:
    """(N, 3) uniforms in [0, 1) of bead ids ``beads`` at ``step``: the
    counter is (bead, 4 step + component), the float the first word's top
    24 bits over 2**24."""
    c0 = beads.to(torch.int64) & M32
    out = []
    for comp in range(3):
        x0, _ = threefry2x32(int(key[0]), int(key[1]), c0,
                             (4 * int(step) + comp) & M32)
        out.append((x0 >> 8).to(torch.float64) / 16777216.0)
    return torch.stack(out, dim=1).to(dtype)
