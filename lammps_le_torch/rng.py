"""Counter-based random streams, bitwise equal to the reference's.

Two parts:

* ``threefry2x32`` / ``uniform3``: the Langevin noise planes keyed by
  (run key, step, bead id) (engine.py:909-948, pallas_step.py:154).  The
  CUDA kernel of ``fast/kernels.py`` computes the same in native uint32.
* ``prng_key`` / ``fold_in`` / ``split`` / ``uniform``: the ``jax.random``
  calls the LE fixes make (extrusion.py:115-117, ex_load.py:96,
  ex_unload.py:34; key schedule engine.py:1211-1216, 1400-1403), as jax
  0.9 computes them with ``jax_threefry_partitionable=True``:
  ``fold_in(k, d) = threefry(k, (0, d))``, ``split(k)[i] = threefry(k,
  (0, i))``, and the 32 random bits of element ``i`` are ``x0 ^ x1`` of
  ``threefry(k, (0, i))`` (jax/_src/prng.py ``_threefry_fold_in``,
  ``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``).

PyTorch has no uint32 add or shift on the CPU, so words live in int64
and are masked to 32 bits.  Every function takes python ints or int64
tensors alike; key words are python ints on the host.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_TF_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def threefry2x32(k0, k1, c0, c1):
    """threefry2x32 (Salmon et al. 2011), 20 rounds, on 32-bit words held
    in python ints or int64 tensors."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _M32)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for i in range(5):
        for j in range(4):
            r = _TF_ROT[4 * (i % 2) + j]
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def uniform3(key_words, bid: torch.Tensor, sstep: int, dtype):
    """Three (cap, P) uniform [0, 1) planes keyed by (key, step, bead)
    (engine._uniform3): counter (bid, step*4 + component)."""
    k0, k1 = key_words
    c0 = bid.to(torch.int64) & _M32
    base = (int(sstep) * 4) & _M32
    scale = 1.0 / 16777216.0
    us = []
    for comp in range(3):
        x0, _ = threefry2x32(k0, k1, c0, (base + comp) & _M32)
        us.append((x0 >> 8).to(dtype) * scale)
    return torch.stack(us)


def prng_key(seed: int):
    """Raw words of ``jax.random.PRNGKey(seed)`` (64-bit seed split
    high/low, prng.py ``_threefry_seed``)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return ((s >> 32) & _M32, s & _M32)


def fold_in(key, data: int):
    """``jax.random.fold_in`` on raw words."""
    k0, k1 = key
    return threefry2x32(int(k0), int(k1), 0, int(data) & _M32)


def split(key, num: int = 2):
    """``jax.random.split`` on raw words: a list of ``num`` word pairs."""
    k0, k1 = int(key[0]), int(key[1])
    return [threefry2x32(k0, k1, 0, i) for i in range(num)]


def uniform(key, n: int, device="cuda") -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32)`` on raw words: the top 23
    bits of ``x0 ^ x1`` as the mantissa of a float in [1, 2), minus 1."""
    k0, k1 = int(key[0]), int(key[1])
    cnt = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(cnt), cnt)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
