"""The least time the problem's work of a step could take on the card,
counted from the problem and not from how an engine lays it out.

Work is counted from the beads' positions: the pairs closer than the LJ
cutoff (each once, by the reference's cell list), the chain's bonds and
the active extruders.  Each pair, bond or spring is priced at the
floating-point operations its force needs (distance, the force's
polynomial, the force added to both beads), each bead at its positions
read once and its forces written once.  The streaming phase (kick, drift,
thermostat) reads and writes each bead's position, velocity and force
once and draws three random numbers a bead (threefry2x32: 20 rounds of
an add, a rotate and a xor, and the key schedule, priced at the float
rate, which no integer rate exceeds).  The peaks are NVIDIA's published
H100 SXM figures at 700 W, dense, outside the tensor cores.

A share above 100% would mean the count is too high or the time misses
part of the work; a reader divides by device time and never clips.
"""

from __future__ import annotations

import torch

from .reference.forces import pair_count

PEAK_FLOPS = 67e12      # float32, H100 SXM
PEAK_BYTES = 3.35e12    # HBM3, H100 SXM
F32 = 4

FLOPS_PAIR = 23     # distance 8, 1/r^2 1, r^6 2, force factor 3, d*f 3,
                    # added to both beads 6
FLOPS_BOND = 26     # distance 8, FENE factor 3, WCA 6, d*f 3, both beads 6
FLOPS_SPRING = 21   # distance 8, sqrt + factor 4, d*f 3, both beads 6
OPS_THREEFRY = 3 * (20 * 3 + 5 * 3 + 3)   # three draws a bead
FLOPS_STREAM = 2 * 6 + 6 + 6              # two half kicks, drift, drag


def work(x: torch.Tensor, lo, box, cutoff: float, n_bonds: int,
         n_extruders: int) -> dict:
    """The problem's pair and stream work of one step of one run at
    positions ``x`` (N, 3)."""
    n = x.shape[0]
    pairs = pair_count(x.to(torch.float64), lo, box, cutoff)
    pair_flops = (FLOPS_PAIR * pairs + FLOPS_BOND * n_bonds
                  + FLOPS_SPRING * n_extruders)
    pair_bytes = 2 * 3 * F32 * n + 2 * 4 * n_extruders
    stream_ops = (FLOPS_STREAM + OPS_THREEFRY) * n
    stream_bytes = 2 * 9 * F32 * n
    return {"pairs": pairs, "pair_flops": pair_flops,
            "pair_bytes": pair_bytes, "stream_ops": stream_ops,
            "stream_bytes": stream_bytes,
            "pair_s": max(pair_flops / PEAK_FLOPS, pair_bytes / PEAK_BYTES),
            "stream_s": max(stream_ops / PEAK_FLOPS,
                            stream_bytes / PEAK_BYTES)}
