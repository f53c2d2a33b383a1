"""Contact-map accumulation on the state's device — the primary LE
observable (``lammps_le_tpu/observe/contact_map.py``).

Contact maps (binned bead-bead proximity counts) are how loop-extrusion
simulations are compared to Hi-C data.  The accumulation reuses the halo
cell grid (``rdf.pair_votes``): every bead pair within ``radius`` votes
into a (nbins, nbins) genomic-bin matrix.  The votes are integer counts
(``torch.bincount`` of the live pairs' cells, offset by offset: exact in
any order) added to the float32 map, the reference's f32 sums of ones
while a cell stays under 2^24.  Intended to run every ``sample_every`` steps, not per step.
"""

from __future__ import annotations

import torch

from ..ops.grid import _shift
from ..state import State
from ..system import System
from .rdf import pair_votes, wide_system


def make_contact_fn(system: System, radius: float = 2.0, nbins: int = 256,
                    cap_boost: int = 1):
    """(state, cmap) -> (cmap, flags): this snapshot's contacts added plus
    a flags word (contact_map.py:22; FLAG_CELL_OVERFLOW when the dedicated
    grid dropped beads — then the frame undercounts and the caller must
    rebuild with a larger ``cell_cap``; LE globules are locally dense, so
    overflow must never pass silently).

    cmap is a (nbins, nbins) float32 matrix over genomic (chain-index)
    bins; both (i,j) and (j,i) receive each contact.  The contact radius
    can exceed the pair grid's one-cell reach (standard LE analysis uses
    2.0 sigma against ~1.5 sigma cells): a dedicated coarser grid then
    covers it (``rdf.wide_system``).
    """
    n = system.n
    system = wide_system(system, radius, cap_boost)
    assert radius <= system.neighbor.cell_size, (
        f"contact radius {radius} exceeds even a dedicated grid's reach "
        f"{system.neighbor.cell_size} (box too small)")

    def accumulate(state: State, cmap: torch.Tensor):
        dev = state.x.device
        bead_bin = torch.clamp(
            (torch.arange(n + 1, dtype=torch.int64, device=dev) * nbins)
            // n, 0, nbins - 1)
        counts = torch.zeros(nbins * nbins, dtype=torch.int64, device=dev)

        def vote(mask, rsq, slot, delta):
            gbin = bead_bin[slot]
            gbinj = _shift(gbin, delta, nbins)
            flat = gbin[:, None, :] * nbins + gbinj[None]
            counts.add_(torch.bincount(flat[mask], minlength=nbins * nbins))

        overflow = pair_votes(state, system, radius, vote)
        cm = cmap.to(torch.float32) + counts.reshape(nbins, nbins).to(
            torch.float32)
        return cm, overflow

    return accumulate


def contact_map_accumulate(state, system, cmap=None, radius=2.0, nbins=256):
    """One-shot wrapper (contact_map.py:111); raises on dropped beads after
    retrying with a doubled cell cap (a dropped bead = silently
    undercounted contacts in the A/B acceptance observable)."""
    if cmap is None:
        cmap = torch.zeros((nbins, nbins), dtype=torch.float32,
                           device=state.x.device)
    for cap_boost in (1, 2, 4, 8):
        fn = make_contact_fn(system, radius, nbins, cap_boost=cap_boost)
        out, fl = fn(state, cmap)
        if int(fl) == 0:
            return out
    raise RuntimeError(
        "contact_map: cell overflow persisted after cap retries")
