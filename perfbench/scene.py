"""The deployment's data, made from the run's seed: the chromosome as a
serpentine chain (a boustrophedon space-filling path of beads ``spacing``
apart along rows ``row_gap`` apart, jittered), its CTCF barrier beads,
the starting velocities and the run key.

The chain's layout is that of the engine's own ``scene.serpentine`` (same
arguments, same draws for the same generator seed), vectorised so that a
million beads take a fraction of a second.  Everything is numpy on the
host; the harness hands the arrays to the program and to the reference
alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Scene:
    x: np.ndarray          # (N, 3) positions in the box
    v: np.ndarray          # (N, 3) velocities
    types: np.ndarray      # (N,) int 0-based atom types
    box_lo: tuple
    box_hi: tuple
    run_seed: int          # the engine's run key seed
    extruders: np.ndarray  # (E0, 2) the seeded extruders' anchors

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def next_bead(self) -> np.ndarray:
        nxt = np.arange(1, self.n + 1)
        nxt[-1] = -1
        return nxt


def serpentine(n, spacing, row_gap, jitter, barrier_fraction, barrier_types,
               rng):
    per_row = max(int(np.ceil(n ** (1 / 3))), 2)
    rows = max(int(np.ceil(np.sqrt(n / per_row))), 2)
    b = np.arange(n)
    i = b % per_row
    g = b // per_row
    r = g % rows
    plane = b // (per_row * rows)
    xi = np.where(g % 2 == 0, i, per_row - 1 - i)
    yi = np.where(plane % 2 == 0, r, rows - 1 - r)
    x = np.stack([xi * spacing, yi * row_gap, plane * row_gap],
                 axis=1).astype(np.float64)
    x += rng.normal(scale=jitter, size=x.shape)
    planes = int(np.ceil(n / (per_row * rows)))
    box_hi = (per_row * spacing + row_gap, rows * row_gap + row_gap,
              max(planes, 2) * row_gap + row_gap)
    x += 0.5 * row_gap
    types = np.zeros(n, np.int64)
    if barrier_fraction > 0:
        nbar = int(n * barrier_fraction)
        ids = rng.choice(n, size=nbar, replace=False)
        types[ids] = rng.choice(np.asarray(barrier_types) - 1, size=nbar)
    return x, types, (0.0, 0.0, 0.0), box_hi


def make_scene(cfg: dict, seed: int) -> Scene:
    """The configuration's chain, barriers, velocities at its starting
    temperature and run key, all drawn from ``seed``."""
    sc = cfg["scene"]
    root = np.random.SeedSequence(int(seed))
    chain_rng, vel_rng, key_rng = (np.random.default_rng(s)
                                   for s in root.spawn(3))
    x, types, lo, hi = serpentine(cfg["beads"], sc["spacing"], sc["row_gap"],
                                  sc["jitter"], sc["barrier_fraction"],
                                  sc["barrier_types"], chain_rng)
    v = vel_rng.normal(scale=np.sqrt(sc["t_start"]), size=x.shape)
    v -= v.mean(axis=0)
    n_ex = cfg["extruders"]["seeded"]
    sites = np.arange(n_ex) * (cfg["beads"] // max(n_ex, 1)) + 1
    return Scene(x=x, v=v, types=types, box_lo=lo, box_hi=hi,
                 run_seed=int(key_rng.integers(0, 2 ** 63)),
                 extruders=np.stack([sites, sites + 2], axis=1))
