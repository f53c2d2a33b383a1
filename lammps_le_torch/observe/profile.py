"""Section timing breakdown — the reference's Timer/Finish report analog
(``lammps_le_tpu/observe/profile.py``; LAMMPS: src/timer.h:25-28
PAIR/BOND/NEIGH/COMM/MODIFY categories; src/finish.cpp:61-327 prints the
per-section table and "Performance: ... timesteps/s").

Each section is one piece of the general path (``integrate.verlet``)
called on its own ``iters`` times after a warm-up call, and the whole
step is the general path's ``make_step`` over ``iters`` steps after ten:
timed with CUDA events on the card (device time of the queued calls,
host issue included where the host is slower) and with
``time.perf_counter`` on the CPU.  Sections therefore do not sum exactly
to the step time; both are reported.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from ..integrate.verlet import Simulation, make_step, setup
from ..ops import bond as bond_ops
from ..ops import grid as grid_ops
from ..ops.forces import special_pair_correction
from ..state import State


def _timed(fn, dev, iters: int = 50) -> float:
    """Seconds a call of ``fn`` over ``iters`` calls after one."""
    fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(stop) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def profile(sim: Simulation, state: State, iters: int = 50) -> Dict[str, float]:
    """Per-section seconds/step + whole-step time (``total_step``) on the
    state's device; prints a report (profile.py:38)."""
    system = sim.system
    state = setup(sim, state)
    dev = state.x.device
    x = state.x
    types = state.type
    nbr = state.nbr

    sections: Dict[str, float] = {}

    if system.pair is not None and system.neighbor.use_cells:
        sections["pair"] = _timed(
            lambda: grid_ops.grid_pair_force(x, types, nbr, system), dev,
            iters)
        sections["neigh"] = _timed(
            lambda: grid_ops.build_grid(x, system), dev,
            max(iters // 5, 5)) / max(system.neighbor.rebuild_every, 1)

    if system.bonds is not None:
        sections["bond"] = _timed(
            lambda: bond_ops.backbone_bond_force(x, system), dev, iters)
        if sim.ex_btype > 0:
            sections["bond"] += _timed(
                lambda: bond_ops.extruder_bond_force(
                    x, state.ex_left, state.ex_right, sim.ex_btype - 1,
                    system), dev, iters)
            sections["special"] = _timed(
                lambda: special_pair_correction(
                    x, types, system, state.ex_left, state.ex_right), dev,
                iters)

    step = make_step(sim, device=dev)
    begin = int(state.step)
    key_words = tuple(state.key.tolist())
    run = [state, begin]

    def one():
        run[1] += 1
        run[0] = step(run[0], run[1], key_words)

    for _ in range(9):
        one()
    total = _timed(one, dev, iters)
    sections["total_step"] = total

    n = system.n
    print(f"\nPerformance: {1.0/total:.3f} timesteps/s, "
          f"{n/total/1e6:.3f} M bead-steps/s ({n} beads)")
    print(f"{'Section':<10} {'ms/step':>10} {'%step':>7}")
    print("-" * 30)
    for k, v in sections.items():
        if k == "total_step":
            continue
        print(f"{k:<10} {v*1e3:>10.3f} {100*v/total:>6.1f}%")
    print(f"{'whole step':<10} {total*1e3:>10.3f}")
    return sections
