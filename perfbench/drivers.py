"""The entries a cell's window drives, one class a ``driver`` kind of the
workload files:

* ``segment``: one run on the fast engine, the ``segment`` that
  ``make_fast_segment(sim, pallas=, reactive=)`` returns, on ``to_fast``'s
  state (K2's step loop with ``pallas: "real"``; the chain otherwise).
* ``replicas``: R runs of one settled state on the static chain, as
  ``run_fast_replicas`` builds and steps them (its segment, on its
  replica-batched state, replica r's key folded with ``key_seed + r``).

Each driver advances its state by whole segments, copies it (a snapshot
the check replays), replays a copy for a few steps, and gives the state
in bead layout, a dict per replica.
"""

from __future__ import annotations

import dataclasses

import torch

from . import build

RUN_SPAN = 10 ** 9  # the Langevin ramp's run length: t_start == t_stop


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple):
        return tuple(_clone(o) for o in obj)
    return obj


class Segment:

    def __init__(self, cfg, work, system, state, device):
        from lammps_le_torch.fast import make_fast_segment, to_fast

        self.system = system
        self.sim = build.program_sim(cfg, self.system)
        eng = work["engine"]
        pallas = eng.get("pallas")
        self.loop = pallas in ("real", "interpret")
        self.segment, _ = make_fast_segment(
            self.sim, pallas=pallas, reactive=eng.get("reactive", True),
            device=device)
        self.state = to_fast(state, self.sim)
        self.begin = self.state.step

    @property
    def step(self) -> int:
        return int(self.state.step)

    @property
    def launches(self) -> int:
        return self.state.n_launches

    def warm(self, steps: int):
        self.advance(steps)

    def advance(self, steps: int, state=None):
        fs = self.state if state is None else state
        self.segment(fs, fs.step, steps, self.begin, self.begin + RUN_SPAN)
        return fs

    def snapshot(self, state=None):
        fs = self.state if state is None else state
        return dataclasses.replace(fs, **{
            f.name: _clone(getattr(fs, f.name))
            for f in dataclasses.fields(fs)})

    def replicas(self, fs):
        return [None]

    def beads(self, fs) -> list:
        from lammps_le_torch.fast import from_fast

        out = []
        for r in self.replicas(fs):
            s = from_fast(fs, self.system, r)
            clamps = fs.n_clamps if r is None else fs.n_clamps[r]
            out.append(_bead_dict(s, int(clamps)))
        return out

    def place_call(self):
        """A call of the program's placement on the state's beads, as a
        rebuild makes it."""
        from lammps_le_torch.fast.engine import extract_beads
        from lammps_le_torch.fast.maps import fast_maps
        from lammps_le_torch.fast.place import GridConsts, place

        fs = self.state
        maps = fast_maps(self.system)
        g = GridConsts.build(self.system, maps, fs.gx.device)
        x, v, f = extract_beads(fs, maps)
        return lambda: place(self.system, maps, g, x, v, f, fs.ex_left,
                             fs.ex_right, fs.img)


class Replicas(Segment):

    def __init__(self, cfg, work, system, state, device):
        from lammps_le_torch.fast import make_fast_segment, run_fast_replicas

        eng = work["engine"]
        self.system = system.with_neighbor(rebuild_every=eng["rebuild_every"])
        self.sim = build.program_sim(cfg, self.system)
        self.loop = False
        # run_fast_replicas builds the batched state and takes its first
        # steps; the window goes on with the same segment on that state
        self.state = run_fast_replicas(self.sim, state, work["replicas"],
                                       work["warm_steps"],
                                       seed=eng["key_seed"])
        self.segment, _ = make_fast_segment(self.sim, pallas=False,
                                            reactive=False, device=device)
        self.begin = self.state.step

    def warm(self, steps: int):
        """run_fast_replicas took the first ``steps`` steps already."""

    def replicas(self, fs):
        return list(range(fs.replicas))

    def place_call(self):
        from lammps_le_torch.fast.engine import extract_beads
        from lammps_le_torch.fast.maps import fast_maps
        from lammps_le_torch.fast.place import GridConsts, place_replicas

        fs = self.state
        maps = fast_maps(self.system)
        g = GridConsts.build(self.system, maps, fs.gx.device)
        x, v, f = extract_beads(fs, maps)
        return lambda: place_replicas(self.system, maps, g, x, v, f,
                                      fs.ex_left, fs.ex_right, fs.img)


def _bead_dict(s, clamps) -> dict:
    """A program State as the check reads it."""
    return {
        "x": s.x, "v": s.v, "f": s.f, "img": s.img, "types": s.type,
        "ex_left": s.ex_left, "ex_right": s.ex_right,
        "key_words": tuple(int(k) for k in s.key.tolist()),
        "step": int(s.step), "flags": int(s.flags),
        "n_moves": int(s.n_moves), "n_loads": int(s.n_loads),
        "n_unloads": int(s.n_unloads), "clamps": clamps,
    }


DRIVERS = {"segment": Segment, "replicas": Replicas}
