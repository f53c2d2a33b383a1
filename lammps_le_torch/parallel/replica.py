"""Replica ensembles on the general path (``lammps_le_tpu.parallel
.replica``): R independent trajectories of one Simulation, the State's
tensors stacked on a leading replica axis, each replica with its own key
(the reference's multi-partition runs, universe.cpp ``-partition``).

On one card the runner steps the replicas in turn, each exactly as a
one-run ``make_step`` run with its key.  The mesh form (replicas laid out
across cards) is ROADMAP Queue 1 item 6, the multi-card paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import rng
from ..integrate.verlet import Simulation, make_step, setup
from ..state import State

_MESH = ("replicas across cards (a mesh) are not ported yet: ROADMAP "
         "Queue 1 item 6, the multi-card paths")


def _map(obj, fn):
    """``fn`` on every tensor of a State (or its neighbour structure),
    recursively; None stays None."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if obj is None:
        return None
    return dataclasses.replace(obj, **{
        f.name: _map(getattr(obj, f.name), fn)
        for f in dataclasses.fields(obj)})


def _stack(states):
    """One-run States (with alike neighbour structures) as one State whose
    tensors have a leading replica axis."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states)
    if first is None:
        return None
    return dataclasses.replace(first, **{
        f.name: _stack([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(first)})


def replica(state: State, r: int) -> State:
    """Replica ``r`` of a replicated State as a one-run State (views)."""
    return _map(state, lambda t: t[r])


def replicate_state(state: State, n_replicas: int, seed: int = 0) -> State:
    """A one-run State broadcast to ``n_replicas`` (copies), replica i's key
    ``fold_in(PRNGKey(seed), i)`` (replica.py:27)."""
    rep = _map(state, lambda t: t.unsqueeze(0).expand(
        (n_replicas,) + tuple(t.shape)).clone())
    keys = [rng.fold_in(rng.prng_key(seed), i) for i in range(n_replicas)]
    return rep.replace(key=torch.tensor(keys, dtype=torch.int64,
                                        device=state.key.device))


def sharded_replica_state(state: State, mesh, axis: str = "dp") -> State:
    """Replicas laid out over a mesh's ``axis``: not ported."""
    raise NotImplementedError(_MESH)


def make_replica_runner(sim: Simulation, groups: Optional[dict] = None,
                        mesh=None, axis: str = "dp", *, device="cuda"):
    """(setup_fn, segment_fn) on replicated States on ``device``
    (replica.py:45): ``setup_fn(states)`` sets each replica up,
    ``segment_fn(states, k)`` advances each by ``k`` steps with its own
    key, without the Langevin ramp's run bounds (as the reference's
    vmapped step).  Each call reads each replica's step and key once."""
    if mesh is not None:
        raise NotImplementedError(_MESH)
    step = make_step(sim, groups, device=device)

    def setup_fn(states: State) -> State:
        return _stack([setup(sim, replica(states, r))
                       for r in range(states.key.shape[0])])

    def segment_fn(states: State, k: int) -> State:
        out = []
        for r in range(states.key.shape[0]):
            st = replica(states, r)
            s0 = int(st.step)
            key_words = tuple(st.key.tolist())
            for i in range(1, k + 1):
                st = step(st, s0 + i, key_words)
            out.append(st)
        return _stack(out)

    return setup_fn, segment_fn
