"""Replica ensembles on the general path (``lammps_le_tpu.parallel
.replica``): R independent trajectories of one Simulation, the State's
tensors stacked on a leading replica axis, each replica with its own key
(the reference's multi-partition runs, universe.cpp ``-partition``).

On one card the runner steps the replicas in turn, each exactly as a
one-run ``make_step`` run with its key.  Over a mesh (a sequence of
``torch.device``, the reference's ``dp`` axis) the replicas lie in
contiguous blocks, block i on ``mesh[i]`` (``sharded_replica_state``, as
``P("dp")`` splits them), each block stepped by its own device's
``make_step``; step i is issued on every device before step i + 1, so
that the cards overlap, and no step reads the card.  Replicas never
communicate (replica.py:1-12), so a replica's run is the one-card
runner's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import rng
from ..integrate.verlet import Simulation, make_step, setup
from ..state import State

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


def sharded_replica_state(state: State, mesh, axis: str = "dp"):
    """A replicated State laid out over ``mesh`` (a sequence of devices,
    the reference's ``axis`` of a Mesh, replica.py:39-42): a list of
    len(mesh) States, block i the contiguous replicas [i R / D, (i + 1) R /
    D) copied onto ``mesh[i]``.  R must be divisible by len(mesh), as
    ``P(axis)`` requires."""
    devs = [torch.device(d) for d in mesh]
    R = state.key.shape[0]
    if R % len(devs):
        raise ValueError(f"{R} replicas over {len(devs)} devices: R must be "
                         f"divisible by the mesh's {axis} size")
    b = R // len(devs)
    return [_map(state, lambda t, i=i: t[i * b:(i + 1) * b].to(
        dev, copy=True)) for i, dev in enumerate(devs)]


def gather_replica_state(blocks) -> State:
    """``sharded_replica_state``'s blocks as one replicated State on the
    first block's device."""
    dev = blocks[0].key.device

    def cat(*ts):
        if ts[0] is None:
            return None
        if isinstance(ts[0], torch.Tensor):
            return torch.cat([t.to(dev) for t in ts])
        return dataclasses.replace(ts[0], **{
            f.name: cat(*(getattr(t, f.name) for t in ts))
            for f in dataclasses.fields(ts[0])})

    return cat(*blocks)


def make_replica_runner(sim: Simulation, groups: Optional[dict] = None,
                        mesh=None, axis: str = "dp", *, device="cuda"):
    """(setup_fn, segment_fn) on replicated States on ``device``
    (replica.py:45): ``setup_fn(states)`` sets each replica up,
    ``segment_fn(states, k)`` advances each by ``k`` steps with its own
    key, without the Langevin ramp's run bounds (as the reference's
    vmapped step).  Each call reads each replica's step and key once.

    With ``mesh`` (a sequence of devices, ``axis`` naming it as the
    reference's Mesh axis does) both take and return
    ``sharded_replica_state``'s list of blocks, block i on ``mesh[i]``
    and stepped by that device's ``make_step``; ``device`` is then
    unused.  Step i of every replica is issued before step i + 1 of
    any."""
    # one card: a mesh of one device, the State its one block
    devs = [torch.device(d) for d in (mesh or [device])]
    steps = {d: make_step(sim, groups, device=d) for d in set(devs)}

    def blocks_of(states):
        if mesh is None:
            return [states]
        if len(states) != len(devs):
            raise ValueError(f"{len(states)} blocks on a mesh of "
                             f"{len(devs)} devices")
        return states

    def out(blocks):
        return blocks[0] if mesh is None else blocks

    def setup_fn(states):
        return out([_stack([setup(sim, replica(b, r))
                            for r in range(b.key.shape[0])])
                    for b in blocks_of(states)])

    def segment_fn(states, k: int):
        runs = [[replica(b, r) for r in range(b.key.shape[0])]
                for b in blocks_of(states)]
        heads = [[(int(st.step), tuple(st.key.tolist())) for st in row]
                 for row in runs]
        for i in range(1, k + 1):
            for dev, row, head in zip(devs, runs, heads):
                for r, (s0, key_words) in enumerate(head):
                    row[r] = steps[dev](row[r], s0 + i, key_words)
        return out([_stack(row) for row in runs])

    return setup_fn, segment_fn
