"""Checkpoint/resume: the State's fields as one .npz archive
(``lammps_le_tpu/io/checkpoint.py``).

The file is the reference's: its ``MAGIC``, its field names, and each
field in the reference's dtype (integer fields int32, the key as its two
uint32 words, ``step`` int32, ``flags`` uint32), so a checkpoint moves
between the two packages in both directions.  The port's int64 fields are
converted here and nowhere else.  Positions, velocities, images, types,
the extruder table, PRNG key, step counter and sticky flags are all
saved, so a restored run is a bitwise continuation (the reference's
restart files lose RanMars streams and fix bondcount, SURVEY.md §5.4).
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import State, host

MAGIC = "lammps-le-tpu-ckpt-v1"

_FIELDS = [
    "x", "v", "f", "img", "type", "ex_left", "ex_right",
    "key", "step", "flags", "epair", "ebond",
    "n_moves", "n_loads", "n_unloads", "last_event", "therm_e",
]

# the reference State's integer dtypes (lammps_le_tpu/state.py:46-79)
_FILE_DTYPE = {
    "img": np.int32, "type": np.int32, "ex_left": np.int32,
    "ex_right": np.int32, "key": np.uint32, "step": np.int32,
    "flags": np.uint32, "n_moves": np.int32, "n_loads": np.int32,
    "n_unloads": np.int32, "last_event": np.int32,
}


def save_checkpoint(path: str, state: State):
    arrs = {}
    for name in _FIELDS:
        a = host(getattr(state, name))
        if name in _FILE_DTYPE:
            a = a.astype(_FILE_DTYPE[name])
        arrs[name] = a
    arrs["__magic__"] = np.array(MAGIC)
    np.savez_compressed(path, **arrs)


def load_checkpoint(path: str, like: State) -> State:
    """A State with ``like``'s dtypes and device holding the file's
    fields (``like``'s where the file lacks one: older checkpoints lack
    ``last_event``); no neighbour structure."""
    with np.load(path, allow_pickle=False) as z:
        if str(z["__magic__"]) != MAGIC:
            raise ValueError(f"{path} is not a lammps_le checkpoint")
        kw = {}
        for name in _FIELDS:
            ref = getattr(like, name)
            if name not in z.files:
                continue
            a = z[name]
            if name in _FILE_DTYPE:
                a = a.astype(np.int64)
            kw[name] = torch.as_tensor(a, dtype=ref.dtype,
                                       device=ref.device).reshape(ref.shape)
    return like.replace(nbr=None, **kw)
