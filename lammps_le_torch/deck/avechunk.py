"""fix ave/chunk: time-averaged per-chunk atom values
(src/fix_ave_chunk.cpp, the ``norm all`` default).

``fix ID group ave/chunk Nevery Nrepeat Nfreq chunkID value... [file f]``

Every ``nevery`` steps each value is sampled per atom and binned onto
the chunk ids of the referenced ``compute chunk/atom``; at each Nfreq
boundary the per-chunk sums over the window's Nrepeat samples are
normalized by the summed atom counts (norm all — one average over
atoms x samples, fix_ave_chunk.cpp normflag ALL) and appended as the
reference's array block format::

    step nchunks total-count
    chunk count value1 value2 ...

Values: per-atom attribute names (x/y/z/vx/.../fx..., deck/atomvars
ATOM_NAMES), per-atom computes ``c_ID``/``c_ID[k]``, and atom-style
variables ``v_name``.  Host-side on the dump boundary contract like
AveTime, so it rides both engines.
"""

from __future__ import annotations

from typing import List

import numpy as np


class AveChunk:
    style = "ave/chunk"

    def __init__(self, runner, fid: str, nevery: int, nrepeat: int,
                 nfreq: int, chunk_id: str, values: List[str], path: str,
                 group: str = "all"):
        if nfreq % nevery != 0 or nrepeat * nevery > nfreq:
            raise ValueError(
                "fix ave/chunk requires Nfreq %% Nevery == 0 and "
                "Nrepeat*Nevery <= Nfreq (fix_ave_chunk.cpp)")
        if not values:
            raise ValueError("fix ave/chunk: at least one value required")
        self.runner = runner
        self.id = fid
        self.every = nevery
        self.nrepeat = nrepeat
        self.nfreq = nfreq
        self.chunk_id = chunk_id
        self.values = values
        self.group = group
        self.path = path
        self._acc = None        # (nchunk, nvals) running sums
        self._cnt = None        # (nchunk,) atom-sample counts
        self._nsamp = 0
        self._fh = None

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def _atom_values(self, val, state):
        from .atomvars import ATOM_NAMES

        r = self.runner
        if val.startswith("c_"):
            cid, idx = r._parse_cref(val[2:])
            out = r._peratom_value(cid, state)
            if out.ndim == 2:
                out = out[:, (idx or 1) - 1]
            return np.asarray(out, np.float64)
        if val.startswith("v_"):
            name = val[2:]
            if name not in r.atom_vars:
                raise ValueError(
                    f"fix ave/chunk: {val} is not an atom variable")
            return np.asarray(r.atom_vars[name].evaluate(
                state, r.system, r.atom_var_scalars, r.atom_vars),
                np.float64)
        if val in ATOM_NAMES:
            return np.asarray(ATOM_NAMES[val](state, r.system),
                              np.float64)
        raise ValueError(f"fix ave/chunk: unknown value {val!r}")

    def sample(self, state, system):
        step = int(state.step)
        off = (-step) % self.nfreq
        if off > (self.nrepeat - 1) * self.every:
            return
        r = self.runner
        saved = r.state
        r.state = state
        try:
            ids, nchunk = r._chunk_ids(self.chunk_id, state)
            sel = r._group_mask(self.group)
            ok = ids >= 0
            if sel is not None:
                ok &= np.asarray(sel)
            idc = np.where(ok, ids, 0)
            w = ok.astype(np.float64)
            if self._acc is None or self._acc.shape[0] != nchunk:
                self._acc = np.zeros((nchunk, len(self.values)))
                self._cnt = np.zeros(nchunk)
                self._nsamp = 0
            for k, val in enumerate(self.values):
                v = self._atom_values(val, state)
                self._acc[:, k] += np.bincount(idc, weights=w * v,
                                               minlength=nchunk)
            self._cnt += np.bincount(idc, weights=w, minlength=nchunk)
            self._nsamp += 1
        finally:
            r.state = saved
        if step % self.nfreq == 0 and self._nsamp >= self.nrepeat:
            if self._fh is None:
                self._fh = open(self.path, "w")
                self._fh.write(
                    "# fix ave/chunk "
                    f"{self.chunk_id} {self.every} {self.nrepeat} "
                    f"{self.nfreq} values {' '.join(self.values)}\n"
                    "# Chunk Count " + " ".join(self.values) + "\n")
            nchunk = self._acc.shape[0]
            cnt = self._cnt / self._nsamp          # mean atoms per chunk
            avg = self._acc / np.maximum(self._cnt, 1e-300)[:, None]
            self._fh.write(
                f"{step} {nchunk} {cnt.sum():.8g}\n")
            rows = np.column_stack(
                [np.arange(1, nchunk + 1), cnt, avg])
            np.savetxt(self._fh, rows, fmt="%.8g")
            self._fh.flush()
            self._acc = None
            self._cnt = None
            self._nsamp = 0
