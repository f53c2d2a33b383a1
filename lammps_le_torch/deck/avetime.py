"""fix ave/time: time-averaged scalar/vector series (src/fix_ave_time.cpp).

Scalar single-input form: every ``nevery`` steps a sample of the input
(c_ID compute or v_name variable) is taken; at each multiple of
``nfreq`` the mean of the last ``nrepeat`` samples is appended to the
output file as ``step value`` (LAMMPS one-value row format).

``mode vector`` (fix_ave_time.cpp MODE=VECTOR): the input is a global
vector/array compute (``c_ID[*]`` — here compute rdf); samples average
element-wise and each Nfreq boundary appends a block in the reference's
vector format::

    step nrows
    row col1 col2 ...

Host-side: rides the dump boundary-callback contract
(io/dump.write_frame), so it works on both engines.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class AveTime:
    style = "ave/time"

    def __init__(self, runner, fid: str, nevery: int, nrepeat: int,
                 nfreq: int, input_: str, path: str, mode: str = "scalar"):
        if nfreq % nevery != 0 or nrepeat * nevery > nfreq:
            raise ValueError(
                "fix ave/time requires Nfreq %% Nevery == 0 and "
                "Nrepeat*Nevery <= Nfreq (fix_ave_time.cpp)")
        self.runner = runner
        self.id = fid
        self.every = nevery          # dump-contract cadence
        self.nrepeat = nrepeat
        self.nfreq = nfreq
        self.input = input_.removesuffix("[*]")
        self.mode = mode
        self.path = path
        self._samples: List[Tuple[int, object]] = []
        self._fh = None

    def close(self):
        # dump-contract lifecycle hook (run_with_dumps closes its specs)
        if self._fh:
            self._fh.close()
            self._fh = None

    def _value(self, state):
        r = self.runner
        inp = self.input
        if inp.startswith("c_"):
            # some compute branches (pressure) read r.state internally —
            # swap in the SAMPLED state for the evaluation
            saved = r.state
            r.state = state
            try:
                if self.mode == "vector":
                    return r._compute_vector(inp[2:], state)
                return float(r._compute_value(inp[2:], state))
            finally:
                r.state = saved
        if inp.startswith("v_"):
            name = inp[2:]
            saved = r.state
            r.state = state
            try:
                return float(str(r.script_vars[name]))
            finally:
                r.state = saved
        raise ValueError(f"fix ave/time: unsupported input {inp!r}")

    def sample(self, state, system):
        step = int(state.step)
        # samples at the Nrepeat multiples of Nevery ENDING at a
        # multiple of Nfreq (fix_ave_time.cpp nvalid schedule)
        off = (-step) % self.nfreq
        if off > (self.nrepeat - 1) * self.every:
            return
        self._samples.append((step, self._value(state)))
        if step % self.nfreq == 0:
            window = [v for (s, v) in self._samples
                      if s > step - self.nrepeat * self.every]
            if len(window) < self.nrepeat:
                # partial window (e.g. the run-start boundary): the
                # reference's first output lands one full Nfreq later
                return
            if self._fh is None:
                self._fh = open(self.path, "w")
                self._fh.write(f"# fix ave/time {self.input} "
                               f"{self.every} {self.nrepeat} "
                               f"{self.nfreq} mode {self.mode}\n")
            if self.mode == "vector":
                avg = np.mean(np.stack(window), axis=0)
                self._fh.write(f"{step} {avg.shape[0]}\n")
                np.savetxt(self._fh, avg, fmt="%.10g")
            else:
                self._fh.write(
                    f"{step} {sum(window) / len(window):.10g}\n")
            self._fh.flush()
            self._samples = []
