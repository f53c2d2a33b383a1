"""Trajectory dumps: xyz and custom-column text writers
(``lammps_le_tpu/io/dump.py``).

Covers the dump subset the LE workflow uses (reference: src/dump_atom.cpp,
src/dump_custom.cpp:1207 ``write_data``).  Output is produced on host at
dump intervals: the State's tensors are read off the card only at those
boundaries, which both engines' run loops (``fast.run_fast``,
``integrate.run``) call through ``boundary_callback``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..state import host


@dataclasses.dataclass
class DumpSpec:
    id: str
    style: str           # 'xyz' | 'atom' | 'custom' | 'local'
    every: int
    path: str
    fields: List[str]
    ex_btype: int = 2    # 1-based extruder bond type for 'local' frames
    # per-bond value columns for 'local' frames (compute bond/local,
    # src/compute_bond_local.cpp): any of btype/batom1/batom2/dist/eng
    local_cols: Optional[List[str]] = None
    # atom-style variable columns: 'v_name' -> (state, system) -> (N,)
    # (src/dump_custom.cpp parse_fields, the v_ case)
    atom_cols: Optional[dict] = None
    # generalized 'local' source: (state, system) -> (M, k) ndarray for
    # angle/local & pair/local computes (src/compute_angle_local.cpp,
    # src/compute_pair_local.cpp); None = the bond-list default
    local_rows: object = None
    _fh: object = None

    def open(self):
        if self._fh is None:
            if self.path.endswith(".gz"):
                # compressed dumps (the reference's dump */gz variants /
                # COMPRESS package, src/dump_atom_gz.cpp): transparent
                # from the .gz suffix like `dump ... file.dump.gz`
                import gzip

                self._fh = gzip.open(self.path, "wt")
            else:
                self._fh = open(self.path, "w")
        return self._fh

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def write_frame(spec: DumpSpec, state, system):
    if hasattr(spec, "sample"):
        # boundary samplers (fix ave/time) ride the dump-cadence contract
        spec.sample(state, system)
        return
    fh = spec.open()
    n = system.n
    x = host(state.x)
    step = int(state.step)
    if spec.style == "local" and spec.local_rows is not None:
        # angle/local & pair/local frames: the runner-supplied callable
        # yields the already-column-ordered (M, k) value table
        rows = np.asarray(spec.local_rows(state, system))
        fh.write("ITEM: TIMESTEP\n%d\n" % step)
        fh.write("ITEM: NUMBER OF ENTRIES\n%d\n" % rows.shape[0])
        fh.write("ITEM: BOX BOUNDS pp pp pp\n")
        for lo, hi in zip(system.box_lo, system.box_hi):
            fh.write(f"{lo:.6g} {hi:.6g}\n")
        fh.write("ITEM: ENTRIES " + " ".join(
            spec.fields or [f"c_l[{k+1}]" for k in range(rows.shape[1])])
            + "\n")
        np.savetxt(fh, rows, fmt="%.8g")
        fh.flush()
        return
    if spec.style == "local":
        # bond list frames (reference: compute property/local btype batom1
        # batom2 + dump local, src/compute_property_local.cpp +
        # src/dump_local.cpp) — backbone bonds from the implicit chain,
        # extruder bonds from the live table; 1-based ids/types.  Value
        # columns (dist/eng) follow compute bond/local
        # (src/compute_bond_local.cpp).
        nxt = np.asarray(system.next_bead)
        bt = np.asarray(system.backbone_type)
        src = np.nonzero(nxt >= 0)[0]
        a1 = list(src)
        a2 = [int(nxt[i]) for i in src]
        ty = [int(bt[i]) + 1 for i in src]
        exl = host(state.ex_left)
        exr = host(state.ex_right)
        for l, r in zip(exl, exr):
            if l >= 0:
                a1.append(int(l))
                a2.append(int(r))
                ty.append(spec.ex_btype)
        a1 = np.asarray(a1, np.int64)
        a2 = np.asarray(a2, np.int64)
        ty = np.asarray(ty, np.int64)
        cols = spec.local_cols or ["btype", "batom1", "batom2"]
        need_vals = any(c in ("dist", "eng") for c in cols)
        if need_vals:
            box = np.asarray(system.box_size, np.float64)
            d = x[a2] - x[a1]
            d -= box * np.round(d / box)
            dist = np.sqrt(np.sum(d * d, axis=-1))
            eng = _bond_energy(system, ty, dist) if "eng" in cols else None
        fh.write("ITEM: TIMESTEP\n%d\n" % step)
        fh.write("ITEM: NUMBER OF ENTRIES\n%d\n" % len(a1))
        fh.write("ITEM: BOX BOUNDS pp pp pp\n")
        for lo, hi in zip(system.box_lo, system.box_hi):
            fh.write(f"{lo:.6g} {hi:.6g}\n")
        fh.write("ITEM: ENTRIES " + " ".join(spec.fields or
                 [f"c_bl[{k+1}]" for k in range(len(cols))]) + "\n")
        out = []
        for c in cols:
            if c == "btype":
                out.append(ty)
            elif c == "batom1":
                out.append(a1 + 1)
            elif c == "batom2":
                out.append(a2 + 1)
            elif c == "dist":
                out.append(dist)
            elif c == "eng":
                out.append(eng)
            else:
                raise ValueError(f"unsupported local column {c}")
        np.savetxt(fh, np.column_stack(out), fmt="%.8g")
        fh.flush()
        return
    if spec.style == "xyz":
        fh.write(f"{n}\nAtoms. Timestep: {step}\n")
        types = host(state.type) + 1
        for i in range(n):
            fh.write(f"{types[i]} {x[i,0]:.6g} {x[i,1]:.6g} {x[i,2]:.6g}\n")
    elif spec.style in ("atom", "custom"):
        fh.write("ITEM: TIMESTEP\n%d\n" % step)
        fh.write("ITEM: NUMBER OF ATOMS\n%d\n" % n)
        fh.write("ITEM: BOX BOUNDS pp pp pp\n")
        for lo, hi in zip(system.box_lo, system.box_hi):
            fh.write(f"{lo:.6g} {hi:.6g}\n")
        fields = spec.fields or ["id", "type", "x", "y", "z"]
        fh.write("ITEM: ATOMS " + " ".join(fields) + "\n")
        cols = {}
        types = host(state.type) + 1
        v = host(state.v)
        img = host(state.img)
        for fld in fields:
            if fld == "id":
                cols[fld] = np.arange(1, n + 1)
            elif fld == "mol":
                cols[fld] = system.molecule + 1
            elif fld == "type":
                cols[fld] = types
            elif fld in ("x", "y", "z"):
                cols[fld] = x[:, "xyz".index(fld)]
            elif fld in ("xu", "yu", "zu"):
                ax = "xyz".index(fld[0])
                box = system.box_size[ax]
                cols[fld] = x[:, ax] + img[:, ax] * box
            elif fld in ("vx", "vy", "vz"):
                cols[fld] = v[:, "xyz".index(fld[1])]
            elif fld in ("ix", "iy", "iz"):
                cols[fld] = img[:, "xyz".index(fld[1])]
            elif fld.startswith(("v_", "c_")) and spec.atom_cols \
                    and fld in spec.atom_cols:
                # atom-style variables / per-atom computes, resolved by
                # the deck at dump-definition time (dump_custom.cpp
                # parse_fields v_/c_ cases)
                cols[fld] = spec.atom_cols[fld](state, system)
            else:
                raise ValueError(f"unsupported dump field {fld}")
        mat = np.column_stack([cols[f] for f in fields])
        np.savetxt(fh, mat, fmt="%.8g")
    else:
        raise ValueError(f"unsupported dump style {spec.style}")
    fh.flush()


def _bond_energy(system, btype_1based, dist):
    """Per-bond energy by 1-based type (compute bond/local 'eng',
    src/compute_bond_local.cpp; formulas: src/MOLECULE/bond_fene.cpp:52-128,
    src/MOLECULE/bond_harmonic.cpp:48)."""
    from ..system import BOND_FENE, BOND_HARMONIC

    styles = np.asarray(system.bonds.style)
    coeffs = np.asarray(system.bonds.coeffs)
    eng = np.zeros_like(dist)
    for t in np.unique(btype_1based):
        m = btype_1based == t
        st = int(styles[t - 1])
        c = coeffs[t - 1]
        r = dist[m]
        if st == BOND_HARMONIC:
            k, r0 = c[0], c[1]
            eng[m] = k * (r - r0) ** 2
        elif st == BOND_FENE:
            k, r0, eps, sig = c[0], c[1], c[2], c[3]
            rlog = np.maximum(1.0 - (r / r0) ** 2, 0.1)
            e = -0.5 * k * r0 * r0 * np.log(rlog)
            wca = r < 2.0 ** (1.0 / 6.0) * sig
            sr6 = (sig / np.maximum(r, 1e-12)) ** 6
            e = e + np.where(wca, 4.0 * eps * sr6 * (sr6 - 1.0) + eps, 0.0)
            eng[m] = e
        else:
            raise ValueError(f"unknown bond style {st}")
    return eng


def run_with_dumps(sim, state, nsteps, dumps, groups=None,
                   thermo_every=0, thermo_callback=None, use_fast=False):
    """Drive ONE run loop, writing dump frames from a boundary callback.

    A single ``run()`` invocation segments device execution on
    gcd(dump cadences, thermo_every): setup runs once, thermo rows appear
    exactly at the thermo cadence (reference: dumps fire on absolute
    timestep multiples, src/output.cpp:284), and each dump writes whenever
    ``step % every == 0`` — including the initial frame, as the reference's
    ``output->setup`` does (src/verlet.cpp:156).

    ``use_fast=True`` drives the grid-resident fast engine through the
    same boundary contract (production LE decks all dump, so the measured
    engine and the production engine must be the same one); dumped frames
    are engine-independent (tests/test_fastpath.py).
    """
    cadence = 0
    for d in dumps:
        cadence = _gcd0(cadence, d.every)

    def on_boundary(st):
        step = int(st.step)
        for d in dumps:
            if step % d.every == 0:
                write_frame(d, st, sim.system)

    if use_fast:
        from ..fast import run_fast

        state, rows = run_fast(
            sim, state, nsteps,
            thermo_every=thermo_every, thermo_callback=thermo_callback,
            boundary_every=cadence, boundary_callback=on_boundary,
            groups=groups,
        )
    else:
        from ..integrate import run as run_loop

        state, rows = run_loop(
            sim, state, nsteps, groups=groups,
            thermo_every=thermo_every, thermo_callback=thermo_callback,
            boundary_every=cadence, boundary_callback=on_boundary,
        )
    for d in dumps:
        d.close()
    return state, rows


def _gcd0(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a
