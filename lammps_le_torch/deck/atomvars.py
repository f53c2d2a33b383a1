"""Atom-style variables: per-atom expressions evaluated at use time.

Reference: ``variable name atom <expr>`` (src/variable.cpp, ATOM style —
evaluated lazily into a per-atom vector each time a consumer asks, e.g. a
``dump custom ... v_name`` column, src/dump_custom.cpp parse_fields'
``v_`` case).  The evaluator here is a safe numpy ast walk over the
per-atom quantities the engine exposes plus the usual math functions;
scalar ``v_other`` references resolve through the interpreter's variable
table (equal/loop/index/live variables), so a staged deck can parameterize
a per-atom expression by stage.

The port's copy of ``lammps_le_tpu/deck/atomvars.py``: the State's tensors
are read to the host (``state.host``) where the reference reads its device
arrays with ``np.asarray``.
"""

from __future__ import annotations

import ast
import re
from typing import Callable, Dict

import numpy as np

from ..state import host

__all__ = ["AtomExpr", "ATOM_NAMES"]

# per-atom quantity -> (state, system) -> (N,) float array
ATOM_NAMES: Dict[str, Callable] = {
    "x": lambda st, sy: host(st.x)[:, 0],
    "y": lambda st, sy: host(st.x)[:, 1],
    "z": lambda st, sy: host(st.x)[:, 2],
    "xu": lambda st, sy: (host(st.x)[:, 0]
                          + host(st.img)[:, 0] * sy.box_size[0]),
    "yu": lambda st, sy: (host(st.x)[:, 1]
                          + host(st.img)[:, 1] * sy.box_size[1]),
    "zu": lambda st, sy: (host(st.x)[:, 2]
                          + host(st.img)[:, 2] * sy.box_size[2]),
    "vx": lambda st, sy: host(st.v)[:, 0],
    "vy": lambda st, sy: host(st.v)[:, 1],
    "vz": lambda st, sy: host(st.v)[:, 2],
    "fx": lambda st, sy: host(st.f)[:, 0],
    "fy": lambda st, sy: host(st.f)[:, 1],
    "fz": lambda st, sy: host(st.f)[:, 2],
    "id": lambda st, sy: np.arange(1, host(st.x).shape[0] + 1,
                                   dtype=np.float64),
    "type": lambda st, sy: host(st.type) + 1.0,
    "mol": lambda st, sy: np.asarray(sy.molecule) + 1.0,
}

_FUNCS = {
    "sqrt": np.sqrt, "abs": np.abs, "exp": np.exp, "log": np.log,
    "ln": np.log, "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "floor": np.floor, "ceil": np.ceil, "round": np.round,
}

_ALLOWED = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant,
            ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow, ast.Mod,
            ast.USub, ast.UAdd, ast.Name, ast.Call, ast.Load,
            ast.Compare, ast.Gt, ast.Lt, ast.GtE, ast.LtE, ast.Eq,
            ast.NotEq)


class AtomExpr:
    """A compiled atom-style variable.

    ``evaluate(state, system, scalars)`` -> (N,) float64 array.
    ``scalars`` maps OTHER variable names (from the script interpreter)
    to numeric values for ``v_other`` references; an atom-style v_ref
    recurses (cycles raise).
    """

    def __init__(self, name: str, expr: str):
        self.name = name
        self.text = expr
        src = expr.replace("^", "**")
        # v_name tokens become plain names the ast walk resolves later
        src = re.sub(r"v_(\w+)", r"__v_\1", src)
        try:
            self._tree = ast.parse(src, mode="eval")
        except SyntaxError as e:
            raise ValueError(
                f"atom variable {name!r}: cannot parse {expr!r}") from e
        for node in ast.walk(self._tree):
            if not isinstance(node, _ALLOWED):
                raise ValueError(
                    f"atom variable {name!r}: unsupported syntax "
                    f"{type(node).__name__} in {expr!r}")
            if isinstance(node, ast.Call):
                if (not isinstance(node.func, ast.Name)
                        or node.func.id not in _FUNCS):
                    raise ValueError(
                        f"atom variable {name!r}: unknown function")

    def evaluate(self, state, system, scalars=None, atom_vars=None,
                 _stack=()):
        if self.name in _stack:
            raise ValueError(
                f"atom variable {self.name!r}: circular v_ reference")
        env = dict(_FUNCS)
        for nm, fn in ATOM_NAMES.items():
            env[nm] = None  # lazy: filled below only if referenced
        needed = {n.id for n in ast.walk(self._tree)
                  if isinstance(n, ast.Name)}
        for nm in needed:
            if nm in ATOM_NAMES:
                env[nm] = ATOM_NAMES[nm](state, system).astype(np.float64)
            elif nm.startswith("__v_"):
                ref = nm[4:]
                if atom_vars and ref in atom_vars:
                    env[nm] = atom_vars[ref].evaluate(
                        state, system, scalars, atom_vars,
                        _stack + (self.name,))
                elif scalars and ref in scalars:
                    try:
                        env[nm] = float(str(scalars[ref]))
                    except ValueError:
                        raise ValueError(
                            f"atom variable {self.name!r}: v_{ref} is not "
                            f"numeric (value {str(scalars[ref])!r})"
                        ) from None
                else:
                    raise ValueError(
                        f"atom variable {self.name!r}: undefined "
                        f"variable v_{ref}")
            elif nm not in _FUNCS:
                raise ValueError(
                    f"atom variable {self.name!r}: unknown name {nm!r}")
        out = eval(compile(self._tree, "<atom-variable>", "eval"),
                   {"__builtins__": {}}, env)
        n = host(state.x).shape[0]
        return np.broadcast_to(np.asarray(out, np.float64), (n,)).copy()
