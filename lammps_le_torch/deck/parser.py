"""Input-deck parser: the LAMMPS-command front end.

Replaces the reference's script interpreter (reference: src/input.cpp:181-773
— line parsing, ``$var`` substitution, command dispatch) for the command
subset the loop-extrusion workflow uses, so existing decks (bench/in.chain,
README.md:22-40) map over 1:1.  Commands are parsed into a declarative
:class:`Deck`; :class:`lammps_le_torch.deck.runner.DeckRunner` executes them.

Supported commands: units, atom_style, boundary, special_bonds, read_data,
neighbor, neigh_modify, bond_style, bond_coeff, pair_style, pair_modify,
pair_coeff, mass, velocity, group, fix (nve / langevin / extrusion /
ex_load / ex_unload), unfix, timestep, thermo, thermo_style, dump, run,
write_data, write_restart, read_restart, variable, log, comm_modify (no-op),
reset_timestep, seed control via variables.
"""

from __future__ import annotations

import dataclasses
import shlex
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Command:
    name: str
    args: List[str]
    raw: str


@dataclasses.dataclass
class Deck:
    commands: List[Command]


def substitute(line: str, variables: dict) -> str:
    """``$x`` / ``${name}`` substitution (reference: input.cpp:508)."""
    out = []
    i = 0
    while i < len(line):
        c = line[i]
        if c == "$" and i + 1 < len(line):
            nxt = line[i + 1]
            if nxt == "{":
                j = line.index("}", i + 2)
                name = line[i + 2 : j]
                out.append(str(variables[name]))
                i = j + 1
                continue
            else:
                out.append(str(variables[nxt]))
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def parse_deck(text: str, variables: Optional[dict] = None) -> Deck:
    variables = dict(variables or {})
    cmds: List[Command] = []
    pending = ""
    for rawline in text.splitlines():
        line = rawline.rstrip("\n")
        # line continuation
        if line.endswith("&"):
            pending += line[:-1] + " "
            continue
        line = pending + line
        pending = ""
        # strip comments (outside quotes — decks here don't quote '#')
        hash_pos = line.find("#")
        if hash_pos >= 0:
            line = line[:hash_pos]
        line = line.strip()
        if not line:
            continue
        # variable definition handled at parse time for $-substitution
        parts = shlex.split(substitute(line, variables))
        if not parts:
            continue
        name, args = parts[0], parts[1:]
        if name == "variable" and len(args) >= 3 and args[1] in ("equal", "string", "index"):
            value = " ".join(args[2:])
            if args[1] == "equal":
                value = _eval_expr(value, variables)
            variables[args[0]] = value
            continue
        cmds.append(Command(name=name, args=args, raw=line))
    return Deck(commands=cmds)


def _math_funcs():
    """Math functions of equal-style variables (src/variable.cpp
    math_function(): note the reference's log() is log10 and ln() is
    natural log)."""
    import math

    return {
        "sqrt": math.sqrt, "exp": math.exp, "ln": math.log,
        "log": math.log10, "abs": abs, "sin": math.sin, "cos": math.cos,
        "tan": math.tan, "asin": math.asin, "acos": math.acos,
        "atan": math.atan, "atan2": math.atan2, "pow": math.pow,
        "floor": math.floor, "ceil": math.ceil, "round": round,
        "min": min, "max": max,
    }


def _eval_expr(text: str, variables: dict):
    """Arithmetic + math-function subset of equal-style variables
    (reference: src/variable.cpp:5223 expression language; this covers
    the arithmetic, v_name references, PI, and the pure math functions —
    thermo/compute/fix references are resolved live by deck.script).
    Supports + - * / ^ % ( ), numeric literals, v_name, and
    sqrt/exp/ln/log/abs/trig/atan2/pow/floor/ceil/round/min/max."""
    import ast
    import math
    import re as _re

    expr = _re.sub(r"v_(\w+)", lambda m: str(variables[m.group(1)]), text)
    expr = expr.replace("^", "**")
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError:
        return text  # not arithmetic: keep as string

    funcs = _math_funcs()
    allowed = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant,
               ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow, ast.USub,
               ast.UAdd, ast.Mod, ast.FloorDiv, ast.Call, ast.Name,
               ast.Load)
    for node in ast.walk(tree):
        if not isinstance(node, allowed):
            return text
        if isinstance(node, ast.Call):
            if (not isinstance(node.func, ast.Name)
                    or node.func.id not in funcs or node.keywords):
                return text
        if isinstance(node, ast.Name):
            if node.id != "PI" and node.id not in funcs:
                return text
    if isinstance(tree.body, ast.Constant):
        # a bare literal: keep the user's spelling ("1.0" stays "1.0",
        # matching the reference's textual substitution, input.cpp:508)
        return text
    value = eval(compile(tree, "<variable>", "eval"),
                 {"__builtins__": {}, "PI": math.pi, **funcs})
    if not isinstance(value, (int, float)):
        return text  # e.g. a bare function name
    if isinstance(value, float) and value.is_integer():
        return int(value)
    return value


def parse_file(path: str, variables: Optional[dict] = None) -> Deck:
    with open(path) as fh:
        return parse_deck(fh.read(), variables)
