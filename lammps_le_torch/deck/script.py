"""Execution-time script interpreter: control flow for input decks.

The parse-everything-upfront Deck (parser.py) cannot express loops — the
reference interpreter executes line by line with jumps (reference:
src/input.cpp:181-773; jump/label/next/if/include/print dispatched at
689-773, ``$var`` substitution re-applied per execution at 508).  This
module adds that layer: staged multi-run LE decks
(equilibrate -> load -> produce, looped over stages) execute as in the
reference.

Supported control constructs:
  label NAME                     (input.cpp label)
  jump SELF|file [NAME]          (skipped when the preceding `next`
                                  exhausted a variable, matching the
                                  reference's loop idiom)
  next var [var2 ...]            (advance index/loop variables)
  variable N loop N1 [N2] / index v1 v2 ... / equal expr / string s /
  variable N delete
  if "cond" then "cmd" ... [else "cmd" ...]
  include file
  print "text"
  run N upto                     (run.cpp upto keyword)

Variables are re-substituted at execution time, so `$i` changes across
loop iterations.  Equal-style variables are evaluated at definition time
(arithmetic subset — variable.cpp's thermo references are out of scope).
"""

from __future__ import annotations

import ast
import os
import re
import shlex
from typing import List, Optional

from .parser import _eval_expr, substitute


class ScriptError(RuntimeError):
    pass


# thermo keywords equal-style variables may reference live
# (reference: src/variable.cpp evaluate() dispatches these to Thermo)
_LIVE_KEYS = ("temp", "press", "pe", "ke", "epair", "ebond", "emol",
              "etotal", "step", "vol", "density", "extruders", "atoms")
_LIVE_RE = re.compile(
    r"\b(" + "|".join(_LIVE_KEYS) + r")\b|\bc_\w+|\bf_\w+\[[12]\]"
)


class LiveExpr:
    """An equal-style variable that references live thermo/compute state.

    Evaluated at USE time against the runner (reference:
    src/variable.cpp:5223 — equal variables are re-evaluated on every
    access, which is how staged decks gate on ``temp``/``press``/counters).
    ``__str__`` triggers evaluation so plain ``$x`` substitution works.
    """

    def __init__(self, expr: str, interp: "ScriptInterpreter"):
        self.expr = expr
        self.interp = interp

    def eval(self):
        text = self.expr
        # v_name references first (may recurse through other LiveExprs)
        text = re.sub(
            r"v_(\w+)", lambda m: str(self.interp.vars[m.group(1)]), text
        )
        text = _LIVE_RE.sub(
            lambda m: repr(self.interp.runner.live_value(m.group(0))), text
        )
        val = _eval_expr(text, self.interp.vars)
        if isinstance(val, str):
            # _eval_expr keeps bare literals as text; a live expression
            # must still come out numeric
            try:
                val = float(val)
            except ValueError:
                raise ScriptError(
                    f"cannot evaluate live variable expression "
                    f"{self.expr!r}") from None
            if val.is_integer():
                val = int(val)
        return val

    def __str__(self):
        v = self.eval()
        if isinstance(v, float) and v.is_integer():
            return str(int(v))
        return str(v)


def logical_lines(text: str) -> List[str]:
    """Join '&' continuations (input.cpp:231)."""
    lines: List[str] = []
    pending = ""
    for raw in text.splitlines():
        line = raw.rstrip()
        if line.endswith("&"):
            pending += line[:-1] + " "
            continue
        lines.append(pending + line)
        pending = ""
    if pending:
        lines.append(pending)
    return lines


def eval_condition(text: str, variables: dict):
    """Boolean condition evaluator for `if` (reference: input.cpp if_).

    Supports comparisons, && || !, arithmetic, numbers and bare words
    (compared as strings).
    """
    expr = text.replace("&&", " and ").replace("||", " or ")
    expr = re.sub(r"!(?!=)", " not ", expr)
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as e:
        raise ScriptError(f"cannot parse if-condition {text!r}") from e
    allowed = (ast.Expression, ast.Compare, ast.BoolOp, ast.And, ast.Or,
               ast.UnaryOp, ast.Not, ast.USub, ast.UAdd, ast.BinOp,
               ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow, ast.Mod,
               ast.Constant, ast.Name, ast.Load,
               ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE)
    names = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names[node.id] = node.id  # bare words compare as strings
        elif not isinstance(node, allowed):
            raise ScriptError(f"unsupported construct in condition {text!r}")
    return bool(eval(compile(tree, "<if>", "eval"),
                     {"__builtins__": {}}, names))


class ScriptInterpreter:
    """Line-at-a-time deck execution against a DeckRunner."""

    def __init__(self, runner, variables: Optional[dict] = None):
        self.runner = runner
        self.vars = dict(variables or {})
        # thermo_style custom v_name columns resolve through this table
        # (thermo.cpp parse_fields' v_ case -> input->variable)
        runner.script_vars = self.vars
        self._lists: dict = {}        # index/loop variable state
        self._skip_next_jump = False

    # -- variables ------------------------------------------------------
    def _variable(self, args: List[str]):
        if len(args) >= 2 and args[1] == "delete":
            self.vars.pop(args[0], None)
            self._lists.pop(args[0], None)
            return
        if len(args) < 3:
            raise ScriptError(f"malformed variable command: {args}")
        name, style = args[0], args[1]
        if name in self._lists:
            # reference: re-declaring an in-progress index/loop variable
            # is a no-op so loops re-entered via jump keep their position
            return
        if style in ("index", "loop") and name in self.vars:
            # -var command-line definitions take precedence: an index/
            # loop declaration for an existing variable is skipped
            # (variable.cpp:160-170 — how in.chain.scaled's defaults are
            # overridden by -var x 2)
            return
        if style == "equal":
            expr = " ".join(args[2:])
            if _LIVE_RE.search(expr):
                # live references: defer evaluation to each use
                self.vars[name] = LiveExpr(expr, self)
            else:
                self.vars[name] = _eval_expr(expr, self.vars)
        elif style == "atom":
            # per-atom expression, evaluated lazily by consumers
            # (dump custom v_name columns; src/variable.cpp ATOM style)
            from .atomvars import AtomExpr

            self.runner.atom_vars[name] = AtomExpr(name, " ".join(args[2:]))
            self.runner.atom_var_scalars = self.vars
        elif style == "string":
            self.vars[name] = args[2]
        elif style == "index":
            self._lists[name] = (list(args[2:]), 0)
            self.vars[name] = args[2]
        elif style == "loop":
            if len(args) >= 4 and args[3].isdigit():
                lo, hi = int(args[2]), int(args[3])
            else:
                lo, hi = 1, int(args[2])
            vals = [str(v) for v in range(lo, hi + 1)]
            self._lists[name] = (vals, 0)
            self.vars[name] = vals[0]
        else:
            raise ScriptError(f"unsupported variable style {style!r}")

    def _next(self, names: List[str]):
        for name in names:
            if name not in self._lists:
                raise ScriptError(f"next on non-loop variable {name!r}")
            vals, pos = self._lists[name]
            pos += 1
            if pos >= len(vals):
                # exhausted: delete + skip the next jump (input.cpp next_)
                del self._lists[name]
                self.vars.pop(name, None)
                self._skip_next_jump = True
            else:
                self._lists[name] = (vals, pos)
                self.vars[name] = vals[pos]

    # -- control flow ---------------------------------------------------
    def _find_label(self, lines: List[str], label: str) -> int:
        for i, line in enumerate(lines):
            parts = line.split()
            if len(parts) >= 2 and parts[0] == "label" and parts[1] == label:
                return i
        raise ScriptError(f"label {label!r} not found")

    def _if(self, args: List[str], lines=None, path: str = "SELF"):
        if "then" not in args:
            raise ScriptError("if without then")
        ti = args.index("then")
        cond = " ".join(args[:ti])
        rest = args[ti + 1:]
        if "else" in rest:
            ei = rest.index("else")
            then_cmds, else_cmds = rest[:ei], rest[ei + 1:]
        else:
            then_cmds, else_cmds = rest, []
        chosen = then_cmds if eval_condition(cond, self.vars) else else_cmds
        for cmd in chosen:
            # a jump inside then/else transfers control (input.cpp if_
            # dispatches through the same command loop); remaining branch
            # commands are abandoned like the reference's
            jump = self.one(cmd, lines=lines, path=path)
            if jump is not None:
                return jump
        return None

    def _expand_inline_eval(self, line: str) -> str:
        """``$(expr)`` immediate equal-style evaluation (input.cpp:508
        `$(...)` branch): evaluated against live thermo state at execution
        time, e.g. ``if "$(temp) > 1.1" then ...``."""
        out = []
        i = 0
        while i < len(line):
            if line[i] == "$" and i + 1 < len(line) and line[i + 1] == "(":
                depth = 1
                j = i + 2
                while j < len(line) and depth:
                    if line[j] == "(":
                        depth += 1
                    elif line[j] == ")":
                        depth -= 1
                    j += 1
                if depth:
                    raise ScriptError(f"unbalanced $() in {line!r}")
                out.append(str(LiveExpr(line[i + 2:j - 1], self)))
                i = j
            else:
                out.append(line[i])
                i += 1
        return "".join(out)

    # -- execution ------------------------------------------------------
    def run_file(self, path: str):
        path = os.path.abspath(path)
        self.runner.root = os.path.dirname(path) or "."
        with open(path) as fh:
            self.execute_lines(logical_lines(fh.read()), path)

    def execute_lines(self, lines: List[str], path: str = "SELF",
                      pc0: int = 0):
        pc = pc0
        while pc < len(lines):
            line = lines[pc]
            pc += 1
            jump = self.one(line, lines=lines, path=path)
            if jump is not None:
                new_lines, new_pc, new_path = jump
                if new_lines is not lines:
                    # jump into another file: recurse with the FULL line
                    # list and the target's own path, so labels before the
                    # jump target stay findable and a later `jump <that
                    # file>` is recognized as SELF
                    self.execute_lines(new_lines, new_path, pc0=new_pc)
                    return
                pc = new_pc
        if self._skip_next_jump:
            # an exhausted `next` at end of script with no jump following
            self._skip_next_jump = False

    def one(self, line: str, lines=None, path: str = "SELF"):
        """Execute one logical line; returns (lines, pc, path) on jump."""
        h = line.find("#")
        if h >= 0:
            line = line[:h]
        line = line.strip()
        if not line:
            return None
        line = self._expand_inline_eval(line)
        line = substitute(line, self.vars)
        parts = shlex.split(line)
        if not parts:
            return None
        name, args = parts[0], parts[1:]

        if name == "label":
            return None
        if name == "print":
            self.runner.log(" ".join(args))
            return None
        if name == "variable":
            self._variable(args)
            return None
        if name == "next":
            self._next(args)
            return None
        if name == "if":
            return self._if(args, lines=lines, path=path)
        if name == "include":
            sub = os.path.join(self.runner.root, args[0])
            with open(sub) as fh:
                self.execute_lines(logical_lines(fh.read()), sub)
            return None
        if name == "jump":
            if self._skip_next_jump:
                self._skip_next_jump = False
                return None
            target, label = args[0], args[1] if len(args) > 1 else None
            if target == "SELF" or (
                path != "SELF" and os.path.basename(path) == target
            ):
                tlines, tpath = lines, path
                if tlines is None:
                    raise ScriptError("jump SELF outside a script")
            else:
                tpath = os.path.join(self.runner.root, target)
                with open(tpath) as fh:
                    tlines = logical_lines(fh.read())
            idx = self._find_label(tlines, label) if label else 0
            return (tlines, idx, tpath)
        if name == "run" and len(args) >= 2 and args[1] == "upto":
            cur = self.runner.timestep0
            if self.runner.state is not None:
                cur = int(self.runner.state.step)
            n = max(0, int(args[0]) - cur)
            if n:
                self.runner.command("run", [str(n)], raw=line)
            return None

        self.runner.command(name, args, raw=line)
        return None
