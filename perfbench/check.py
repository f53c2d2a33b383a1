"""What decides ``correct``: the program's own steps followed by the plain
reference, and bench.py's health rule.

The dynamics are chaotic, so the reference follows the program step by
step from the program's own state.  After the window the program goes
on, a segment at a time, and the harness keeps a copy of its state at
the first segment boundary before each kind of LE event (``Plan``); the
program replays each copy through the window's own entry for
``check_steps`` steps, and the reference, given the copy in bead layout,
makes the same steps.  Compared, as the
largest over copies and replicas:

* ``x_gap``: positions (unwrapped, x + img * box), in sigma;
* ``v_gap``: velocities, in sigma / tau;
* ``f_gap``: forces (conservative + Langevin), over the reference's
  largest force;
* ``le_gap``: the LE events, in sigma: the largest distance between
  where the program and the reference put an extruder's anchor; an
  extruder active on one side only, a bead type or an event count that
  differs reads as the box's shortest edge.

Placement is judged through these: a bead binned into a wrong cell loses
its pairs (forces), one at a wrong slot reads another's position.  The
health rule (bench.py:602-610) is read on the window's final state: no
error-class flag, FENE clamps <= 20 a move, 0.5 < T < 2.0.
"""

from __future__ import annotations

import math
import sys

import torch

from .reference import step as ref_step

FLAG_FENE_CLAMP = 8


class Plan:
    """Which segment boundaries to copy: the first before each LE event
    kind (a boundary s whose next ``check_steps`` steps hold a step of
    that kind)."""

    def __init__(self, cfg: dict, check_steps: int):
        self.kinds = {kind: (fix["nevery"], fix["phase"])
                      for kind, fix in cfg["events"]}
        self.k = check_steps
        self.snaps = []      # (boundary step, kinds, program copy)
        self.missing = set(self.kinds)

    def wants(self, s: int) -> set:
        return {kind for kind in self.missing
                if any((t % nev) == ph for nev, ph in [self.kinds[kind]]
                       for t in range(s + 1, s + self.k + 1))}

    def offer(self, s: int, copy_fn):
        kinds = self.wants(s)
        if kinds:
            self.snaps.append((s, sorted(kinds), copy_fn()))
            self.missing -= kinds


def complete(plan: Plan, driver, work: dict):
    """After the window: drive the program on, a segment at a time, to the
    first boundary before each kind of event (at most one period of the
    slowest event); stop where its step does not advance."""
    limit = driver.step + max(nev for nev, _ in plan.kinds.values()) \
        + work["segment_steps"]
    while plan.missing and driver.step <= limit:
        plan.offer(driver.step, driver.snapshot)
        if plan.missing:
            before = driver.step
            driver.advance(work["segment_steps"])
            if driver.step == before:
                break


def on_host(d: dict) -> dict:
    """A bead-layout dict with its tensors copied to the host."""
    return {k: (v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in d.items()}


def program_side(driver, plan: Plan) -> list:
    """Replay each copy ``plan.k`` steps through the window's entry.
    Returns [(start beads, end beads)] per copy and replica, on the
    host."""
    out = []
    for _, _, snap in plan.snaps:
        start = [on_host(b) for b in driver.beads(snap)]
        end = driver.advance(plan.k, state=driver.snapshot(snap))
        out += list(zip(start, [on_host(b) for b in driver.beads(end)]))
    return out


def reference_state(b: dict, params: dict, dtype, device) -> dict:
    """The program's state in bead layout as the reference's: positions
    unwrapped."""
    box = params["box"].to(device=device, dtype=torch.float64)
    x = b["x"].to(device=device, dtype=torch.float64) \
        + b["img"].to(device=device, dtype=torch.float64) * box
    t = dict(device=device, dtype=dtype)
    return {
        "x": x.to(**t), "v": b["v"].to(**t), "f": b["f"].to(**t),
        "types": b["types"].to(device), "ex_left": b["ex_left"].to(device),
        "ex_right": b["ex_right"].to(device), "key_words": b["key_words"],
        "step": b["step"], "flags": 0, "n_moves": b["n_moves"],
        "n_loads": b["n_loads"], "n_unloads": b["n_unloads"], "clamps": 0,
    }


def on(params: dict, dtype, device) -> dict:
    """The reference's parameters with its tensors on ``device`` and its
    floats of ``dtype``."""
    p = dict(params)
    p["lo"] = params["lo"].to(device=device, dtype=dtype)
    p["box"] = params["box"].to(device=device, dtype=dtype)
    p["chain"] = tuple(c.to(device) for c in params["chain"])
    return p


def gaps(end: dict, ref: dict, params: dict) -> dict:
    """The compared numbers of one replayed copy against the reference."""
    dev = ref["x"].device
    box = params["box"].to(device=dev, dtype=torch.float64)
    xp = end["x"].to(dev, torch.float64) + end["img"].to(
        dev, torch.float64) * box
    xr = ref["x"].to(torch.float64)
    fr = ref["f"].to(torch.float64)
    fscale = float(fr.abs().max())
    out = {
        "x_gap": float((xp - xr).abs().max()),
        "v_gap": float((end["v"].to(dev, torch.float64)
                        - ref["v"].to(torch.float64)).abs().max()),
        "f_gap": float((end["f"].to(dev, torch.float64) - fr).abs().max())
        / fscale,
        "le_gap": le_gap(end, ref, xp, xr, box),
    }
    # a non-finite gap reads as the largest float: the result line stays
    # JSON, and the number fails any limit
    return {k: (v if math.isfinite(v) else sys.float_info.max)
            for k, v in out.items()}


def le_gap(end: dict, ref: dict, xp, xr, box) -> float:
    """The LE events' gap (see the module's docstring)."""
    dev = xr.device
    edge = float(box.min())
    gap = 0.0
    act_p = end["ex_left"].to(dev) >= 0
    act_r = ref["ex_left"] >= 0
    both = act_p & act_r
    for side in ("ex_left", "ex_right"):
        d = xp[end[side].to(dev)[both]] - xr[ref[side][both]]
        d = d - box * torch.round(d / box)
        if d.numel():
            gap = max(gap, float(torch.sqrt((d * d).sum(1)).max()))
    differs = bool((act_p != act_r).any()) \
        or bool((end["types"].to(dev) != ref["types"]).any()) \
        or any(end[k] != ref[k] for k in ("n_moves", "n_loads", "n_unloads"))
    return max(gap, edge) if differs else gap


def reference_side(pairs: list, params: dict, steps: int, device,
                   dtype=torch.float64) -> dict:
    """The reference's steps from each copy's start; the largest of each
    compared number over copies and replicas."""
    p = on(params, dtype, device)
    worst: dict = {}
    for start, end in pairs:
        st = reference_state(start, params, dtype, device)
        ref_step.follow(st, steps, p)
        for k, v in gaps(end, st, params).items():
            worst[k] = max(worst.get(k, 0), v)
    return worst


def control_side(pairs: list, params: dict, steps: int, device,
                 low=torch.bfloat16) -> dict:
    """The control's readings: the reference computed in ``low``, the
    precision below the configuration's float32, put in the program's
    place and judged as the program is, against the reference in
    float64, from each copy's start."""
    hi = on(params, torch.float64, device)
    lo = on(params, low, device)
    worst: dict = {}
    for start, _ in pairs:
        want = reference_state(start, params, torch.float64, device)
        ref_step.follow(want, steps, hi)
        got = reference_state(start, params, low, device)
        ref_step.follow(got, steps, lo)
        got["img"] = torch.zeros_like(got["ex_left"][:1]).expand(
            got["x"].shape)
        for k, v in gaps(got, want, params).items():
            worst[k] = max(worst.get(k, 0), v)
    return worst


def health(beads: list, cfg: dict) -> dict:
    """bench.py's rule on each replica of the final state: the largest
    error-class flags, the most clamps a move, the lowest and highest T."""
    h = cfg["health"]
    flags, per_move, temps = 0, 0.0, []
    for b in beads:
        flags |= b["flags"] & ~FLAG_FENE_CLAMP
        per_move = max(per_move, b["clamps"] / max(b["n_moves"], 1))
        v = b["v"].to(torch.float64)
        n = v.shape[0]
        temps.append(float((v * v).sum()) / (3.0 * n - 3.0))
    return {"error_flags": (flags, h["error_flags"]),
            "clamps_per_move": (per_move, h["clamps_per_move"]),
            "t_min": (min(temps), h["t_low"]),
            "t_max": (max(temps), h["t_high"])}


def verdict(compared: dict, limits: dict, healthy: dict, missing: int = 0):
    """(correct, [(name, value, limit, ok)]) in a fixed order; a kind of
    LE event the run never reached to check counts as ``missing_checks``."""
    rows = [("missing_checks", missing, 0, missing == 0)]
    for name in sorted(limits):
        lim = limits[name]
        rows.append((name, compared[name], lim, compared[name] <= lim))
    for name, (val, lim) in healthy.items():
        ok = val > lim if name == "t_min" else val <= lim
        rows.append((name, val, lim, ok))
    return all(r[3] for r in rows), rows
