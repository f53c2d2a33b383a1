"""One step of the deployment, written plainly, and the run that follows
the program's state step by step.

A step is velocity Verlet with a Langevin thermostat (``fix nve`` + ``fix
langevin``, LAMMPS's non-GJF form: drag -m v / damp and a uniform random
force sqrt(24 kT m / (damp dt)) (u - 1/2) a component), with the LE
events after the drift:

    v += dt/2 f / m;  x += dt v;  LE events due at this step;
    f = F(x) + drag + noise;  v += dt/2 f / m

Positions stay unwrapped (distances are minimum images), so the
program's wrap and image counters are judged by ``x + img * box``.  The
noise is the fast engine's counter-based stream, keyed by run key, step
and bead.  Every float is of the type the state is given in.
"""

from __future__ import annotations

import math

import torch

from . import events
from . import threefry as tf
from .forces import forces

LANGEVIN_KIND = 4


def noise(key_words, step: int, n: int, p: dict, dtype, device):
    """(N, 3) uniforms in [0, 1) of the step's stream: the run-constant
    key, counted by bead and step."""
    key = tf.fold_in(tf.fold_in(key_words, LANGEVIN_KIND << 20),
                     p["langevin_seed"])
    beads = torch.arange(n, device=device)
    return tf.counter_uniform3(key, beads, step, dtype)


def step(st: dict, p: dict) -> dict:
    """Advance the state ``st`` (a dict of tensors and ints) by one step,
    in place; returns it."""
    s = st["step"] + 1
    x, v, f = st["x"], st["v"], st["f"]
    dtype, dev = x.dtype, x.device
    n = x.shape[0]
    dt, m = p["dt"], p["mass"]
    half = 0.5 * dt / m
    v = v + half * f
    x = x + dt * v
    st["x"], st["step"] = x, s
    for kind, fix, index in p["fixes"]:
        if s % fix["nevery"] == fix["phase"]:
            key = events.event_key(st["key_words"], s, kind, index,
                                   fix["seed"])
            events.APPLY[kind](st, fix, p["chain"], p["box"], key)
    fc, clamps = forces(x, p["chain"][1], st["ex_left"], st["ex_right"],
                        p["forces"], p["lo"], p["box"])
    st["clamps"] += clamps
    gamma1 = -m / p["damp"]
    gamma2 = math.sqrt(24.0 * p["kT"] * m / (p["damp"] * dt))
    u = noise(st["key_words"], s, n, p, dtype, dev)
    fl = gamma1 * v + gamma2 * (u - 0.5)
    f = fc + fl
    v = v + half * f
    st["v"], st["f"] = v, f
    return st


def follow(st: dict, steps: int, p: dict) -> dict:
    """``steps`` steps from ``st``."""
    for _ in range(steps):
        step(st, p)
    return st
