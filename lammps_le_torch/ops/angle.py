"""Chain bending angles, harmonic and cosine (``lammps_le_tpu.ops.angle``).

angle_harmonic.cpp:60-140 (E = K (theta - theta0)^2) and
angle_cosine.cpp:60-130 (E = K (1 + cos theta)) with the reference's
a11/a12/a22 force split.  Chains are contiguous, so every triplet is
(i-1, i, i+1), typed at its centre bead (``System.angle_center_type``),
and the pass is three shifted adds.
"""

from __future__ import annotations

import torch

from ..system import ANGLE_HARMONIC, System
from .cells import minimum_image, system_const

_SMALL = 0.001  # sin floor, angle_harmonic.cpp SMALL


def chain_angle_force(x: torch.Tensor, system: System, energy: bool = True):
    """(force (N, 3), angle energy ()) of all chain angles (angle.py:28)."""
    dtype = x.dtype
    dev = x.device
    ct = system_const(system, "angle_center_type",
                      lambda: system.angle_center_type, torch.int64, dev)
    styles = system_const(system, "angle_style", lambda: system.angles.style,
                          torch.int64, dev)
    coeffs = system_const(system, "angle_coeffs",
                          lambda: system.angles.coeffs, dtype, dev)
    ends_ok = system_const(
        system, "angle_ends_ok",
        lambda: (system.prev_bead >= 0) & (system.next_bead >= 0),
        torch.bool, dev)
    valid = (ct >= 0) & ends_ok
    w = valid.to(dtype)[:, None]

    box = system.box_size
    x_prev = torch.cat([x[:1], x[:-1]])
    x_next = torch.cat([x[1:], x[-1:]])
    del1 = minimum_image(x_prev - x, box)
    del2 = minimum_image(x_next - x, box)
    rsq1 = torch.clamp(torch.sum(del1 * del1, dim=1), min=1e-12)
    rsq2 = torch.clamp(torch.sum(del2 * del2, dim=1), min=1e-12)
    r1 = torch.sqrt(rsq1)
    r2 = torch.sqrt(rsq2)
    c = torch.sum(del1 * del2, dim=1) / (r1 * r2)
    c = torch.clamp(c, -1.0, 1.0)

    t = torch.clamp(ct, 0, coeffs.shape[0] - 1)
    k = coeffs[t, 0]
    style = styles[t]

    # harmonic
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    s = torch.clamp(s, min=_SMALL)
    dtheta = torch.arccos(c) - coeffs[t, 1]
    tk = k * dtheta
    a_h = -2.0 * tk / s
    e_h = tk * dtheta
    # cosine
    a_c = k
    e_c = k * (1.0 + c)

    is_h = style == ANGLE_HARMONIC
    a = torch.where(is_h, a_h, a_c)
    e = torch.where(is_h, e_h, e_c)

    a11 = (a * c / rsq1)[:, None]
    a12 = (-a / (r1 * r2))[:, None]
    a22 = (a * c / rsq2)[:, None]
    f1 = (a11 * del1 + a12 * del2) * w   # on bead i-1
    f3 = (a22 * del2 + a12 * del1) * w   # on bead i+1

    f = -(f1 + f3)                       # the centre bead
    f[:-1] += f1[1:]
    f[1:] += f3[:-1]
    if not energy:
        return f, x.new_zeros(())
    return f, torch.sum(torch.where(valid, e, 0.0))
