"""The port's observer library entry points (``lammps_le_torch.observe``:
``make_rdf_fn``, ``normalize_rdf``, ``make_contact_fn``,
``contact_map_accumulate``, ``pairs``) against the JAX package's on the
CPU, on one shared State: the 300-bead melt32 system of
``torch_parity.make_system`` in f64, its serpentine moved by a seeded
displacement, three extruders active.

The rdf within the pair grid's cell (on a cap-2 grid that drops beads,
and on the grid's own cap) and the contact map within the cell and past
it (a dedicated wide grid): counts bit for bit, flags equal (the rdf's
``FLAG_CELL_OVERFLOW`` on the cap-2 grid).  ``contact_map_accumulate``'s
retries past an overflow, ``normalize_rdf`` and the pair enumeration
(``enumerate_pairs``, ``special_weights``, ``lj_pair_values``): the
reference's arrays.  The reference's jitted observers compile with
LLVM's optimisations off (the same results, less compile time).  The
deck's observer commands are in ``test_torch_observe.py``."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity as tp
from lammps_le_torch.state import FLAG_CELL_OVERFLOW, state_from_arrays

N = 300
EXTRUDERS = ((10, 14), (57, 62), (150, 156))


@functools.lru_cache(maxsize=None)
def shared():
    """(system, reference State, port State): both from the same arrays."""
    system, data = tp.make_system(N, "float64")
    rng = np.random.default_rng(4)
    left = np.full(system.max_extruders, -1, np.int64)
    right = left.copy()
    for k, (a, b) in enumerate(EXTRUDERS):
        left[k], right[k] = a, b
    d = {"x": data.x + rng.normal(scale=0.05, size=(N, 3)),
         "v": rng.normal(size=(N, 3)), "f": np.zeros((N, 3)),
         "img": np.zeros((N, 3), np.int64),
         "type": np.asarray(data.types, np.int64),
         "ex_left": left, "ex_right": right,
         "key": np.array([0, 7], np.uint32), "step": np.zeros((), np.int64),
         "flags": np.zeros((), np.int64), "epair": np.zeros(()),
         "ebond": np.zeros(()), "n_moves": np.zeros((), np.int64),
         "n_loads": np.zeros((), np.int64),
         "n_unloads": np.zeros((), np.int64),
         "last_event": np.zeros(3, np.int64)}
    js = tp.jax_state(d, jnp.float64)
    return system, js, state_from_arrays(tp.arrays_of(js), "cpu")


def _ref(module, make, *args):
    """``module.make(*args)`` built with the module's jit at LLVM opt 0."""
    saved = module.jax
    module.jax = tp.UnoptimisedJax()
    try:
        return getattr(module, make)(*args)
    finally:
        module.jax = saved


@pytest.mark.parametrize("cap", [None, 2], ids=["within", "overflow"])
def test_make_rdf_fn_counts_bitwise(cap):
    """make_rdf_fn within the pair grid's cell (its default rmax, 16
    bins), summed onto a nonzero histogram: the reference's counts bit
    for bit and its flags; on a cap-2 grid both drop beads and flag
    FLAG_CELL_OVERFLOW."""
    import lammps_le_tpu.observe.rdf as jr
    from lammps_le_torch.observe import make_rdf_fn

    system, js, ts = shared()
    if cap:
        system = system.with_neighbor(cell_cap=cap)
    h0 = np.arange(16, dtype=np.float32)
    fn = _ref(jr, "make_rdf_fn", system, 16)
    want, wfl = fn(js, jnp.asarray(h0))
    got, gfl = make_rdf_fn(system, 16)(ts, torch.as_tensor(h0))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gfl) == int(wfl) == (FLAG_CELL_OVERFLOW if cap else 0)
    assert float(got.sum()) > h0.sum()


def test_normalize_rdf_matches_reference():
    from lammps_le_torch.observe import normalize_rdf
    from lammps_le_tpu.observe.rdf import normalize_rdf as ref

    system, _, _ = shared()
    h = np.random.default_rng(0).integers(0, 50, 12).astype(np.float32)
    for want, got in zip(ref(h, system, 3, 12, 2.0),
                         normalize_rdf(torch.as_tensor(h), system, 3, 12,
                                       2.0)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [1.12, 2.0], ids=["within", "wide"])
def test_make_contact_fn_counts_bitwise(radius):
    """make_contact_fn's (nbins, nbins) map, summed onto a map of ones,
    and its flags: bit for bit; symmetric."""
    import lammps_le_tpu.observe.contact_map as jc
    from lammps_le_torch.observe import make_contact_fn

    system, js, ts = shared()
    want, wfl = _ref(jc, "make_contact_fn", system, radius, 20)(
        js, jnp.ones((20, 20), jnp.float32))
    got, gfl = make_contact_fn(system, radius, 20)(
        ts, torch.ones((20, 20), dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gfl) == int(wfl) == 0
    assert float(got.sum()) > 400 and torch.equal(got, got.T)


def test_contact_map_accumulate_retries_past_overflow():
    """contact_map_accumulate on a cap-1 grid: the overflowing first try
    is retried with a larger cap until no bead drops, and the map equals
    a direct call at a cap that fits."""
    from lammps_le_torch.observe import (contact_map_accumulate,
                                         make_contact_fn)

    system, _, ts = shared()
    tight = system.with_neighbor(cell_cap=1)
    _, fl = make_contact_fn(tight, 1.12, 16)(
        ts, torch.zeros((16, 16), dtype=torch.float32))
    assert int(fl) == FLAG_CELL_OVERFLOW
    got = contact_map_accumulate(ts, tight, radius=1.12, nbins=16)
    want, fl = make_contact_fn(system.with_neighbor(cell_cap=16), 1.12, 16)(
        ts, torch.zeros((16, 16), dtype=torch.float32))
    assert int(fl) == 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_pairs_match_reference():
    """enumerate_pairs, special_weights (with the State's extruders) and
    lj_pair_values: the reference's arrays, in its order."""
    from lammps_le_torch.observe import pairs as tpairs
    from lammps_le_tpu.observe import pairs as jpairs

    system, js, ts = shared()
    x = ts.x.numpy()
    box = np.asarray(system.box_size)
    want = jpairs.enumerate_pairs(x, box, 1.5)
    got = tpairs.enumerate_pairs(x, box, 1.5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    i, j, dist = got
    w = tpairs.special_weights(system, ts, i, j)
    np.testing.assert_array_equal(w, jpairs.special_weights(system, js, i,
                                                            j))
    assert (w == 0.0).sum() >= len(EXTRUDERS)
    types = ts.type.numpy()
    for a, b in zip(jpairs.lj_pair_values(system, types, i, j, dist),
                    tpairs.lj_pair_values(system, types, i, j, dist)):
        np.testing.assert_array_equal(b, a)
