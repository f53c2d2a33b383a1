"""The port's LE event fixes give bitwise the reference's extruder tables,
types, counters and flags for the same positions and key
(fixes/extrusion.py, ex_load.py, ex_unload.py; the scatter-min election
as scatter_reduce amin; draws from lammps_le_torch.rng)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lammps_le_tpu.fixes as jf
import lammps_le_torch.fixes as tf
from lammps_le_torch.fixes.ex_load import make_ex_load_update
from lammps_le_torch.fixes.ex_unload import make_ex_unload_update
from lammps_le_torch.fixes.extrusion import make_extrusion_update
from lammps_le_torch.state import extruder_partner
from lammps_le_tpu.fixes.ex_load import make_ex_load_update as ref_load
from lammps_le_tpu.fixes.ex_unload import make_ex_unload_update as ref_unload
from lammps_le_tpu.fixes.extrusion import make_extrusion_update as ref_ext
from lammps_le_tpu.state import extruder_partner as ref_partner
from torch_parity import melt_arrays

KEYS = [(11, 1001), (11, 2003), (5, 7), (904297, 12)]


def _table(system, sites, pairs=()):
    e = system.max_extruders
    left = np.full(e, -1, np.int64)
    right = np.full(e, -1, np.int64)
    k = 0
    for s in sites:
        left[k], right[k] = s, s + 2
        k += 1
    for a, b in pairs:
        left[k], right[k] = a, b
        k += 1
    return left, right


def _case(sites=(3, 83, 163, 243, 323, 403), pairs=((10, 12), (14, 16))):
    """melt32 positions and types with an extruder table in which two
    extruders compete for bead 13."""
    system, d = melt_arrays()
    left, right = _table(system, sites, pairs)
    types = d["type"].copy()
    types[[9, 17, 82, 86]] = [1, 2, 3, 1]   # barriers next to anchors
    return system, d["x"], types, left, right


def _keys(seed, data):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    return key, tuple(int(w) for w in np.asarray(key))


def _occ(system, left, right):
    want = ref_partner(
        type("S", (), {"ex_left": jnp.asarray(left, jnp.int32),
                       "ex_right": jnp.asarray(right, jnp.int32)})(),
        system.n)
    got = extruder_partner(torch.tensor(left), torch.tensor(right), system.n)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    return np.asarray(want) >= 0


@pytest.mark.parametrize("seed,data", KEYS)
@pytest.mark.parametrize("release_r", [0.0, 1.95])
def test_extrusion_update_bitwise(seed, data, release_r):
    system, x, types, left, right = _case()
    fix = tf.Extrusion(nevery=5, neutral_type=1, ctcf_left=2, ctcf_right=3,
                       through_prob=0.5, btype=2, ctcf_left_right=4,
                       release_r=release_r)
    rfix = jf.Extrusion(**{k: getattr(fix, k) for k in (
        "nevery", "neutral_type", "ctcf_left", "ctcf_right", "through_prob",
        "btype", "ctcf_left_right", "release_r")})
    occ = _occ(system, left, right)
    key, words = _keys(seed, data)
    want = ref_ext(system, rfix)(
        jnp.asarray(x), jnp.asarray(types, jnp.int32),
        jnp.asarray(left, jnp.int32), jnp.asarray(right, jnp.int32),
        jnp.asarray(occ), key)
    got = make_extrusion_update(system, fix, "cpu")(
        torch.tensor(x), torch.tensor(types), torch.tensor(left),
        torch.tensor(right), torch.tensor(occ), words)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert int(got[2]) > 0
    if release_r:
        assert int(got[3]) > 0


@pytest.mark.parametrize("seed,data", KEYS)
@pytest.mark.parametrize("itype,jtype,fraction,cutoff", [
    (1, 1, 0.5, 2.5), (1, 2, 1.0, 2.5), (1, 1, 0.05, 1.12)])
def test_ex_load_update_bitwise(seed, data, itype, jtype, fraction, cutoff):
    system, x, types, left, right = _case()
    kw = dict(nevery=7, iatomtype=itype, jatomtype=jtype, cutoff=cutoff,
              btype=2, fraction=fraction, seed=684474, imaxbond=1,
              inewtype=2, jmaxbond=1, jnewtype=3)
    occ = _occ(system, left, right)
    key, words = _keys(seed, data)
    want = ref_load(system, jf.ExLoad(**kw))(
        jnp.asarray(x), jnp.asarray(types, jnp.int32),
        jnp.asarray(left, jnp.int32), jnp.asarray(right, jnp.int32),
        jnp.asarray(occ), key)
    got = make_ex_load_update(system, tf.ExLoad(**kw), "cpu")(
        torch.tensor(x), torch.tensor(types), torch.tensor(left),
        torch.tensor(right), torch.tensor(occ), words)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    if cutoff > 2 and itype == jtype:
        # more winners than the 8 free table slots: overflow flagged
        assert int(got[3]) == 8 and int(got[4]) == 16


@pytest.mark.parametrize("seed,data", KEYS)
@pytest.mark.parametrize("fraction", [0.5, 1.0])
def test_ex_unload_update_bitwise(seed, data, fraction):
    system, x, _, left, right = _case()
    kw = dict(nevery=7, btype=2, cutoff=0.5, fraction=fraction,
              seed=456456)
    key, words = _keys(seed, data)
    want = ref_unload(system, jf.ExUnload(**kw))(
        jnp.asarray(x), jnp.asarray(left, jnp.int32),
        jnp.asarray(right, jnp.int32), key)
    got = make_ex_unload_update(system, tf.ExUnload(**kw), "cpu")(
        torch.tensor(x), torch.tensor(left), torch.tensor(right), words)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    if fraction == 1.0:
        assert int(got[2]) == 8  # every (i, i+2) spring is longer than 0.5
