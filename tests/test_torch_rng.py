"""lammps_le_torch.rng is bitwise the reference's random streams: the
Langevin threefry planes (engine._threefry2x32 / _uniform3) and the
jax.random calls the LE fixes make (PRNGKey, fold_in, split, uniform)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lammps_le_torch import rng
from lammps_le_tpu.fast.engine import _threefry2x32, _uniform3


def _words(key):
    return tuple(int(w) for w in np.asarray(key))


def test_threefry2x32_bitwise():
    r = np.random.default_rng(0)
    k0, k1 = (int(v) for v in r.integers(0, 2**32, 2, dtype=np.uint64))
    c0 = r.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    c1 = r.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    want = _threefry2x32(jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(c0),
                         jnp.asarray(c1))
    got = rng.threefry2x32(k0, k1, torch.tensor(c0.astype(np.int64)),
                           torch.tensor(c1.astype(np.int64)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())


@pytest.mark.parametrize("sstep", [0, 7, 123456, 2**30 + 5])
def test_uniform3_bitwise(sstep):
    bid = np.random.default_rng(sstep).integers(0, 100_000, (9, 640),
                                                dtype=np.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 4 << 20)
    want = _uniform3(key, jnp.asarray(bid), jnp.asarray(sstep, jnp.int32),
                     jnp.float32)
    got = rng.uniform3(_words(key), torch.tensor(bid), sstep, torch.float32)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", [0, 11, 904297, 2**31 - 1, 2**40 + 3])
def test_prng_key(seed):
    assert rng.prng_key(seed) == _words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", [0, 11, 456456])
def test_fold_in_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    words = rng.prng_key(seed)
    for data in [0, 1, 17, (1 << 20) + 2, (4 << 20), 684474, 2**32 - 1]:
        want = jax.random.fold_in(key, data)
        assert rng.fold_in(words, data) == _words(want), data
    # the LE event key schedule (engine.py:1211-1216)
    want = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        key, 703), (2 << 20) + 1), 684474)
    got = rng.fold_in(rng.fold_in(rng.fold_in(words, 703), (2 << 20) + 1),
                      684474)
    assert got == _words(want)


@pytest.mark.parametrize("seed", [1, 5, 99])
def test_split_bitwise(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 12)
    for num in (2, 3):
        want = [_words(k) for k in jax.random.split(key, num)]
        assert rng.split(_words(key), num) == want


@pytest.mark.parametrize("size", [1, 2, 7, 16, 1024, 5001])
def test_uniform_bitwise(size):
    for seed in (0, 42):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), size)
        want = jax.random.uniform(key, (size,), jnp.float32)
        got = rng.uniform(_words(key), size, "cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
