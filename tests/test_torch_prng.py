"""The port's threefry random numbers against ``jax.random``, bit for bit.

The JAX package draws its random resets with ``jax.random.uniform`` on
keys split from ``jax.random.key(seed)``; ``transflow_tpu_torch.prng``
must give the same key data, the same splits and the same floats.
"""
import numpy as np
import pytest
import torch

import jax

from transflow_tpu_torch import prng

SEEDS = [0, 7, 99, 12345, 2 ** 31 - 1, 2 ** 32 - 1, -1]


def _data(key):
    return np.asarray(jax.random.key_data(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    got = prng.key(seed)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, _data(jax.random.key(seed)))


@pytest.mark.parametrize("n", [1, 2, 5, 64])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_split_matches_jax(seed, n):
    got = prng.split(prng.key(seed), n)
    assert got.dtype == np.uint32 and got.shape == (n, 2)
    np.testing.assert_array_equal(
        got, _data(jax.random.split(jax.random.key(seed), n)))


def test_split_defaults_to_two():
    np.testing.assert_array_equal(
        prng.split(prng.key(3)), _data(jax.random.split(jax.random.key(3))))


def test_key_chain_matches_jax():
    """The Engine's chain: ``key, sub = split(key)`` once per frame."""
    key, jkey = prng.key(11), jax.random.key(11)
    for _ in range(20):
        key, sub = prng.split(key)
        jkey, jsub = jax.random.split(jkey)
        np.testing.assert_array_equal(sub, _data(jsub))
    np.testing.assert_array_equal(key, _data(jkey))


@pytest.mark.parametrize("shape", [(1,), (3,), (5, 7), (33, 17), (24, 32),
                                   (4, 5, 6), (1080, 1920)], ids=str)
def test_uniform_matches_jax(shape):
    seed = 5 if shape != (1080, 1920) else 0
    sub = jax.random.split(jax.random.key(seed), 3)[2]
    got = prng.uniform(_data(sub), shape)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.uniform(sub, shape)))
    assert got.min() >= 0 and got.max() < 1


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_of_each_seed_matches_jax(seed):
    key = jax.random.key(seed)
    np.testing.assert_array_equal(
        prng.uniform(prng.key(seed), (48, 64)).numpy(),
        np.asarray(jax.random.uniform(key, (48, 64))))


def test_bad_key_shape_raises():
    with pytest.raises(ValueError, match="shape"):
        prng.split(np.zeros(3, np.uint32))
    with pytest.raises(ValueError, match="shape"):
        prng.uniform(np.zeros((2, 2), np.uint32), (4,))
