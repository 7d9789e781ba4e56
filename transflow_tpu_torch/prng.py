"""JAX's default random numbers (threefry2x32) in numpy and PyTorch.

Counterpart of the part of ``jax.random`` the JAX package uses: ``key``,
``split``, ``fold_in`` and ``uniform`` on its default threefry keys, with
``jax_threefry_partitionable`` on (JAX's default since 0.5). A key is a
uint32 numpy array of shape (2,), the ``jax.random.key_data`` of the JAX
key, so the port draws the JAX package's numbers bit for bit and a
checkpoint's ``rng_key`` reads the same in both packages.

``split`` and ``fold_in`` run on the host in numpy (a key chain costs no
device launch and no sync); ``uniform`` runs on the device in PyTorch.
All go through one threefry core: numpy's uint32 wraps by itself, and in
PyTorch the words are int64 masked to 32 bits, since torch's uint32 lacks
arithmetic on some builds.
"""
import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _threefry2x32(k0, k1, x0, x1, wrap):
    """The threefry2x32 hash of the counter pairs (x0, x1) under the key
    (k0, k1): 20 rounds, a key injection every 4 (prng.py's
    ``_threefry2x32_lowering``). ``wrap`` reduces a sum or a left shift to
    32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = wrap(x0 + ks[0])
    x1 = wrap(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = wrap(x0 + x1)
            x1 = (wrap(x1 << r) | (x1 >> (32 - r))) ^ x0
        x0 = wrap(x0 + ks[(i + 1) % 3])
        x1 = wrap(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))``. The JAX package runs
    with 64-bit types off, so the seed is an int32 and its high word 0."""
    return np.array([0, int(seed) & _MASK], dtype=np.uint32)


def split(key_data, n: int = 2) -> np.ndarray:
    """``jax.random.split``: (n, 2) uint32, computed on the host."""
    k = np.asarray(key_data, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a key is uint32 of shape (2,), got {k.shape}")
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(_MASK)).astype(np.uint32)
    x0, x1 = _threefry2x32(k[0], k[1], hi, lo, lambda v: v)
    return np.stack([x0, x1], axis=-1)


def fold_in(key_data, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the key hashed with ``data`` (taken as a
    uint32, the high counter word 0, as JAX's ``threefry_seed`` makes it),
    computed on the host."""
    k = np.asarray(key_data, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a key is uint32 of shape (2,), got {k.shape}")
    x0, x1 = _threefry2x32(k[0], k[1], np.zeros(1, np.uint32),
                           np.array([int(data) & _MASK], np.uint32),
                           lambda v: v)
    return np.concatenate([x0, x1])


def uniform(key_data, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) as a float32 tensor,
    computed on ``device``."""
    k = np.asarray(key_data, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a key is uint32 of shape (2,), got {k.shape}")
    shape = tuple(int(d) for d in shape)
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device)
    x0, x1 = _threefry2x32(int(k[0]), int(k[1]), idx >> 32, idx & _MASK,
                           lambda v: v & _MASK)
    # 23 random mantissa bits under the exponent of 1.0, minus 1.0
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return floats.clamp_min(0.0).reshape(shape)
