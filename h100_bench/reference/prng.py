"""JAX's default random numbers (threefry2x32, partitionable) in numpy and
plain PyTorch: ``key``, ``split`` and ``uniform``, the draws the
compositor's random reset makes.

A key is a uint32 numpy array of shape (2,), ``jax.random.key_data`` of
the key. ``split`` runs on the host, ``uniform`` on any device.
"""
import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _threefry2x32(k0, k1, x0, x1, wrap):
    """The 20-round threefry2x32 hash of the counters (x0, x1) under the
    key (k0, k1), a key injection every 4 rounds; ``wrap`` reduces a sum
    or a left shift to 32 bits."""
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
    """``jax.random.key_data(jax.random.key(seed))`` with 64-bit types off:
    the seed's low 32 bits, the high word 0."""
    return np.array([0, int(seed) & _MASK], dtype=np.uint32)


def split(key_data, n: int = 2) -> np.ndarray:
    """``jax.random.split``: (n, 2) uint32."""
    k = np.asarray(key_data, dtype=np.uint32)
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(_MASK)).astype(np.uint32)
    x0, x1 = _threefry2x32(k[0], k[1], hi, lo, lambda v: v)
    return np.stack([x0, x1], axis=-1)


def uniform(key_data, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) as float32."""
    k = np.asarray(key_data, dtype=np.uint32)
    shape = tuple(int(d) for d in shape)
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device)
    x0, x1 = _threefry2x32(int(k[0]), int(k[1]), idx >> 32, idx & _MASK,
                           lambda v: v & _MASK)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return floats.clamp_min(0.0).reshape(shape)


def frame_keys(seed: int, first: int, count: int) -> list[np.ndarray]:
    """The compositor's key of each frame ``first .. first + count - 1``
    of a render that started from ``key(seed)``: the render's key is
    split once a frame (the first row carries on, the second is the
    frame's), and the frame's key is split once more, one row a layer;
    this returns the first layer's row."""
    k = key(seed)
    out = []
    for frame in range(first + count):
        k, sub = split(k)
        if frame >= first:
            out.append(split(sub, 1)[0])
    return out
