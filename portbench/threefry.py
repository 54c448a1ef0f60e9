"""A frozen copy of the JAX default generator (Threefry-2x32, partitionable
key derivation) for the calls the port's train steps make: ``split``,
``fold_in``, 32-bit bits, f32 uniforms and ``randint``.

The port draws each step's batch positions, jitter and depths on the host
through its own copy of these functions; the plain reference draws them
again here, so that it takes nothing the program has made. A key is a
``uint32[2]`` array.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _block(k1: int, k2: int, x0: int, x1: int) -> tuple:
    """Threefry-2x32 (20 rounds) on one counter pair, in Python integers."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0, x1 = (x0 + k1) & _M32, (x1 + k2) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _threefry(k1, k2, x0, x1) -> tuple:
    """Threefry-2x32 on uint32 arrays (key words broadcast)."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(_PARITY))
    x0 = np.asarray(x0, np.uint32) + k1
    x1 = np.asarray(x1, np.uint32) + k2
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """A key from a seed of up to 64 bits: its high and low words."""
    return np.array([(seed >> 32) & _M32, seed & _M32], np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: block i of the 64-bit counter i."""
    k1, k2 = int(k[0]), int(k[1])
    return np.array([_block(k1, k2, i >> 32, i & _M32) for i in range(num)], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``."""
    return np.array(_block(int(k[0]), int(k[1]), 0, data & _M32), np.uint32)


def bits(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.bits(k, (n,), uint32)``: the xor of the block of counter j."""
    counters = np.arange(n, dtype=np.uint64)
    b1, b2 = _threefry(k[0], k[1], (counters >> np.uint64(32)).astype(np.uint32),
                       counters.astype(np.uint32))
    return b1 ^ b2


def uniform(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.uniform(k, (n,))`` in [0, 1), f32: 23 mantissa bits."""
    words = bits(k, n)
    return ((words >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)


def randint(k: np.ndarray, n: int, span: int) -> np.ndarray:
    """``jax.random.randint(k, (n,), 0, span)``: a high word under the first
    key of ``split(k)`` and a low word under the second, reduced modulo
    ``span`` through ``2**32 mod span`` in uint32 arithmetic."""
    k_high, k_low = split(k)
    high, low = bits(k_high, n), bits(k_low, n)
    span = np.uint32(span)
    mult = np.array([2 ** 16 % int(span)], np.uint32)
    mult = (mult * mult) % span
    return (((high % span) * mult + low % span) % span).astype(np.int64)
