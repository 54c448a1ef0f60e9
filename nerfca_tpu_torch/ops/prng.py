"""The JAX package's random numbers, drawn on the host: ``jax.random``'s
default generator (Threefry-2x32 with the partitionable key derivation,
JAX's default since 0.5) for the calls the trainer makes: ``PRNGKey``,
``split``, ``fold_in``, 32-bit ``bits``, f32 ``uniform`` and ``randint``.

A seed thus draws the same initial params, ray batches, jitter and depths
in the port as in the JAX package, so a port run follows the JAX run of the
same config and seed (up to f32 rounding) and the two packages' training
records compare step for step. A key is a ``uint32[2]`` array. Key
derivations (one cipher block each) run in Python integers; bulk bits run
in numpy, several keys' draws in one pass (:func:`bits_segments`).
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


def threefry2x32(k1, k2, x0, x1) -> tuple:
    """Threefry-2x32 on uint32 arrays; key words broadcast against the
    counters (one key per element or one for all). Updates in place: a
    step's draws are bound by these ~110 passes over ~4.5k words."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(_PARITY))
    x0 = np.asarray(x0, np.uint32) + k1
    x1 = np.asarray(x1, np.uint32) + k2
    high = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=high)
            x1 >>= np.uint32(32 - r)
            x1 |= high
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3]
        x1 += np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return np.array([0, seed & _M32], np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)`` -> ``uint32[num, 2]``: block i of the
    64-bit counter i."""
    k1, k2 = int(k[0]), int(k[1])
    return np.array([_block(k1, k2, i >> 32, i & _M32) for i in range(num)], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``."""
    return np.array(_block(int(k[0]), int(k[1]), 0, data & _M32), np.uint32)


def bits_segments(segments) -> np.ndarray:
    """``jax.random.bits(k, (n,), uint32)`` for each ``(k, n)`` of
    ``segments``, concatenated, in one numpy pass: element j of a segment
    is the xor of the block of counter j under that segment's key."""
    sizes = [int(n) for _, n in segments]
    keys = np.repeat(np.stack([np.asarray(k, np.uint32) for k, _ in segments]), sizes, axis=0)
    counters = np.concatenate([np.arange(n, dtype=np.uint64) for n in sizes])
    b1, b2 = threefry2x32(keys[:, 0], keys[:, 1], (counters >> np.uint64(32)).astype(np.uint32),
                          counters.astype(np.uint32))
    return b1 ^ b2


def bits(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(k, shape, uint32)``."""
    shape = tuple(np.atleast_1d(shape))
    return bits_segments([(k, int(np.prod(shape)))]).reshape(shape)


def uniform_from_bits(words: np.ndarray, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform``'s map from 32-bit words to f32: 23 mantissa
    bits give a float in [1, 2), less 1, scaled into [minval, maxval) with
    a fused multiply-add, as XLA compiles it (the f32 product is exact in
    f64; the f64 sum is rounded to f32)."""
    f32 = np.float32
    lo, hi = f32(minval), f32(maxval)
    floats = ((words >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - f32(1.0)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(f32)
    return np.maximum(lo, scaled)


def uniform(k: np.ndarray, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``."""
    return uniform_from_bits(bits(k, shape), minval, maxval)


def randint_from_bits(high: np.ndarray, low: np.ndarray, span: int) -> np.ndarray:
    """``jax.random.randint``'s map from two words to [0, span): the 64-bit
    value reduced modulo ``span`` through ``2**32 mod span``, in uint32
    arithmetic as JAX does it."""
    span = np.uint32(span)
    mult = np.array([2 ** 16 % int(span)], np.uint32)
    mult = (mult * mult) % span
    return (((high % span) * mult + low % span) % span).astype(np.int64)


def randint(k: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` for int32 bounds
    with ``maxval > minval``: the high words under the first key of
    ``split(k)``, the low words under the second."""
    k1, k2 = split(k)
    return randint_from_bits(bits(k1, shape), bits(k2, shape), maxval - minval) + int(minval)
