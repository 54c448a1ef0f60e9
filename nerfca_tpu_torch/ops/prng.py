"""The JAX package's random numbers, drawn on the host: ``jax.random``'s
default generator (Threefry-2x32 with the partitionable key derivation,
JAX's default since 0.5) for the calls the trainer makes: ``PRNGKey``,
``split``, ``fold_in``, 32-bit ``bits``, f32 ``uniform``, ``randint`` and f32
``normal``.

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


# ---------------------------------------------------------------------------
# jax.random.normal: uniforms on (-1, 1), then sqrt(2) * erfinv, with XLA's
# f32 erfinv as its CPU backend compiles it (Giles' polynomial over a
# log1p that is Cephes' rational below sqrt(2) - 1 and Cephes' log above
# it), multiply-adds fused as XLA fuses them. Held bit for bit against
# jax.random.normal in tests/test_torch_fourier.py.

_F32 = np.float32
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)


def _fma(a, b, c) -> np.ndarray:
    """f32 ``a * b + c`` rounded once (the f32 product is exact in f64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _log_f32(v: np.ndarray) -> np.ndarray:
    """XLA's f32 log on the CPU (Cephes), for positive normal ``v``."""
    f = _F32
    x, e = np.frexp(v.astype(f))
    x, e = x.astype(f), e.astype(f)
    small = x < f(0.707106781186547524)
    x = ((x - f(1)) + np.where(small, x, f(0))).astype(f)
    e = (e - np.where(small, f(1), f(0))).astype(f)
    x2 = (x * x).astype(f)
    x3 = (x2 * x).astype(f)
    p = [f(c) for c in _LOG_P]
    y, y1, y2 = _fma(x, p[0], p[1]), _fma(x, p[3], p[4]), _fma(x, p[6], p[7])
    y, y1, y2 = _fma(y, x, p[2]), _fma(y1, x, p[5]), _fma(y2, x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, (f(-2.12194440e-4) * e).astype(f))
    x = (_fma(x2, f(-0.5), x) + y).astype(f)
    return _fma(f(0.693359375), e, x)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 log1p on the CPU, for ``x`` in (-1, 0]."""
    f = _F32

    def poly(coeffs):
        p = np.full_like(x, f(coeffs[0]))
        for c in coeffs[1:]:
            p = _fma(p, x, f(c))
        return p

    x2 = (x * x).astype(f)
    small = (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)).astype(f)
    small = ((x * x2).astype(f) * small).astype(f)
    small = (x + _fma(f(-0.5), x2, small)).astype(f)
    large = _log_f32(np.maximum((x + f(1)).astype(f), np.finfo(f).tiny))
    return np.where(np.abs(x) < f(0.41421356237309504880), small, large)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv`` (Giles 2010) for ``x`` in (-1, 1)."""
    f = _F32
    x = np.asarray(x, f)
    w = -_log1p_f32(-(x * x).astype(f))
    lt = w < f(5)
    w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3)).astype(f)
    coef = [np.where(lt, f(a), f(b)) for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = coef[0]
    for c in coef[1:]:
        p = _fma(p, w, c)
    return np.where(np.abs(x) == f(1), x * np.finfo(f).max, (p * x).astype(f))


def normal(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(k, shape, float32)``."""
    f = _F32
    u = uniform(k, shape, np.nextafter(f(-1), f(0)), 1.0)
    return (f(np.sqrt(2)) * erfinv_f32(u)).astype(f)
