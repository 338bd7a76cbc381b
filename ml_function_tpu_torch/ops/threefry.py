"""The part of ``jax.random`` that the reference's LSH attention draws from,
in numpy: ``PRNGKey``, ``fold_in`` and ``normal`` (f32).

The reference's ``LSHSelfAttention`` buckets keys by a random rotation
``jax.random.normal(fold_in(PRNGKey(seed), r), (hd, n_buckets // 2))`` that
is not a parameter, so a model exported by the JAX package buckets its keys
the same way in the port only if the port draws the same rotation. This
module computes it without JAX:

- keys are Threefry-2x32 key pairs (two uint32 words), ``prng_key(seed)``
  being (0, seed) for a 32-bit seed, and ``fold_in(key, r)`` the
  Threefry-2x32 hash of the counter pair (0, r) under ``key``;
- ``random_bits`` is the "partitionable" layout (JAX's
  ``jax_threefry_partitionable``, the default since JAX 0.5): element i of
  the row-major shape hashes the counter pair (i >> 32, i & 0xFFFFFFFF),
  and its 32 bits are the two output words xor-ed;
- ``normal`` maps the bits to a uniform in (nextafter(-1, 0), 1) through the
  mantissa, as ``jax.random.uniform`` does, then √2·erfinv(u) with the
  polynomial that XLA's ``ErfInv`` evaluates in f32.

The bits are JAX's exactly. XLA's CPU ``log1p`` inside ``ErfInv`` is its own
approximation, so the normals can sit a few ulps from JAX's
(``tests/test_torch_lsh.py`` states how many); the rotation's buckets are
held equal there.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Key = Tuple[int, int]

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# XLA's f32 ErfInv (Giles' approximation): coefficients for w = −log1p(−x²)
# below 5 (in w − 2.5) and from 5 on (in √w − 3)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Key, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1), uint32
    arrays of one shape, under the key pair ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(int(k0) ^ int(k1) ^ _PARITY))
    x0 = np.array(x0, dtype=np.uint32, copy=True)
    x1 = np.array(x1, dtype=np.uint32, copy=True)
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r) ^ x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``'s two words, for 0 ≤ seed < 2^32 (JAX's
    default 32-bit seeds)."""
    if not 0 <= seed <= _MASK32:
        raise ValueError(f"seed must lie in [0, 2^32), got {seed}")
    return 0, seed


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for 0 ≤ data < 2^32."""
    if not 0 <= data <= _MASK32:
        raise ValueError(f"data must lie in [0, 2^32), got {data}")
    y0, y1 = threefry2x32(key, [0], [data])
    return int(y0[0]), int(y1[0])


def random_bits(key: Key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)`` under the partitionable
    layout."""
    i = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    y0, y1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(_MASK32)).astype(np.uint32))
    return (y0 ^ y1).reshape(tuple(shape))


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ErfInv polynomial; each step is rounded to f32 from f64,
    which keeps it within a few ulps of the CPU backend's."""
    f32 = np.float32
    w = (-np.log1p((x * -x).astype(np.float64))).astype(f32)
    small = w < f32(5.0)
    w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(small, f32(_ERFINV_SMALL[0]), f32(_ERFINV_LARGE[0]))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, f32(a), f32(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w.astype(np.float64)).astype(f32)
    out = (p * x).astype(f32)
    return np.where(np.abs(x) == f32(1.0), x * np.finfo(f32).max, out).astype(f32)


def normal(key: Key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    bits = random_bits(key, shape)
    one = np.float32(1.0)
    floats = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32) - one
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, (floats * (one - lo) + lo).astype(np.float32))
    return (np.float32(np.sqrt(2.0)) * _erfinv_f32(u)).astype(np.float32)
