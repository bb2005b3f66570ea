"""The JAX threefry PRNG, as the JAX package runs it, in numpy.

The perturb trunk's fixed masks (JAX ``models/modules.py:310-323``) are
``jax.random.normal`` draws at keys folded from ``PRNGKey(1902)``. They
are part of the architecture, never stored, so the port draws the same
values without JAX: this module copies the JAX functions it needs, under
jax 0.9's default ``jax_threefry_partitionable=True``:

- ``threefry2x32``: the Threefry-2x32 hash (20 rounds, key schedule
  ``k0, k1, k0 ^ k1 ^ 0x1BD11BDA``; ``jax/_src/prng.py``
  ``_threefry2x32_lowering``);
- ``prng_key(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]`` (``threefry_seed``);
- ``fold_in(key, data)``: the hash of the pair ``[0, data]``;
- ``random_bits``: the partitionable form, the hash of a 64-bit iota
  counter split into (hi, lo) words, the two output words XORed
  (``_threefry_random_bits_partitionable``); the older split-counter
  scheme gives other values;
- ``uniform``: 23 random mantissa bits under the exponent of 1.0, minus 1,
  scaled to [minval, maxval), in f32 as ``jax.random.uniform``;
- ``normal``: ``sqrt(2) * erfinv(u)`` of ``u = uniform(nextafter(-1, 0),
  1)``, with XLA's single-precision ``erf_inv`` (Giles' polynomial: ``w =
  -log1p(-x^2)``, two 9-term branches split at ``w < 5``) in f32.
  ``torch.erfinv`` is not that polynomial and lands up to ~90 ulp away.

``perturb_mask(salt, layer, shape)`` is JAX ``perturb_mask``; its masks
are cached per (salt, layer, shape) on the host.
"""

from __future__ import annotations

import functools

import numpy as np

# The perturb trunk's root seed (JAX models/modules.py PERTURB_SEED, the
# arXiv number of the Perturbative GAN paper).
PERTURB_SEED = 1902

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# XLA's ErfInv32 coefficients (Giles, "Approximating the erfinv function").
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << np.uint32(d)) | (v >> np.uint32(32 - d))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 of the counter words (x0, x1) under ``key`` (two
    uint32): the two uint32 output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s two words."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    o0, o1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([o0[0], o1[0]], np.uint32)


def random_bits(key, shape) -> np.ndarray:
    """32 random bits per element of ``shape`` (the partitionable form)."""
    size = int(np.prod(shape))
    counts = np.arange(size, dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    lo = (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    bits1, bits2 = threefry2x32(key, hi, lo)
    return (bits1 ^ bits2).reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(32 - 23)) | one).view(np.float32)
    floats = floats - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's single-precision ``erf_inv`` of an f32 array, in f32."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):
        w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_W_LT_5[0]),
                 np.float32(_ERFINV_W_GE_5[0]))
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = np.where(lt, np.float32(a), np.float32(b)) + p * w
    out = p * x
    return np.where(np.abs(x) == np.float32(1.0),
                    x * np.finfo(np.float32).max, out).astype(np.float32)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)


def perturb_key(salt: int, layer: int) -> np.ndarray:
    """The key of one perturb-conv site: PRNGKey(1902) folded with the
    block's salt, then the layer."""
    return fold_in(fold_in(prng_key(PERTURB_SEED), salt), layer)


@functools.lru_cache(maxsize=None)
def _perturb_mask(salt: int, layer: int, shape: tuple) -> np.ndarray:
    mask = normal(perturb_key(salt, layer), shape)
    mask.setflags(write=False)
    return mask


def perturb_mask(salt: int, layer: int, shape) -> np.ndarray:
    """The fixed N(0, 1) mask [H, W, C] f32 of one perturb-conv site (JAX
    ``perturb_mask``), computed once per (salt, layer, shape) and cached
    read-only."""
    return _perturb_mask(int(salt), int(layer), tuple(int(d) for d in shape))
