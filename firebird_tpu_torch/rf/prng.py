"""Keyed counter-based random numbers: the JAX package's forest draws.

The JAX package's forest (``rf/forest.py``) draws its bootstrap weights
and its per-node feature subsets from ``jax.random``: threefry2x32 keys,
with ``jax_threefry_partitionable`` on (the counters of a draw are the
64-bit iota of its shape, split into high and low words).  This module
computes the same words in PyTorch on any device, so the port trains the
same forest from the same seed:

- :func:`prng_key` is ``jax.random.PRNGKey(seed)``;
- :func:`split` is ``jax.random.split(key, num)``;
- :func:`fold_in` is ``jax.random.fold_in(key, data)``;
- :func:`random_bits` is the 32-bit ``jax.random.bits``;
- :func:`uniform` is ``jax.random.uniform(key, shape)`` in float32 (the
  JAX package's default dtype with ``jax_enable_x64`` off);
- :func:`poisson` is ``jax.random.poisson(key, lam, shape)`` for
  ``lam < 10``: Knuth's loop.

A key is an int64 tensor whose last axis holds its two uint32 words;
leading axes batch keys (what ``jax.vmap`` over keys gives).  The words
are kept in int64 and masked to 32 bits after every add and shift.  No
global generator is touched.

Knuth's loop sums ``log(u)`` in float32.  ``torch.log`` and XLA's CPU
``log`` differ by an ulp on about 14 % of float32 inputs, so a count can
differ from the JAX package's where the running sum lies within a few
ulps of ``-lam``: of the order of 1e-7 of the draws.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000
# Knuth passes between two checks of whether a lane is still counting: an
# extra pass leaves a finished lane's count as it is.
_KNUTH_CHECK_EVERY = 4


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key words (k1, k2); all int64, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & MASK
    x2 = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with ``jax_enable_x64`` off: the words
    (0, the seed's low 32 bits)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _iota_words(shape, device):
    """The high and low words of the 64-bit row-major iota of ``shape``."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK


def _hash_shape(key: torch.Tensor, shape) -> tuple:
    """threefry2x32 of the iota counters of ``shape`` under each key:
    two int64 tensors of shape ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _iota_words(shape, key.device)
    pad = (None,) * len(shape)
    k1 = key[..., 0][(...,) + pad]
    k2 = key[..., 1][(...,) + pad]
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: [..., num, 2]."""
    b1, b2 = _hash_shape(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counters
    (0, data) under ``key``.  ``data`` (an int or an integer tensor)
    broadcasts against the key's batch axes."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)``, as int64 in [0, 2^32)."""
    b1, b2 = _hash_shape(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32, in [0, 1): the top
    23 bits as the mantissa of a float in [1, 2), minus one."""
    bits = (random_bits(key, shape) >> 9) | _ONE_F32_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0


def poisson(key: torch.Tensor, lam: float, shape) -> torch.Tensor:
    """``jax.random.poisson(key, lam, shape)`` for ``0 < lam < 10``: Knuth's
    loop.  Each pass splits the key once and multiplies a lane's running
    product by a fresh uniform (sums its log in float32) while the product
    is above ``exp(-lam)``; the count is the passes taken, less one.
    int64, ``key.shape[:-1] + shape``."""
    if not 0 < lam < 10:
        raise ValueError(f"poisson: lam {lam} outside (0, 10), Knuth's range")
    shape = tuple(int(s) for s in shape)
    out_shape = tuple(key.shape[:-1]) + shape
    k = torch.zeros(out_shape, dtype=torch.int64, device=key.device)
    log_prod = torch.zeros(out_shape, dtype=torch.float32, device=key.device)
    neg_lam = torch.tensor(-lam, dtype=torch.float32, device=key.device)
    rng = key
    while True:
        for _ in range(_KNUTH_CHECK_EVERY):
            keys = split(rng)
            rng, sub = keys[..., 0, :], keys[..., 1, :]
            k = k + (log_prod > neg_lam).to(torch.int64)
            log_prod = log_prod + torch.log(uniform(sub, shape))
        if not bool((log_prod > neg_lam).any()):
            return k - 1


__all__ = ["threefry2x32", "prng_key", "split", "fold_in", "random_bits",
           "uniform", "poisson"]
