"""Counter-based random bits: the parts of ``jax.random`` the sampler uses.

The reference draws its sampling noise from JAX's default generator,
threefry2x32 in its partitionable counter layout. This module computes
the same bits bit for bit, so a seeded request samples the same tokens
in both packages:

    key = prng_key(seed)                 # jax.random.PRNGKey(seed)
    key = fold_in(key, t)                # jax.random.fold_in(key, t)
    bits = random_bits(key, (V,))        # jax.random.bits(key, (V,))
    tok = categorical(key, logits)       # jax.random.categorical(key, logits)

A key is an int64 tensor whose last axis holds the two 32-bit words;
leading axes batch independent keys (one per serving slot). The uint32
arithmetic runs in int64 masked to 32 bits, so the same code runs on
CPU and CUDA tensors. ``uniform`` and ``gumbel`` follow JAX's float32
mapping of the bits; ``gumbel`` takes logarithms, which the two
libraries may round one ulp apart, so ``categorical`` agrees with JAX's
draw except on ties at that precision.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["prng_key", "fold_in", "threefry2x32", "random_bits", "uniform",
           "gumbel", "categorical"]

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = 1.1754943508222875e-38        # smallest normal float32
_F32_ONE_BITS = 0x3F800000


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on 32-bit words held in
    int64 tensors; all four arguments broadcast. Returns two words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit integers (JAX's default):
    the key words are (0, seed mod 2^32)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit a 32-bit integer")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data an int or a tensor that
    broadcasts against key[..., 0]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random words (as int64) of ``shape`` for each key: the
    partitionable layout hashes the 64-bit flat index of each element.
    Returns key.shape[:-1] + shape."""
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval): the top 23 bits become the
    mantissa of a float in [1, 2), as in ``jax.random.uniform``."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    # filled on the device: no host-to-device copy inside a decode horizon
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel noise, float32 (JAX's default "low" mode)."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per key from softmax(logits) along the last axis by the
    Gumbel-max trick: key (..., 2), logits (..., V) -> (...) int64."""
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
