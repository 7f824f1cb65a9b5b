"""Counter-based random bits: the parts of ``jax.random`` the sampler and
the seeded parameter init use.

The reference draws its sampling noise from JAX's default generator,
threefry2x32 in its partitionable counter layout. This module computes
the same bits bit for bit, so a seeded request samples the same tokens
in both packages:

    key = prng_key(seed)                 # jax.random.PRNGKey(seed)
    key = fold_in(key, t)                # jax.random.fold_in(key, t)
    bits = random_bits(key, (V,))        # jax.random.bits(key, (V,))
    tok = categorical(key, logits)       # jax.random.categorical(key, logits)
    ids = randint(key, (1, 6), 0, V)     # jax.random.randint(key, (1, 6), 0, V)
    keys = split(key, 4)                 # jax.random.split(key, 4)
    w = normal(keys[0], (64, 96))        # jax.random.normal(keys[0], (64, 96))

A key is an int64 tensor whose last axis holds the two 32-bit words;
leading axes batch independent keys (one per serving slot). The uint32
arithmetic runs in int64 masked to 32 bits, so the same code runs on
CPU and CUDA tensors. ``uniform`` and ``gumbel`` follow JAX's float32
mapping of the bits; ``gumbel`` takes logarithms, which the two
libraries may round one ulp apart, so ``categorical`` agrees with JAX's
draw except on ties at that precision. ``normal`` evaluates XLA's
inverse-error-function polynomial with fused multiply-adds; it agrees with
``jax.random.normal`` to one float32 ulp (the two ``log1p`` may round
apart).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["prng_key", "fold_in", "split", "threefry2x32", "random_bits", "uniform",
           "normal", "gumbel", "categorical", "randint"]

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


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (the partitionable layout): key (2,) -> (num, 2),
    key i being threefry of the 64-bit counter i."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
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


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    words of bits per element, from the two halves of ``split(key)``,
    folded into [minval, maxval) with JAX's uint32 arithmetic (products
    and sums wrap at 2^32). Returns an int32 tensor of ``shape``."""
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError(f"randint bounds [{minval}, {maxval}) exceed int32")
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (2 ** 16 % span) ** 2 % 2 ** 32 % span
    off = (((hi % span) * mult & _MASK) + lo % span) & _MASK
    return (minval + off % span).to(torch.int32)


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


# XLA's float32 inverse error function (M. Giles, "Approximating the erfinv
# function"): a degree-8 polynomial in w = -log1p(-x^2), one per branch
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                  1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                  2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erfinv of x in (-1, 1); each Horner step is a fused
    multiply-add (computed in float64, one rounding to float32), as the
    compiled reference evaluates it. log1p is taken in float64 and rounded
    once: torch's float32 log1p may round an element one way or the other
    depending on which vector lane computes it."""
    w = (-torch.log1p(-(x * x).to(torch.float64))).to(torch.float32)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).to(torch.float64)
    p = torch.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        c = torch.where(lt, torch.tensor(a, dtype=torch.float32, device=x.device),
                        torch.tensor(b, dtype=torch.float32, device=x.device))
        p = (c.to(torch.float64) + p.to(torch.float64) * w).to(torch.float32)
    return p * x


_SQRT2_F32 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))
# the largest float32 below 1 in magnitude: jax.random.normal's lower bound
_NEG_ONE_NEXT = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) erfinv(u), u
    uniform in (-1, 1)."""
    return _SQRT2_F32 * _erfinv(uniform(key, shape, _NEG_ONE_NEXT, 1.0))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel noise, float32 (JAX's default "low" mode)."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per key from softmax(logits) along the last axis by the
    Gumbel-max trick: key (..., 2), logits (..., V) -> (...) int64."""
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
