"""Numeric formats for sub-octet quantization (paper §II-A / §III).

Each format defines how a real value maps to a code and back:

  * uniform integer formats (INT4, INT8): symmetric absmax scaling,
    code = round(x / scale) clipped to the symmetric range;
  * codebook formats (FP4 = E2M1 value set, NF4 = QLoRA normal-float):
    code = index of the nearest codebook entry of x / scale;
  * FP8 (E4M3 / E5M2): native float8 storage with a blockwise scale.

All formats quantize blockwise: a block of ``block_size`` consecutive
values along the quantization axis shares one scale.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["Format", "get_format", "FORMATS", "SUB_OCTET", "pack_nibbles",
           "unpack_nibbles", "signed_from_nibble", "nibble_from_signed"]


# E2M1 value set (sign x {0, 0.5, 1, 1.5, 2, 3, 4, 6}), sorted ascending;
# indices 7 and 8 are -0 and +0.
_FP4_E2M1 = np.sort(np.array(
    [-6.0, -4.0, -3.0, -2.0, -1.5, -1.0, -0.5, -0.0,
     0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=np.float32))

# QLoRA NF4 table (Dettmers et al., 2023).
_NF4 = np.array(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
     0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
     0.7229568362236023, 1.0], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class Format:
    """A storage number format for quantized tensors."""

    name: str
    bits: int
    kind: str                      # "int" | "codebook" | "float8" | "none"
    max_code: float                # |value| that absmax maps to
    codebook: Optional[np.ndarray] = None
    storage_dtype: Optional[torch.dtype] = None

    def boundaries(self) -> np.ndarray:
        """Decision boundaries (midpoints) for codebook nearest-neighbour."""
        cb = self.codebook
        return (cb[1:] + cb[:-1]) / 2.0


FORMATS: dict[str, Format] = {
    "int4": Format("int4", 4, "int", 7.0, storage_dtype=torch.uint8),
    "int8": Format("int8", 8, "int", 127.0, storage_dtype=torch.int8),
    "fp4": Format("fp4", 4, "codebook", 6.0, codebook=_FP4_E2M1,
                  storage_dtype=torch.uint8),
    "nf4": Format("nf4", 4, "codebook", 1.0, codebook=_NF4,
                  storage_dtype=torch.uint8),
    "fp8": Format("fp8", 8, "float8", 448.0,
                  storage_dtype=torch.float8_e4m3fn),
    "fp8_e5m2": Format("fp8_e5m2", 8, "float8", 57344.0,
                       storage_dtype=torch.float8_e5m2),
    "bf16": Format("bf16", 16, "none", 0.0, storage_dtype=torch.bfloat16),
    "f32": Format("f32", 32, "none", 0.0, storage_dtype=torch.float32),
}

SUB_OCTET = ("int4", "fp4", "nf4")


def get_format(name: str) -> Format:
    if name not in FORMATS:
        raise ValueError(f"unknown format {name!r}; have {sorted(FORMATS)}")
    return FORMATS[name]


def pack_nibbles(codes: torch.Tensor, axis: int) -> torch.Tensor:
    """Pack uint8 codes (0..15) two per byte along ``axis``: even
    positions in the low nibble, odd positions in the high nibble."""
    axis = axis % codes.ndim
    n = codes.shape[axis]
    if n % 2 != 0:
        raise ValueError(f"axis {axis} length {n} must be even to pack")
    pairs = codes.to(torch.uint8).unflatten(axis, (n // 2, 2))
    return pairs.select(axis + 1, 0) | (pairs.select(axis + 1, 1) << 4)


def unpack_nibbles(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles` (returns uint8 codes 0..15)."""
    axis = axis % packed.ndim
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    return torch.stack([lo, hi], dim=axis + 1).flatten(axis, axis + 1)


def signed_from_nibble(codes: torch.Tensor) -> torch.Tensor:
    """uint8 nibble (0..15) -> int8 two's-complement int4 value (-8..7)."""
    return (codes.to(torch.int8) ^ 8) - 8


def nibble_from_signed(vals: torch.Tensor) -> torch.Tensor:
    """int values (-8..7) -> uint8 nibble (0..15)."""
    return (vals.to(torch.int8) & 0x0F).to(torch.uint8)
