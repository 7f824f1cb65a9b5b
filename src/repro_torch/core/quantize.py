"""Blockwise absmax quantization (paper §III: BitsAndBytes-style PTQ).

A tensor is quantized along one axis (``q_axis``) in contiguous blocks of
``block_size`` values; each block shares one scale = absmax / max_code.
``q_axis=-2`` serves weight matrices ``(..., K, N)`` (blocks run along
the contraction dim), ``q_axis=-1`` embedding tables ``(V, D)``.

Double quantization (QLoRA): the f32 block scales are themselves
quantized to int8 in chunks of 256 around their chunk mean.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .formats import (Format, get_format, nibble_from_signed, pack_nibbles,
                      signed_from_nibble, unpack_nibbles)

__all__ = ["quantize_blockwise", "dequantize_blockwise", "quantize_scales",
           "dequantize_scales", "effective_block_size"]

_DQ_CHUNK = 256  # scales-of-scales chunk (bitsandbytes default)


def effective_block_size(dim: int, block_size: int) -> int:
    """Largest usable block size: must divide ``dim`` (fallback: whole dim)."""
    if block_size <= 0 or dim % block_size != 0:
        return dim
    return block_size


def _block_view(x: torch.Tensor, q_axis: int, block: int) -> torch.Tensor:
    """Reshape so blocks get their own axis right after the split q_axis."""
    q_axis = q_axis % x.ndim
    return x.unflatten(q_axis, (x.shape[q_axis] // block, block))


def quantize_blockwise(w: torch.Tensor, fmt: Format | str,
                       block_size: int = 64, q_axis: int = -2
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``w`` -> (codes, scales).

    codes:  packed uint8 (4-bit fmts), int8 (int8), float8 (fp8 fmts)
    scales: f32, shape = w.shape with q_axis replaced by n_blocks
    """
    if isinstance(fmt, str):
        fmt = get_format(fmt)
    if fmt.kind == "none":
        raise ValueError(f"format {fmt.name} is a passthrough; nothing to quantize")
    q_axis = q_axis % w.ndim
    block = effective_block_size(w.shape[q_axis], block_size)
    xb = _block_view(w.to(torch.float32), q_axis, block)     # (..., nb, B, ...)
    absmax = xb.abs().amax(dim=q_axis + 1)                    # (..., nb, ...)
    scales = absmax / fmt.max_code
    safe = torch.where(scales == 0, torch.ones_like(scales), scales)
    xs = xb / safe.unsqueeze(q_axis + 1)

    if fmt.kind == "int":
        codes = torch.clamp(torch.round(xs), -fmt.max_code,
                            fmt.max_code).reshape(w.shape)
        if fmt.bits == 4:
            codes = pack_nibbles(nibble_from_signed(codes), axis=q_axis)
        else:
            codes = codes.to(torch.int8)
    elif fmt.kind == "codebook":
        bounds = torch.from_numpy(fmt.boundaries()).to(xs.device)
        # side="left" on both sides: x on a boundary takes the lower entry
        idx = torch.searchsorted(bounds, xs.contiguous()).to(torch.uint8)
        codes = pack_nibbles(idx.reshape(w.shape), axis=q_axis)
    elif fmt.kind == "float8":
        codes = xs.reshape(w.shape).to(fmt.storage_dtype)
    else:  # pragma: no cover
        raise ValueError(fmt.kind)
    return codes, scales


def _code_values(codes: torch.Tensor, fmt: Format, q_axis: int) -> torch.Tensor:
    """Stored codes -> f32 code values (before the block scale)."""
    if fmt.kind == "int" and fmt.bits == 4:
        return signed_from_nibble(unpack_nibbles(codes, axis=q_axis)).to(torch.float32)
    if fmt.kind == "codebook":
        cb = torch.from_numpy(fmt.codebook).to(codes.device)
        return cb[unpack_nibbles(codes, axis=q_axis).long()]
    if fmt.kind in ("int", "float8"):
        return codes.to(torch.float32)
    raise ValueError(fmt.kind)  # pragma: no cover


def dequantize_blockwise(codes: torch.Tensor, scales: torch.Tensor,
                         fmt: Format | str, q_axis: int = -2,
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` (up to rounding error)."""
    if isinstance(fmt, str):
        fmt = get_format(fmt)
    q_axis = q_axis % codes.ndim
    vals = _code_values(codes, fmt, q_axis)
    block = vals.shape[q_axis] // scales.shape[q_axis]
    vb = _block_view(vals, q_axis, block)
    out = vb * scales.to(torch.float32).unsqueeze(q_axis + 1)
    return out.reshape(vals.shape).to(out_dtype)


def _chunk_mean(chunks: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis (256 values) summed in a fixed order:
    each 32-value segment left to right, then the 8 segment sums left to
    right. That is the order of the reference's CPU reduction, so the
    double-quant offsets match it bit for bit."""
    seg = chunks.unflatten(-1, (8, 32))
    s = seg[..., 0]
    for i in range(1, 32):
        s = s + seg[..., i]
    total = s[..., 0]
    for i in range(1, 8):
        total = total + s[..., i]
    return (total / _DQ_CHUNK).unsqueeze(-1)


def quantize_scales(scales: torch.Tensor):
    """f32 scales -> (int8 codes, f32 chunk scale, f32 offset, orig shape).

    Stacked-layer scales (ndim >= 3, leading layer axis) keep that axis on
    every output so per-layer slices stay self-contained.
    """
    shape = tuple(scales.shape)
    lead = shape[0] if len(shape) >= 3 else 1
    flat = scales.reshape(lead, -1).to(torch.float32)
    pad = (-flat.shape[1]) % _DQ_CHUNK
    flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(lead, -1, _DQ_CHUNK)
    offset = _chunk_mean(chunks)
    centred = chunks - offset
    absmax = centred.abs().amax(dim=-1, keepdim=True)
    cscale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    codes = torch.clamp(torch.round(centred / cscale), -127, 127).to(torch.int8)
    if len(shape) < 3:   # unstacked: drop the synthetic batch dim
        codes, cscale, offset = codes[0], cscale[0], offset[0]
    return codes, cscale, offset, shape


def dequantize_scales(codes, cscale, offset, shape) -> torch.Tensor:
    flat = codes.to(torch.float32) * cscale + offset
    n = 1
    for s in shape:
        n *= s
    return flat.reshape(-1)[:n].reshape(shape)
