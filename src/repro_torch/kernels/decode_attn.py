"""Flash-decode attention over a dense int8 KV cache.

The dense serving cache holds per layer int8 codes ``(B, S, Hkv, d)``
with one f32 scale per (token, head) ``(B, S, Hkv)``, and per-row valid
lengths. ``decode_attn_call`` launches the hand-written CUDA kernel
(``csrc/decode_attn.cu``), which splits each row over blocks and reads
that layout in place;
``decode_attn_plain`` computes the same function in plain PyTorch (the
counterpart of the JAX package's ``kernels/ref.py::decode_attn_ref``,
which takes the cache transposed to ``(B, Hkv, S, d)``).

Layouts (the cache's native layout — nothing is transposed or padded):
  q        (B, Hkv, G, d)   G = query heads per KV head, any G >= 1
  k_codes  (B, S, Hkv, d)   int8        k_scales (B, S, Hkv) f32
  v_codes  (B, S, Hkv, d)   int8        v_scales (B, S, Hkv) f32
  lengths  (B,) int32       valid tokens per row (0 = idle)

``decode_attn_plan`` picks the kernel's split of each row from shapes
alone (never from ``lengths``, which would cost a host sync per call).
It is pure Python, so the CPU tests hold its invariants.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from ..core.qlinear import f32_reciprocal
from .build import H100_SMS, sm_count
from .split_attn import SMEM_LIMIT, TARGET_TOKENS, int32, scratch, smem_bytes

__all__ = ["quantize_token_kv", "decode_attn_plain", "decode_attn_call",
           "decode_attn_plan", "DecodeAttnPlan"]

_IO_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)
MIN_TOKENS = 16             # tokens of the shortest split a plan makes (shared memory allowing)
_lib = None


class DecodeAttnPlan(NamedTuple):
    tokens_per_split: int       # T: split z takes the row's tokens [z * T, (z + 1) * T)
    splits: int
    grid: Tuple[int, int, int]  # (B, Hkv, splits)
    workspace_elems: int        # f32 partials, B * Hkv * splits * G * (d + 2) (0 if one split)
    counters: int               # int32 per (row, kv head) (0 if one split)
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def decode_attn_plan(B: int, Hkv: int, G: int, d: int, S: int,
                     sms: int = H100_SMS) -> DecodeAttnPlan:
    """The kernel's split of each row, from shapes only.

    A split is at most ``TARGET_TOKENS`` tokens and as many as shared
    memory holds for its K, V and scales, so that one batch of copies
    brings all of them. Below that, splits are made shorter until
    ``B * Hkv * splits`` reaches two blocks per SM, where ``S`` allows,
    but not below ``MIN_TOKENS``: the last block of a row merges every
    live split's partials alone. S need not be a multiple of the split.
    """
    if d % 16:
        raise ValueError(f"d={d} is not a whole number of 16-byte copies")
    if smem_bytes(1, G, d, 1) > SMEM_LIMIT:
        raise ValueError(f"G={G}, d={d} need {smem_bytes(1, G, d, 1)} B of shared "
                         f"memory for one token (> {SMEM_LIMIT})")
    most = TARGET_TOKENS
    while most > 1 and smem_bytes(most, G, d, 1) > SMEM_LIMIT:
        most -= 1
    want = math.ceil(2 * sms / max(1, B * Hkv))
    T = min(most, max(MIN_TOKENS, S // want))
    splits = max(1, math.ceil(S / T))
    one = splits == 1
    return DecodeAttnPlan(T, splits, (B, Hkv, splits),
                          0 if one else B * Hkv * splits * G * (d + 2),
                          0 if one else B * Hkv, smem_bytes(T, G, d, 1))


def quantize_token_kv(t):
    """(..., d) -> int8 codes + per-(token, head) f32 scales (...), the
    layout the dense and paged int8 caches hold. The scale is absmax times
    the f32 reciprocal of 127, as the reference's compiled engines compute
    it (XLA turns the division by a constant into that product)."""
    absmax = t.to(torch.float32).abs().amax(dim=-1)
    scales = torch.where(absmax == 0, torch.ones_like(absmax),
                         absmax * f32_reciprocal(127.0))
    codes = torch.clamp(torch.round(t / scales[..., None]), -127, 127).to(torch.int8)
    return codes, scales


def decode_attn_plain(q, k_codes, k_scales, v_codes, v_scales, lengths,
                      sm_scale: float, out_dtype=torch.float32):
    """Plain PyTorch version: dequantize, masked softmax in f32.

    ``k_scales`` / ``v_scales`` may be None for a cache already held in a
    float type. Positions at or past ``lengths[b]`` get probability 0, so
    a row of length 0 returns zeros.
    """
    k = k_codes.to(torch.float32)
    v = v_codes.to(torch.float32)
    if k_scales is not None:
        k = k * k_scales[..., None]
        v = v * v_scales[..., None]
    scores = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32), k) * sm_scale
    pos = torch.arange(k.shape[1], device=q.device)
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, float("-inf"))
    p = torch.where(mask, torch.softmax(scores, dim=-1), 0.0)
    return torch.einsum("bhgs,bshd->bhgd", p, v).to(out_dtype)


def _library():
    global _lib
    if _lib is None:
        from .build import library
        lib = library("decode_attn")
        lib.decode_attn_launch.restype = ctypes.c_int
        lib.decode_attn_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 3)
        _lib = lib
    return _lib


def decode_attn_call(q, k_codes, k_scales, v_codes, v_scales, lengths, *,
                     sm_scale: float, out_dtype=torch.float32):
    """Launch the CUDA kernel on CUDA tensors; raises on anything else."""
    tensors = (q, k_codes, k_scales, v_codes, v_scales, lengths)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        raise ValueError("decode_attn_call takes CUDA tensors only")
    if k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8:
        raise ValueError(f"codes must be int8, got {k_codes.dtype}/{v_codes.dtype}")
    if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise ValueError("scales must be f32")
    if q.dtype not in _IO_DTYPES or out_dtype not in _IO_DTYPES:
        raise ValueError(f"q and out must be f32 or bf16, got {q.dtype}, {out_dtype}")
    B, Hkv, G, d = q.shape
    S = k_codes.shape[1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim must be one of {_HEAD_DIMS}, got {d}")
    if tuple(k_codes.shape) != (B, S, Hkv, d) or v_codes.shape != k_codes.shape:
        raise ValueError(f"codes {tuple(k_codes.shape)} do not match q {tuple(q.shape)}")
    if tuple(k_scales.shape) != (B, S, Hkv) or v_scales.shape != k_scales.shape:
        raise ValueError("scales must be (B, S, Hkv)")
    if tuple(lengths.shape) != (B,):
        raise ValueError("lengths must be (B,)")
    dev = q.device
    plan = decode_attn_plan(B, Hkv, G, d, S, sm_count(dev.index))
    q = q.contiguous()
    kc, vc = k_codes.contiguous(), v_codes.contiguous()
    ks, vs = k_scales.contiguous(), v_scales.contiguous()
    lens = int32(lengths)
    if kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError("codes must start on a 16-byte boundary (16-byte copies)")
    out = torch.empty((B, Hkv, G, d), dtype=out_dtype, device=dev)
    if B == 0 or Hkv == 0:
        return out
    # the current stream's handle in one call (torch.cuda.current_stream
    # builds a Stream object first, several µs of host time a launch)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ws = counters = None
    if plan.splits > 1:
        ws, counters = scratch(dev.index, stream, plan.workspace_elems, plan.counters)
    err = _library().decode_attn_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), kc.data_ptr(), ks.data_ptr(),
        vc.data_ptr(), vs.data_ptr(), lens.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), B, S, Hkv, G, d, float(sm_scale),
        plan.tokens_per_split, plan.splits, ws, counters, stream)
    if err != 0:
        raise RuntimeError(f"decode attention launch failed: CUDA error {err}")
    return out
