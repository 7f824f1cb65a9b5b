"""Flash-decode attention over a dense int8 KV cache.

The dense serving cache holds per layer int8 codes ``(B, S, Hkv, d)``
with one f32 scale per (token, head) ``(B, S, Hkv)``, and per-row valid
lengths. ``decode_attn_call`` launches the hand-written CUDA kernel
(``csrc/decode_attn.cu``), which reads that layout in place;
``decode_attn_plain`` computes the same function in plain PyTorch (the
counterpart of the JAX package's ``kernels/ref.py::decode_attn_ref``,
which takes the cache transposed to ``(B, Hkv, S, d)``).

Layouts (the cache's native layout — nothing is transposed or padded):
  q        (B, Hkv, G, d)   G = query heads per KV head, any G >= 1
  k_codes  (B, S, Hkv, d)   int8        k_scales (B, S, Hkv) f32
  v_codes  (B, S, Hkv, d)   int8        v_scales (B, S, Hkv) f32
  lengths  (B,) int32       valid tokens per row (0 = idle)
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["quantize_token_kv", "decode_attn_plain", "decode_attn_call"]

_IO_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)
_TILE = 64                      # tokens per shared-memory tile (decode_attn.cu)
_SMEM_LIMIT = 48 * 1024
_lib = None


def quantize_token_kv(t):
    """(..., d) -> int8 codes + per-(token, head) f32 scales (...), the
    layout the dense and paged int8 caches hold."""
    absmax = t.to(torch.float32).abs().amax(dim=-1)
    scales = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
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
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
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
    smem = 4 * (2 * G * d + G * _TILE + 3 * G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"G={G}, d={d} need {smem} B of shared memory (> {_SMEM_LIMIT})")
    q = q.contiguous()
    kc, vc = k_codes.contiguous(), v_codes.contiguous()
    ks, vs = k_scales.contiguous(), v_scales.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, Hkv, G, d), dtype=out_dtype, device=q.device)
    if B == 0 or Hkv == 0:
        return out
    err = _library().decode_attn_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), kc.data_ptr(), ks.data_ptr(),
        vc.data_ptr(), vs.data_ptr(), lens.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), B, S, Hkv, G, d, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode attention launch failed: CUDA error {err}")
    return out
