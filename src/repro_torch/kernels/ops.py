"""Public, shape-safe wrappers around the kernels.

A wrapper given CPU tensors computes the kernel's plain PyTorch version;
given CUDA tensors it launches the hand-written kernel, or raises — no
build or launch failure falls back. ``LAUNCHES`` counts the kernel
launches of each wrapper (plain-version calls are not counted), so a run
can show that its path went through the kernels.
"""

from __future__ import annotations

import torch

from ..core.formats import get_format
from ..core.qtensor import QTensor
from . import decode_attn as _da
from . import fasst as _fasst
from . import paged_attn as _pa
from . import qmm as _qmm

__all__ = ["qmm", "fasst", "fasst_softmax", "decode_attention",
           "paged_decode_attention", "quantize_kv", "LAUNCHES",
           "reset_launches"]

LAUNCHES = {"qmm": 0, "paged_attn": 0, "fasst_act": 0, "decode_attn": 0,
            "fasst_softmax": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def qmm(x: torch.Tensor, w: QTensor, *, compute_dtype=torch.bfloat16):
    """x @ dequant(w) through the fused dequant-matmul kernel.

    Accepts x of shape (..., K); w is an unbatched (K, N) QTensor
    quantized along q_axis=-2. The kernel masks ragged tile edges
    itself, so rows and columns need no padding.
    """
    fmt = get_format(w.fmt)
    K = w.data.shape[-2] * (2 if fmt.bits == 4 else 1)
    N = w.data.shape[-1]
    sub_block = K // w.scales_shape[-2]
    # every call of a decode step comes through here: no view or cast
    # that is not needed
    x2 = x if x.dim() == 2 else x.reshape(-1, K)
    if x2.dtype != compute_dtype:
        x2 = x2.to(compute_dtype)
    scales = w.block_scales()
    if x2.is_cuda:
        y = _qmm.qmm_kernel_call(x2, w.data, scales, fmt_name=w.fmt,
                                 sub_block=sub_block, out_dtype=compute_dtype)
        LAUNCHES["qmm"] += 1
    else:
        y = _qmm.qmm_plain(x2, w.data, scales, w.fmt, out_dtype=compute_dtype)
    return y if x.dim() == 2 else y.reshape(*x.shape[:-1], N)


def fasst(x: torch.Tensor, mode: str, *, out_dtype=None):
    """Reconfigurable NAF (paper's FASST): elementwise over any shape."""
    if x.is_cuda:
        y = _fasst.fasst_act_call(x, mode=mode, out_dtype=out_dtype)
        LAUNCHES["fasst_act"] += 1
        return y
    return _fasst.fasst_act_plain(x, mode, out_dtype=out_dtype)


def fasst_softmax(x: torch.Tensor, *, scale: float = 1.0, valid_cols: int = -1,
                  out_dtype=None):
    """Fused row softmax over the last axis of any shape: x * scale,
    columns at or past ``valid_cols`` masked to exactly 0 (``< 0`` means
    all, ``> C`` clamps to C), f32 inside, one cast to ``out_dtype``."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x2.is_cuda:
        y = _fasst.fasst_softmax_call(x2, scale=scale, valid_cols=valid_cols,
                                      out_dtype=out_dtype)
        LAUNCHES["fasst_softmax"] += 1
    else:
        y = _fasst.fasst_softmax_plain(x2, scale=scale, valid_cols=valid_cols,
                                       out_dtype=out_dtype)
    return y.reshape(shape)


def quantize_kv(kv: torch.Tensor):
    """Per-(token, head) int8 quantization of a (..., d) KV tensor:
    codes int8 and f32 scales (..., ), as the dense and paged caches hold."""
    return _da.quantize_token_kv(kv)


def decode_attention(q, k_codes, k_scales, v_codes, v_scales, lengths, *,
                     sm_scale: float | None = None, out_dtype=torch.bfloat16):
    """GQA decode attention against a dense int8 KV cache.

    q (B, H, d); k/v codes (B, S, Hkv, d) int8; scales (B, S, Hkv) f32;
    lengths (B,) valid tokens per row. Returns (B, H, d).
    """
    B, H, d = q.shape
    Hkv = k_codes.shape[2]
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    qg = q.reshape(B, Hkv, H // Hkv, d)
    if q.is_cuda:
        out = _da.decode_attn_call(qg, k_codes, k_scales, v_codes, v_scales,
                                   lengths, sm_scale=sm_scale, out_dtype=out_dtype)
        LAUNCHES["decode_attn"] += 1
    else:
        out = _da.decode_attn_plain(qg, k_codes, k_scales, v_codes, v_scales,
                                    lengths, sm_scale, out_dtype=out_dtype)
    return out.reshape(B, H, d)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           k_scales=None, v_scales=None,
                           sm_scale: float | None = None,
                           out_dtype=torch.bfloat16):
    """GQA decode attention against a block-paged KV cache.

    q (B, H, d); k/v pages (P, ps, Hkv, d) — int8 / fp8 codes with
    (P, ps, Hkv) f32 scales, or bf16 with scales=None; block_tables
    (B, maxp) page ids (out-of-chain entries name the trash page);
    lengths (B,). Returns (B, H, d).
    """
    B, H, d = q.shape
    Hkv = k_pages.shape[2]
    G = H // Hkv
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    qg = q.reshape(B, Hkv, G, d)
    if q.is_cuda:
        out = _pa.paged_attn_call(qg, k_pages, k_scales, v_pages, v_scales,
                                  block_tables, lengths, sm_scale=sm_scale,
                                  out_dtype=out_dtype)
        LAUNCHES["paged_attn"] += 1
    else:
        out = _pa.paged_attn_plain(qg, k_pages, k_scales, v_pages, v_scales,
                                   block_tables, lengths, sm_scale,
                                   out_dtype=out_dtype)
    return out.reshape(B, H, d)
