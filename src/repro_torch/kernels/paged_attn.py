"""Flash-decode attention over a block-paged KV cache (int8, fp8 or bf16).

vLLM-style paged attention for the serving engine: the KV cache lives in
a shared pool of fixed-size pages, and each sequence owns a chain of
pages named by its row of the block table. ``paged_attn_call`` launches
the hand-written CUDA kernel (``csrc/paged_attn.cu``), which splits each
chain over blocks and reads the pages in place; ``paged_attn_plain``
gathers the chains densely and computes the same function in plain
PyTorch.

Layouts (the pool's native layout — nothing is transposed):
  q            (B, Hkv, G, d)     G = query heads per KV head
  k_pages      (P, ps, Hkv, d)    int8 / float8_e4m3fn codes or bf16
  k_scales     (P, ps, Hkv) f32   None on the bf16 path
  block_tables (B, maxp) int32    out-of-chain entries name the trash page
  lengths      (B,) int32         valid tokens per sequence (0 = idle)

``paged_attn_plan`` picks the kernel's split of the chain from shapes
alone (never from ``lengths``, which would cost a host sync per layer).
It is pure Python, so the CPU tests hold its invariants.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from .build import H100_SMS, sm_count
from .decode_attn import decode_attn_plain
from .paging import gather_pages
from .split_attn import SMEM_LIMIT, TARGET_TOKENS, int32, scratch, smem_bytes

__all__ = ["paged_attn_plain", "paged_attn_call", "paged_attn_plan", "PagedAttnPlan"]

_KV_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
_IO_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


class PagedAttnPlan(NamedTuple):
    pages_per_split: int
    tokens_per_split: int
    splits: int                 # split z takes the chain's pages [z * pps, (z + 1) * pps)
    grid: Tuple[int, int, int]  # (B, Hkv, splits)
    workspace_elems: int        # f32 partials, B * Hkv * splits * G * (d + 2) (0 if one split)
    counters: int               # int32 per (row, kv head) (0 if one split)
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def paged_attn_plan(B: int, Hkv: int, G: int, d: int, ps: int, maxp: int,
                    sms: int = H100_SMS, kv_bytes: int = 1) -> PagedAttnPlan:
    """The kernel's split of each chain, from shapes only.

    A split is a whole number of pages, at most ``TARGET_TOKENS`` tokens
    (one page if a page is longer) and as many as shared memory holds for
    its K, V and scales, so that one batch of copies brings all of them.
    Below that, splits are made shorter until ``B * Hkv * splits`` reaches
    two blocks per SM, where ``maxp`` allows.
    """
    if d * kv_bytes % 16:
        raise ValueError(f"d={d} x {kv_bytes} B is not a whole number of 16-byte copies")
    most = max(1, TARGET_TOKENS // ps)
    while most > 1 and smem_bytes(most * ps, G, d, kv_bytes, most) > SMEM_LIMIT:
        most -= 1
    if smem_bytes(ps, G, d, kv_bytes, 1) > SMEM_LIMIT:
        raise ValueError(f"G={G}, d={d}, ps={ps} need {smem_bytes(ps, G, d, kv_bytes, 1)} "
                         f"B of shared memory for one page (> {SMEM_LIMIT})")
    want = math.ceil(2 * sms / max(1, B * Hkv))
    pps = max(1, min(most, maxp // want))
    splits = max(1, math.ceil(maxp / pps))
    one = splits == 1
    return PagedAttnPlan(pps, pps * ps, splits, (B, Hkv, splits),
                         0 if one else B * Hkv * splits * G * (d + 2),
                         0 if one else B * Hkv,
                         smem_bytes(pps * ps, G, d, kv_bytes, pps))


def paged_attn_plain(q, k_pages, k_scales, v_pages, v_scales, block_tables,
                     lengths, sm_scale: float, out_dtype=torch.float32):
    """Plain PyTorch version: gather the chains dense (B, S, Hkv, d), then
    the dense decode attention's plain version."""
    def dense(t):
        return None if t is None else gather_pages(t, block_tables)
    return decode_attn_plain(q, dense(k_pages), dense(k_scales), dense(v_pages),
                             dense(v_scales), lengths, sm_scale, out_dtype)


def _library():
    global _lib
    if _lib is None:
        from .build import library
        lib = library("paged_attn")
        lib.paged_attn_launch.restype = ctypes.c_int
        lib.paged_attn_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 3)
        _lib = lib
    return _lib


def paged_attn_call(q, k_pages, k_scales, v_pages, v_scales, block_tables,
                    lengths, *, sm_scale: float, out_dtype=torch.float32):
    """Launch the CUDA kernel on CUDA tensors; raises on anything else."""
    tensors = [q, k_pages, v_pages, block_tables, lengths]
    quantized = k_scales is not None
    if quantized:
        tensors += [k_scales, v_scales]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_attn_call takes CUDA tensors only")
    if k_pages.dtype not in _KV_KINDS or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"pages must be one of {list(_KV_KINDS)}, got "
                         f"{k_pages.dtype}/{v_pages.dtype}")
    if quantized != (k_pages.dtype != torch.bfloat16) or (v_scales is None) == quantized:
        raise ValueError("int8/fp8 pages need k and v scales; bf16 pages take none")
    if q.dtype not in _IO_DTYPES or out_dtype not in _IO_DTYPES:
        raise ValueError(f"q and out must be f32 or bf16, got {q.dtype}, {out_dtype}")
    B, Hkv, G, d = q.shape
    P, ps = k_pages.shape[:2]
    maxp = block_tables.shape[1]
    if tuple(k_pages.shape) != (P, ps, Hkv, d) or v_pages.shape != k_pages.shape:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    if quantized and (tuple(k_scales.shape) != (P, ps, Hkv)
                      or v_scales.shape != k_scales.shape
                      or k_scales.dtype != torch.float32
                      or v_scales.dtype != torch.float32):
        raise ValueError("scales must be f32 (P, ps, Hkv)")
    if tuple(block_tables.shape) != (B, maxp) or tuple(lengths.shape) != (B,):
        raise ValueError("block_tables must be (B, maxp) and lengths (B,)")
    dev = q.device
    plan = paged_attn_plan(B, Hkv, G, d, ps, maxp, sm_count(dev.index),
                           kv_bytes=k_pages.element_size())
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("pages must start on a 16-byte boundary (16-byte copies)")
    tables, lens = int32(block_tables), int32(lengths)
    ks = k_scales.contiguous() if quantized else None
    vs = v_scales.contiguous() if quantized else None
    out = torch.empty((B, Hkv, G, d), dtype=out_dtype, device=dev)
    if B == 0:
        return out
    # the current stream's handle in one call (torch.cuda.current_stream
    # builds a Stream object first, several µs of host time a launch)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ws = counters = None
    if plan.splits > 1:
        ws, counters = scratch(dev.index, stream, plan.workspace_elems, plan.counters)
    err = _library().paged_attn_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
        ks.data_ptr() if quantized else None, v_pages.data_ptr(),
        vs.data_ptr() if quantized else None, tables.data_ptr(),
        lens.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
        B, Hkv, G, d, ps, maxp, _KV_KINDS[k_pages.dtype], float(sm_scale),
        plan.pages_per_split, plan.splits, ws, counters, stream)
    if err != 0:
        raise RuntimeError(f"paged attention launch failed: CUDA error {err}")
    return out
