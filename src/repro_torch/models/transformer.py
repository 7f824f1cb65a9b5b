"""Paged decode self-attention and KV-cache helpers shared by the
decoder families (the enc-dec path of this slice uses them; the LM
family comes with a later slice).

The page pools are updated in place: the fresh token's K/V is written
into its page, and the caller keeps the same pool tensors.
"""

from __future__ import annotations

import torch

from ..kernels.decode_attn import quantize_token_kv as _quantize_token_kv
from ..kernels.paging import gather_pages, scatter_token
from .layers import decode_attn_apply, linear, rope

__all__ = ["paged_view", "paged_attn", "_quantize_token_kv", "_dense_kv",
           "_scatter_tokens", "_commit_decode_position"]


def paged_view(cache):
    """Decode-time view of a paged cache: per-slot write coordinates and
    the dense gather positions.

    Returns (positions (B, S_view) with -1 beyond each length, page_ids
    (B,), offsets (B,)) where S_view = maxp * ps. Idle slots (active=0)
    write to the trash page, and so does a write at or past S_view (a
    speculative round drafting past the chain's end; those positions are
    rolled back): clamped to the last page, it would overwrite a kept
    position there.
    """
    tables, lens, active = cache["block_tables"], cache["len"], cache["active"]
    B, maxp = tables.shape
    ps = (cache["k_codes"] if "k_codes" in cache else cache["k"]).shape[2]
    s_view = maxp * ps
    pos = torch.arange(s_view, dtype=torch.int32, device=lens.device).expand(B, s_view)
    pos = torch.where(pos < lens[:, None], pos, -1)
    rows = torch.arange(B, device=lens.device)
    page = lens // ps
    pid = tables[rows, torch.clamp(page, 0, maxp - 1).long()]
    pid = torch.where((active > 0) & (page < maxp), pid, 0)     # 0 = trash page
    off = torch.where(active > 0, lens % ps, 0)
    return pos, pid, off


def paged_attn(ctx, ap, x, positions, leaves, view_pos, pid, off, lengths_now,
               tables, *, use_kernel, num_heads, num_kv_heads, head_dim,
               rope_theta=1e4):
    """One layer of paged decode self-attention + KV commit.

    The gather path attends a dense chain view through decode_attn_apply
    (the fresh token at full precision) and then commits it; the kernel
    path commits first and attends the whole chain in the kernel.
    ``leaves`` is (k, v) for bf16/f32 pages or (codes, scales, codes,
    scales) for int8 pages. Returns (attn_out_projection, leaves).
    """
    if use_kernel:
        return _paged_attn_kernel_apply(
            ctx, ap, x, positions, leaves, pid, off, lengths_now, tables,
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            head_dim=head_dim, rope_theta=rope_theta)
    if len(leaves) == 4:                       # int8 pages
        kc, ksc, vc, vsc = leaves
        k_dense = _dense_kv(gather_pages(kc, tables), gather_pages(ksc, tables))
        v_dense = _dense_kv(gather_pages(vc, tables), gather_pages(vsc, tables))
    else:
        kc, vc = leaves
        k_dense = gather_pages(kc, tables)
        v_dense = gather_pages(vc, tables)
    y, k_new, v_new = decode_attn_apply(
        ctx, ap, x, positions, k_dense, v_dense, view_pos,
        num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
        rope_theta=rope_theta)
    _commit_token(leaves, k_new, v_new, pid, off)
    return y, leaves


def _commit_token(leaves, k_new, v_new, pid, off):
    """Write one fresh token per slot into its page (quantized on int8
    pools)."""
    if len(leaves) == 4:
        kc, ksc, vc, vsc = leaves
        nkc, nks = _quantize_token_kv(k_new)
        nvc, nvs = _quantize_token_kv(v_new)
        scatter_token(kc, nkc[:, 0], pid, off)
        scatter_token(ksc, nks[:, 0], pid, off)
        scatter_token(vc, nvc[:, 0], pid, off)
        scatter_token(vsc, nvs[:, 0], pid, off)
    else:
        kp, vp = leaves
        scatter_token(kp, k_new[:, 0], pid, off)
        scatter_token(vp, v_new[:, 0], pid, off)


def _paged_attn_kernel_apply(ctx, ap, x, positions, leaves, pid, off,
                             lengths_now, tables, *, num_heads, num_kv_heads,
                             head_dim, rope_theta=1e4):
    """Paged decode attention through the paged-attention kernel.

    Write-then-attend: the new token's K/V is committed to its page first
    (quantized on int8 pools), then one kernel call covers the whole
    chain at ``lengths_now`` = len + 1 (idle slots pass 0).
    """
    from ..kernels import ops as kops
    B = x.shape[0]
    H, Hkv, hd = num_heads, num_kv_heads, head_dim
    q = linear(ctx, x, ap["wq"], ap.get("bias_q")).reshape(B, 1, H, hd)
    k_new = linear(ctx, x, ap["wk"], ap.get("bias_k")).reshape(B, 1, Hkv, hd)
    v_new = linear(ctx, x, ap["wv"], ap.get("bias_v")).reshape(B, 1, Hkv, hd)
    q = rope(q, positions, rope_theta)
    k_new = rope(k_new, positions, rope_theta)
    _commit_token(leaves, k_new, v_new, pid, off)
    if len(leaves) == 4:
        kc, ksc, vc, vsc = leaves
        out = kops.paged_decode_attention(
            q[:, 0], kc, vc, tables, lengths_now, k_scales=ksc, v_scales=vsc,
            out_dtype=torch.float32)
    else:
        kp, vp = leaves
        out = kops.paged_decode_attention(q[:, 0], kp, vp, tables, lengths_now,
                                          out_dtype=torch.float32)
    y = ctx.dot(out.to(x.dtype).reshape(B, 1, H * hd), ap["wo"])
    return y, leaves


def _dense_kv(codes, scales):
    if scales is None:
        return codes
    return (codes.to(torch.float32) * scales[..., None]).to(torch.bfloat16)


def _scatter_tokens(cache, new, lens):
    """Insert (B, S_new, ...) rows into (B, Smax, ...) at per-row offsets,
    in place. An offset past ``Smax - S_new`` is clamped to it, as the
    reference's ``dynamic_update_slice`` clamps (a speculative round may
    run a slot past its budget; those positions are rolled back)."""
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    start = torch.clamp(lens.long(), 0, cache.shape[1] - new.shape[1])
    cols = start[:, None] + torch.arange(new.shape[1], device=cache.device)
    cache[rows, cols] = new.to(cache.dtype)
    return cache


def _commit_decode_position(new_cache, cache, positions):
    """Dense-cache epilogue of one decode step: record the written
    position and advance per-slot lengths, honoring an optional
    ``active`` mask (an inactive slot writes pos=-1 and keeps its len)."""
    active = cache.get("active")
    if active is None:
        new_cache["pos"] = _scatter_tokens(cache["pos"], positions, cache["len"])
        new_cache["len"] = cache["len"] + 1
    else:
        pos_val = torch.where(active[:, None] > 0, positions, -1)
        new_cache["pos"] = _scatter_tokens(cache["pos"], pos_val, cache["len"])
        new_cache["len"] = cache["len"] + (active > 0).to(cache["len"].dtype)
    return new_cache
