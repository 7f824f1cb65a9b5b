"""Paged decode self-attention and KV-cache helpers shared by the
decoder families (the enc-dec path of this slice uses them; the LM
family comes with a later slice).

The page pools are updated in place: the fresh token's K/V is written
into its page, and the caller keeps the same pool tensors.
"""

from __future__ import annotations

import torch

from ..core.qlinear import f32_reciprocal
from ..kernels.decode_attn import quantize_token_kv as _quantize_token_kv
from ..kernels.paging import gather_pages, scatter_token
from .layers import decode_attn_apply, linear, rope

__all__ = ["paged_view", "paged_attn", "SCALED_KV", "_quantize_token_kv",
           "_fp8_token_kv", "_token_kv_quantizer", "_dense_kv", "_scatter_tokens",
           "_commit_decode_position"]


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


def _token_kv_quantizer(codes_dtype):
    """Per-token KV quantizer matching a cache's storage dtype."""
    return _quantize_token_kv if codes_dtype == torch.int8 else _fp8_token_kv


def paged_attn(ctx, ap, x, positions, leaves, view_pos, pid, off, lengths_now,
               tables, *, use_kernel, num_heads, num_kv_heads, head_dim,
               rope_theta=1e4, site="attn"):
    """One layer of paged decode self-attention + KV commit.

    The gather path attends a dense chain view through decode_attn_apply
    (the fresh token at full precision) and then commits it; the kernel
    path commits first and attends the whole chain in the kernel.
    ``leaves`` is (k, v) for bf16/f32 pages or (codes, scales, codes,
    scales) for int8 / fp8 pages (the codes dtype picks the token
    quantizer). Returns (attn_out_projection, leaves).
    """
    if use_kernel:
        return _paged_attn_kernel_apply(
            ctx, ap, x, positions, leaves, pid, off, lengths_now, tables,
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            head_dim=head_dim, rope_theta=rope_theta, site=site)
    if len(leaves) == 4:                       # int8 / fp8 pages
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
        rope_theta=rope_theta, site=site)
    _commit_token(leaves, k_new, v_new, pid, off)
    return y, leaves


def _commit_token(leaves, k_new, v_new, pid, off):
    """Write one fresh token per slot into its page (quantized on int8 /
    fp8 pools)."""
    if len(leaves) == 4:
        kc, ksc, vc, vsc = leaves
        qfn = _token_kv_quantizer(kc.dtype)
        nkc, nks = qfn(k_new)
        nvc, nvs = qfn(v_new)
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
                             head_dim, rope_theta=1e4, site="attn"):
    """Paged decode attention through the paged-attention kernel.

    Write-then-attend: the new token's K/V is committed to its page first
    (quantized on int8 / fp8 pools), then one kernel call covers the whole
    chain at ``lengths_now`` = len + 1 (idle slots pass 0). The kernel
    computes QK / PV unquantized whatever ``ctx.attn_act_fmt`` says, as
    the reference's kernel does.
    """
    from ..kernels import ops as kops
    B = x.shape[0]
    H, Hkv, hd = num_heads, num_kv_heads, head_dim
    qkv = f"{site}.qkv"
    q = linear(ctx, x, ap["wq"], ap.get("bias_q"), site=qkv).reshape(B, 1, H, hd)
    k_new = linear(ctx, x, ap["wk"], ap.get("bias_k"), site=qkv).reshape(B, 1, Hkv, hd)
    v_new = linear(ctx, x, ap["wv"], ap.get("bias_v"), site=qkv).reshape(B, 1, Hkv, hd)
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
    y = ctx.dot(out.to(x.dtype).reshape(B, 1, H * hd), ap["wo"], site=f"{site}.out")
    return y, leaves


def _fp8_token_kv(t):
    """(..., d) -> float8 e4m3 codes + per-(token, head) f32 scales (...),
    the layout the dense and paged fp8 caches hold."""
    absmax = t.to(torch.float32).abs().amax(dim=-1)
    # absmax / 448 as the reference's compiled step computes it
    scales = torch.where(absmax == 0, torch.ones_like(absmax),
                         absmax * f32_reciprocal(448.0))
    codes = (t / scales[..., None]).to(torch.float8_e4m3fn)
    return codes, scales


# the scaled KV layouts: the codes' storage dtype, the codes' key suffix
# ("k_codes" for int8, "k" for fp8) and the per-token quantizer
SCALED_KV = {"int8": (torch.int8, "_codes", _quantize_token_kv),
             "fp8": (torch.float8_e4m3fn, "", _fp8_token_kv)}


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
