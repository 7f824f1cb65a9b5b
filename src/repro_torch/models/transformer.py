"""Decoder-only LMs (the dense, MoE, VLM and SSM families), and the paged
decode self-attention and KV-cache helpers that the decoder families
share.

One skeleton: embed (times sqrt(d) when ``embed_scale``; a VLM prepends
its stub patch embeddings) -> the layer stack -> final norm -> head
(the tied, dequantized embedding or ``lm_head``). Each layer is pre-norm
self-attention (GQA, optional QKV bias and q/k RMS norm, a per-layer
local window from ``window_pattern``) then the FFN (GLU or plain), or
top-k experts in an MoE LM: capacity dispatch over the whole sequence
(forward, prefill; the aux losses summed), dropless in the decode steps.
Layer parameters are stacked on a leading ``L`` axis, as in the
reference; the stacks run as Python loops over per-layer slices.

An SSM (Mamba-2) layer is pre-norm SSD with no FFN (``models/ssm.py``);
its serving cache is recurrent, ``conv`` (L, B, 3, conv_dim) bf16 and
``ssd`` (L, B, nh, hp, ds) f32 states and ``len``, with no paged layout.

Serving caches are updated in place: prefill writes into the cache it is
given, and a decode step writes the fresh token into its dense row or
its page. A cache holds its K/V in one of three layouts, told apart by
its keys (``_kv_layout``): int8 (``k_codes`` + ``k_scales``), fp8
(float8 ``k`` + ``k_scales``) or float (``k`` alone).
"""

from __future__ import annotations

import torch

from ..core.qlinear import embed_lookup, f32_reciprocal
from ..core.qtensor import QTensor, maybe_dequantize
from ..kernels.decode_attn import quantize_token_kv as _quantize_token_kv
from ..kernels.paging import gather_pages, scatter_token
from ..random import split
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (Ctx, _qk_norm, attention_init, attn_apply, decode_attn_apply,
                     linear, mlp_init, normal_init, rank_ctx, remat as _remat, rms_norm,
                     rope, seq_block, seq_rows, stack_layers)

__all__ = ["paged_view", "paged_attn", "SCALED_KV", "_quantize_token_kv",
           "_fp8_token_kv", "_token_kv_quantizer", "_dense_kv", "_scatter_tokens",
           "_scatter_rows", "_commit_decode_position", "window_array", "lm_init", "lm_forward",
           "lm_init_cache", "lm_init_paged_cache", "lm_prefill", "lm_decode_step",
           "lm_paged_decode_step"]


# ---------------------------------------------------------------------------
# shared helpers: layer slices, positions, the head, cache layouts
# ---------------------------------------------------------------------------

def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.select(i)
    return tree[i]


def _layers(tree, n: int) -> list:
    """The ``n`` layer slices of a layer-stacked tree at once. A tensor
    leaf is unbound: its backward stacks the ``n`` gradients in one node,
    where ``n`` separate selects would each add a zero-filled full-stack
    gradient (O(n^2) bytes over a training step)."""
    if isinstance(tree, dict):
        parts = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, QTensor):
        return [tree.select(i) for i in range(n)]
    return list(tree.unbind(0))


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _head(ctx: Ctx, params, cfg, x, read=None):
    """Logits of the final-normed ``x``: the tied embedding, dequantized,
    in a plain product outside any kernel (as in the reference), or the
    ``lm_head`` matmul. ``read`` (B,) keeps one row a batch entry, (B, V)
    (a negative index counts from the end): the rows of the logits the
    caller samples from, picked after the product, so every product keeps
    its rows. A tensor-parallel rank holding a vocabulary slice gathers
    the slices (``Ctx.tp``), the picked rows only."""
    if cfg.tie_embeddings:
        w = maybe_dequantize(params["embedding"], ctx.compute_dtype)
        logits = torch.matmul(x.to(ctx.compute_dtype), w.t())
    else:
        logits = ctx.dot(x, params["lm_head"], site="head")
    logits = logits.to(torch.float32)
    if read is not None:
        logits = logits[torch.arange(logits.shape[0], device=logits.device), read.long()]
    if ctx.tp is not None and logits.shape[-1] != cfg.vocab_size:
        logits = ctx.tp.gather(logits, -1)
    return logits


def _embed_rows(ctx: Ctx, params, cfg, ids):
    """Embedding rows of ``ids`` (dequantized rows of an int8 table); a
    tensor-parallel rank holding a vocabulary slice sums the slices'
    rows over the ranks (``Ctx.tp``)."""
    table = params["embedding"]
    if ctx.tp is not None and table.shape[0] != cfg.vocab_size:
        return ctx.tp.embed(table, ids, ctx.compute_dtype)
    return embed_lookup(table, ids, ctx.compute_dtype)


def _kv_layout(cache) -> str:
    """"int8" (codes + scales), "fp8" (float8 K/V + scales, no codes) or
    "float" (bf16 / f32 K/V): the key test every cache reader goes
    through, so fp8 codes are never read as unscaled K/V."""
    if "k_codes" in cache:
        return "int8"
    return "fp8" if "k_scales" in cache else "float"


_KV_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _kv_leaves(prefix: str, L, B, S, Hkv, hd, kv_dtype, device):
    if kv_dtype in SCALED_KV:
        dt, sfx, _ = SCALED_KV[kv_dtype]
        return {f"{prefix}k{sfx}": torch.zeros((L, B, S, Hkv, hd), dtype=dt, device=device),
                f"{prefix}k_scales": torch.zeros((L, B, S, Hkv), device=device),
                f"{prefix}v{sfx}": torch.zeros((L, B, S, Hkv, hd), dtype=dt, device=device),
                f"{prefix}v_scales": torch.zeros((L, B, S, Hkv), device=device)}
    if kv_dtype not in _KV_DTYPES:
        raise ValueError(f"KV cache format must be one of "
                         f"{sorted(SCALED_KV) + sorted(_KV_DTYPES)}, got {kv_dtype!r}")
    dt = _KV_DTYPES[kv_dtype]
    return {f"{prefix}k": torch.zeros((L, B, S, Hkv, hd), dtype=dt, device=device),
            f"{prefix}v": torch.zeros((L, B, S, Hkv, hd), dtype=dt, device=device)}


def _self_leaves(cache, i: int, layout: str):
    """Layer ``i``'s self-attention K/V leaves: the cache's own tensors,
    for in-place writes; (k, v) or (codes, scales, codes, scales)."""
    if layout == "float":
        return cache["k"][i], cache["v"][i]
    sfx = SCALED_KV[layout][1]
    return (cache[f"k{sfx}"][i], cache["k_scales"][i],
            cache[f"v{sfx}"][i], cache["v_scales"][i])


def _commit_prefill(cache, ks, vs, lens, ctx):
    """Write a prompt's layer-stacked K/V (L, B, S, Hkv, hd) into the
    dense cache's first S positions (quantized on int8 / fp8 caches), in
    place, with its positions (-1 past each length) and lengths. A rank
    holding a block of the cache's rows (``seq_rows``) writes the part of
    the prompt that falls in it (``ctx.tp``'s rank)."""
    B, S = ks.shape[1], ks.shape[2]
    layout = _kv_layout(cache)
    rows = (cache["k_codes"] if layout == "int8" else cache["k"]).shape[2]
    lo = seq_block(ctx.tp, rows, cache["pos"].shape[1])
    n = max(0, min(S, lo + rows) - lo)
    positions = _positions(B, S, ks.device)
    cache["pos"][:, :S] = torch.where(positions < lens[:, None], positions, -1)
    cache["len"] = lens.to(torch.int32)
    ks, vs, S = ks[:, :, lo:lo + n], vs[:, :, lo:lo + n], n
    if layout != "float":
        _, sfx, qfn = SCALED_KV[layout]
        for name, t in (("k", ks), ("v", vs)):
            codes, scales = qfn(t)
            cache[f"{name}{sfx}"][:, :, :S] = codes
            cache[f"{name}_scales"][:, :, :S] = scales
    else:
        cache["k"][:, :, :S] = ks.to(cache["k"].dtype)
        cache["v"][:, :, :S] = vs.to(cache["v"].dtype)
    return cache


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
               window=0, rope_theta=1e4, norm_eps=1e-6, site="attn"):
    """One layer of paged decode self-attention + KV commit.

    The gather path attends a dense chain view through decode_attn_apply
    (the fresh token at full precision) and then commits it; the kernel
    path commits first and attends the whole chain in the kernel.
    ``leaves`` is (k, v) for bf16/f32 pages or (codes, scales, codes,
    scales) for int8 / fp8 pages (the codes dtype picks the token
    quantizer). The kernel has no local-window mask: a caller with a
    ``window`` passes ``use_kernel=False``. Returns (attn_out_projection,
    leaves).
    """
    if use_kernel:
        return _paged_attn_kernel_apply(
            ctx, ap, x, positions, leaves, pid, off, lengths_now, tables,
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            head_dim=head_dim, rope_theta=rope_theta, norm_eps=norm_eps, site=site)
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
        window=window, rope_theta=rope_theta, norm_eps=norm_eps, site=site)
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
                             head_dim, rope_theta=1e4, norm_eps=1e-6, site="attn"):
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
    q, k_new = _qk_norm(ap, q, k_new, norm_eps)
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


def _scatter_rows(ctx, leaf, new, lens, whole: int):
    """``_scatter_tokens`` of one fresh token a row, ``new`` (B, 1, ...),
    into a dense cache leaf (B, rows, ...) of ``whole`` positions. A rank
    holding a block of the rows (``seq_rows``) writes the rows whose
    position falls in its block and keeps the others, with no host sync
    (a masked write, where a boolean index would wait for the device)."""
    rows = leaf.shape[1]
    if rows == whole:
        return _scatter_tokens(leaf, new, lens)
    at = torch.clamp(lens.long(), 0, whole - 1) - seq_block(ctx.tp, rows, whole)
    own = ((at >= 0) & (at < rows)).view((-1,) + (1,) * (new.dim() - 2))
    b = torch.arange(leaf.shape[0], device=leaf.device)
    at = at.clamp(0, rows - 1)
    leaf[b, at] = torch.where(own, new[:, 0].to(leaf.dtype), leaf[b, at])
    return leaf


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


# ---------------------------------------------------------------------------
# the decoder-only LM: init, forward, caches, prefill, decode
# ---------------------------------------------------------------------------

def _check_family(cfg):
    if cfg.family not in ("dense", "vlm", "moe", "ssm"):
        raise ValueError(f"{cfg.name}: unknown decoder-only LM family {cfg.family!r}")


def window_array(cfg) -> list:
    """Per-layer attention window (0 = full): gemma3's 5:1 local:global
    pattern, cycled over the stack."""
    pat = cfg.window_pattern or (0,)
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def _layer_init(key, cfg):
    """One layer's parameters from its key, as the reference's
    ``_layer_init`` draws them: ``k1`` the mixer (attention or SSD),
    ``k2`` the FFN; an SSM layer has no FFN and no ``norm2_scale``."""
    k1, k2 = split(key)
    ones = torch.ones((cfg.d_model,), dtype=torch.float32, device=key.device)
    if cfg.family == "ssm":
        return {"norm1_scale": ones, "ssm": ssm_mod.ssm_init(k1, cfg.d_model, cfg.ssm)}
    p = {"norm1_scale": ones, "norm2_scale": ones,
         "attn": attention_init(k1, None, cfg)}
    if cfg.moe is not None:
        p["moe"] = moe_mod.moe_init(k2, cfg.d_model, cfg.d_ff, cfg.moe.num_experts,
                                    cfg.mlp_act)
    else:
        p["mlp"] = mlp_init(k2, None, cfg)
    return p


def lm_init(g, cfg):
    """Random parameters with the reference's shapes and scales: drawn
    from the torch.Generator ``g`` on its device, or, for a key from
    ``random.prng_key(seed)``, the reference's own ``lm_init`` draws for
    that seed (each layer from its key of ``split(kl, L)``, stacked)."""
    _check_family(cfg)
    L, d = cfg.num_layers, cfg.d_model

    def ones(*shape):
        return torch.ones(shape + (d,), dtype=torch.float32, device=g.device)

    kh = g
    if isinstance(g, torch.Tensor):
        ke, kl, kh = split(g, 3)
        embedding = normal_init(ke, (cfg.vocab_size, d), 0.02)
        layers = stack_layers([_layer_init(k, cfg) for k in split(kl, L)])
    elif cfg.family == "ssm":
        embedding = normal_init(g, (cfg.vocab_size, d), 0.02)
        layers = {"norm1_scale": ones(L), "ssm": ssm_mod.ssm_init(g, d, cfg.ssm, L)}
    else:
        # the draw order of the seeded init: FFN, embedding, attention
        ffn_params = {"mlp": mlp_init(g, L, cfg)} if cfg.moe is None else {
            "moe": moe_mod.moe_init(g, d, cfg.d_ff, cfg.moe.num_experts, cfg.mlp_act,
                                    layers=L)}
        embedding = normal_init(g, (cfg.vocab_size, d), 0.02)
        layers = {"norm1_scale": ones(L), "norm2_scale": ones(L),
                  "attn": attention_init(g, L, cfg), **ffn_params}
    params = {"embedding": embedding, "layers": layers, "norm_f_scale": ones()}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(kh, (d, cfg.vocab_size), d ** -0.5)
    return params


def _embed(ctx: Ctx, params, cfg, tokens, img_embeds=None):
    """Token embeddings (times sqrt(d) rounded to the compute dtype, as
    the reference scales them; a tensor-parallel rank's rows summed over
    the ranks first), after a VLM's patch embeddings."""
    x = _embed_rows(ctx, params, cfg, tokens)
    if cfg.embed_scale:
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=ctx.compute_dtype))
    if img_embeds is not None:
        x = torch.cat([img_embeds.to(device=x.device, dtype=ctx.compute_dtype), x], dim=1)
    return x


def _lm_head(ctx: Ctx, params, cfg, x, read=None):
    return _head(ctx, params, cfg, rms_norm(x, params["norm_f_scale"], cfg.norm_eps), read)


def _ssm_layer(ctx: Ctx, cfg, lp, x, state=None):
    """x + SSD(norm(x)) from the zero SSD state; with ``state`` (the
    cache's conv state) also returns the new (conv, SSD) states."""
    ctx = rank_ctx(ctx, cfg, "ssd")
    h = rms_norm(x, lp["norm1_scale"], cfg.norm_eps)
    if state is None:
        return x + ssm_mod.ssm_apply(ctx, lp["ssm"], h, d_model=cfg.d_model,
                                     ssm_cfg=cfg.ssm)
    y, st = ssm_mod.ssm_apply(ctx, lp["ssm"], h, d_model=cfg.d_model, ssm_cfg=cfg.ssm,
                              conv_state=state, return_state=True)
    return x + y, st


def _lm_layer(ctx: Ctx, cfg, lp, window, x, positions):
    h = rms_norm(x, lp["norm1_scale"], cfg.norm_eps)
    y, kv = attn_apply(rank_ctx(ctx, cfg, "attn"), lp["attn"], h, positions,
                       num_heads=cfg.num_heads,
                       num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                       causal=True, window=window, rope_theta=cfg.rope_theta,
                       norm_eps=cfg.norm_eps)
    x = x + y
    h = rms_norm(x, lp["norm2_scale"], cfg.norm_eps)
    y, aux = moe_mod.layer_ffn(ctx, cfg, lp, h)
    return x + y, aux, kv


def lm_forward(ctx: Ctx, params, cfg, tokens, positions=None, img_embeds=None,
               remat: bool = False, collect_kv: bool = False, read=None):
    """tokens (B, S) [after img_embeds (B, P, d)] -> (logits (B, P + S, V)
    f32, aux_loss (the MoE layers' summed; 0 without), (ks, vs)
    layer-stacked (L, B, P + S, Hkv, hd) | None). ``remat`` recomputes
    each layer's activations in the backward pass (the reference's
    grouped remat scan is a memory plan over the same function). ``read``
    (B,) returns the logits (B, V) of one position a row (``_head``)."""
    _check_family(cfg)
    x = _embed(ctx, params, cfg, tokens, img_embeds)
    B, S, _ = x.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        body = _remat(lambda x, lp: _ssm_layer(ctx, cfg, lp, x), remat)
        for lp in _layers(params["layers"], cfg.num_layers):
            x = body(x, lp)
        return _lm_head(ctx, params, cfg, x, read), aux, None
    if positions is None:
        positions = _positions(B, S, x.device)
    ks, vs = [], []
    for lp, window in zip(_layers(params["layers"], cfg.num_layers), window_array(cfg)):
        body = _remat(lambda x, lp, w=window: _lm_layer(ctx, cfg, lp, w, x, positions),
                      remat)
        x, aux_l, (k, v) = body(x, lp)
        if aux_l is not None:
            aux = aux + aux_l
        if collect_kv:
            ks.append(k)
            vs.append(v)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return _lm_head(ctx, params, cfg, x, read), aux, kvs


def lm_init_cache(cfg, batch: int, max_len: int, kv_dtype: str = "bf16", device="cuda",
                  seq_split: bool = True):
    """Dense serving cache: K/V at ``max_len`` per slot (a rank's block of
    them under the sequence split, ``seq_rows``, unless ``seq_split`` is
    off), ``pos`` -1 where empty, ``len`` per slot; an SSM's recurrent
    states (a rank's widths, ``ssm.ssd_ranks``) and ``len``."""
    _check_family(cfg)
    if cfg.family == "ssm":
        conv, ssd = ssm_mod.ssm_init_state(batch, cfg.d_model, cfg.ssm, device,
                                           ssm_mod.ssd_ranks(cfg))
        L = cfg.num_layers
        return {"conv": conv.expand(L, *conv.shape).clone(),
                "ssd": ssd.expand(L, *ssd.shape).clone(),
                "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    cache = {"pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
             "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    rows = seq_rows(cfg, max_len) if seq_split else max_len
    cache.update(_kv_leaves("", cfg.num_layers, batch, rows, cfg.num_kv_heads,
                            cfg.head_dim, kv_dtype, device))
    return cache


def lm_init_paged_cache(cfg, slots: int, max_pages: int, num_pages: int,
                        page_size: int, kv_dtype: str = "bf16", device="cuda"):
    """Block-paged serving cache: a shared page pool (page 0 the reserved
    trash page) and a block table of ``max_pages`` entries per slot."""
    from ..serving.paged_cache import TRASH_PAGE, init_paged_kv
    _check_family(cfg)
    if cfg.family == "ssm":
        raise ValueError("paged KV caches need an attention family; "
                         "ssm states are O(1) per sequence already")
    cache = init_paged_kv(cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                          cfg.head_dim, kv_dtype, device)
    cache["block_tables"] = torch.full((slots, max_pages), TRASH_PAGE,
                                       dtype=torch.int32, device=device)
    cache["len"] = torch.zeros((slots,), dtype=torch.int32, device=device)
    cache["active"] = torch.zeros((slots,), dtype=torch.int32, device=device)
    return cache


def lm_prefill(ctx: Ctx, params, cfg, tokens, cache, lengths=None, img_embeds=None,
               positions=None, read=None):
    """Run the whole prompt (after a VLM's patches) and fill the cache's
    first P + S positions. Returns (cache, logits (B, P + S, V)), or with
    ``read`` (B,) the logits (B, V) of one position a row: the rows a
    tensor-parallel rank gathers (``_head``).

    An SSM runs layer by layer from the cache's states and returns the
    final ones (the conv state in the compute dtype: a caller that keeps
    the cache casts it, as the engine's splice does)."""
    if cfg.family == "ssm":
        x = _embed(ctx, params, cfg, tokens)
        convs, ssds = [], []
        for i in range(cfg.num_layers):
            x, (conv, ssd) = _ssm_layer(ctx, cfg, _layer(params["layers"], i), x,
                                        cache["conv"][i])
            convs.append(conv)
            ssds.append(ssd)
        B, S = tokens.shape
        lens = lengths if lengths is not None else torch.full(
            (B,), S, dtype=torch.int32, device=x.device)
        return dict(cache, conv=torch.stack(convs), ssd=torch.stack(ssds),
                    len=lens), _lm_head(ctx, params, cfg, x, read)
    logits, _, (ks, vs) = lm_forward(ctx, params, cfg, tokens, positions=positions,
                                     img_embeds=img_embeds, collect_kv=True, read=read)
    B, S_tot = ks.shape[1], ks.shape[2]
    lens = lengths if lengths is not None else torch.full(
        (B,), S_tot, dtype=torch.int32, device=ks.device)
    return _commit_prefill(dict(cache), ks, vs, lens, ctx), logits


def lm_decode_step(ctx: Ctx, params, cfg, tokens, cache):
    """One decode step, tokens (B, 1) -> (cache, logits (B, 1, V)).

    A cache carrying ``block_tables`` routes to the paged step. A dense
    cache may carry an optional ``active`` (B,) mask (the engine's
    horizon loop injects it): inactive slots decode into masked positions
    (``pos`` stays -1) and their ``len`` freezes. The fresh token's K/V is
    written into the cache in place (quantized on int8 / fp8 caches)."""
    if "block_tables" in cache:
        return lm_paged_decode_step(ctx, params, cfg, tokens, cache)
    if cfg.family == "ssm":
        return _ssm_decode_step(ctx, params, cfg, tokens, cache)
    layout = _kv_layout(cache)
    positions = cache["len"][:, None]
    whole = cache["pos"].shape[1]
    actx = rank_ctx(ctx, cfg, "attn")
    x = _embed(ctx, params, cfg, tokens)
    for i, window in enumerate(window_array(cfg)):
        lp = _layer(params["layers"], i)
        leaves = _self_leaves(cache, i, layout)
        if layout == "float":
            k_dense, v_dense = leaves
        else:
            k_dense, v_dense = _dense_kv(*leaves[:2]), _dense_kv(*leaves[2:])
        h = rms_norm(x, lp["norm1_scale"], cfg.norm_eps)
        y, k_new, v_new = decode_attn_apply(
            actx, lp["attn"], h, positions, k_dense, v_dense, cache["pos"],
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, window=window, rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps, group=ctx.tp)
        x = x + y
        h = rms_norm(x, lp["norm2_scale"], cfg.norm_eps)
        x = x + moe_mod.layer_ffn(ctx, cfg, lp, h, dropless=True)[0]
        if layout == "float":
            new = (k_new, v_new)
        else:
            qfn = SCALED_KV[layout][2]
            new = (*qfn(k_new), *qfn(v_new))
        for leaf, t in zip(leaves, new):
            _scatter_rows(ctx, leaf, t, cache["len"], whole)
    logits = _lm_head(ctx, params, cfg, x)
    return _commit_decode_position(dict(cache), cache, positions), logits


def _ssm_decode_step(ctx: Ctx, params, cfg, tokens, cache):
    """One recurrent step of every SSM layer; the new states are written
    into the cache in place (the conv state cast to its bf16 leaf)."""
    x = _embed(ctx, params, cfg, tokens)
    sctx = rank_ctx(ctx, cfg, "ssd")
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["norm1_scale"], cfg.norm_eps)
        y, (conv, ssd) = ssm_mod.ssm_decode_step(
            sctx, lp["ssm"], h, (cache["conv"][i], cache["ssd"][i]), d_model=cfg.d_model,
            ssm_cfg=cfg.ssm)
        x = x + y
        cache["conv"][i] = conv.to(cache["conv"].dtype)
        cache["ssd"][i] = ssd
    return dict(cache, len=cache["len"] + 1), _lm_head(ctx, params, cfg, x)


def lm_paged_decode_step(ctx: Ctx, params, cfg, tokens, cache):
    """One decode step against a block-paged cache, tokens (B, 1). Idle
    slots write to the trash page and their length stays frozen."""
    tables, active = cache["block_tables"], cache["active"]
    layout = _kv_layout(cache)
    positions = cache["len"][:, None]
    view_pos, pid, off = paged_view(cache)
    x = _embed(ctx, params, cfg, tokens)
    # the paged-attention kernel has no local-window mask, so an arch
    # with windows (gemma3's 5:1 pattern, llava's sliding window) takes
    # the gather route whatever the route bundle asks for. This is the
    # reference's own rule, not a fallback: its paged step does the same.
    use_kernel = ctx.paged_attn_impl == "kernel" and not cfg.window_pattern
    lengths_now = torch.where(active > 0, cache["len"] + 1, 0)
    actx = rank_ctx(ctx, cfg, "attn")
    for i, window in enumerate(window_array(cfg)):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["norm1_scale"], cfg.norm_eps)
        y, _ = paged_attn(actx, lp["attn"], h, positions, _self_leaves(cache, i, layout),
                          view_pos, pid, off, lengths_now, tables, use_kernel=use_kernel,
                          num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                          head_dim=cfg.head_dim, window=window,
                          rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
        x = x + y
        h = rms_norm(x, lp["norm2_scale"], cfg.norm_eps)
        x = x + moe_mod.layer_ffn(ctx, cfg, lp, h, dropless=True)[0]
    logits = _lm_head(ctx, params, cfg, x)
    new = dict(cache)
    new["len"] = torch.where(active > 0, cache["len"] + 1, cache["len"])
    return new, logits
