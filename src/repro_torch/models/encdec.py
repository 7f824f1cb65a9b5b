"""Encoder-decoder transformer: NLLB-600M (the paper's model), its MoE
variant, and whisper-base.

Pre-norm residual encoder/decoder stacks with rotary self-attention,
cross-attention from the decoder, ReLU FFNs (top-k experts in the MoE
variant, the paper's Fig. 3b) and a tied embedding head. Whisper reuses
the skeleton with a stub conv frontend: its encoder takes precomputed
frame embeddings (B, F, d) in place of embedded source tokens.

The MoE layers dispatch with capacity in the encoder, the teacher-forced
decoder and the prefill, and dropless in the decode steps; the decoder's
aux losses are summed, the encoder's discarded, as in the reference.
Layer parameters are stacked on a leading ``L`` axis, as in the
reference; the stacks run as Python loops over per-layer slices.

Serving caches are updated in place: prefill writes into the cache it is
given, and a decode step writes the fresh token into its dense row or
its page. A cache holds its K/V in one of three layouts, told apart by
its keys (``_kv_layout``): int8 (``k_codes`` + ``k_scales``), fp8
(float8 ``k`` + ``k_scales``) or float (``k`` alone).
"""

from __future__ import annotations

import torch
from ..random import split
from . import moe as moe_mod
from .layers import (Ctx, attention_init, attn_apply, decode_attn_apply, mlp_init,
                     normal_init, rank_ctx, remat as _remat, rms_norm, seq_rows, stack_layers)
from .transformer import (SCALED_KV, _commit_decode_position, _commit_prefill,
                          _dense_kv, _embed_rows, _head, _kv_layout, _kv_leaves, _layer,
                          _layers, _positions, _scatter_rows, _self_leaves, paged_attn,
                          paged_view)

__all__ = ["encdec_init", "encdec_encode", "encdec_forward", "encdec_init_cache",
           "encdec_init_paged_cache", "encdec_prefill", "encdec_decode_step",
           "encdec_paged_decode_step"]


def _init_from_key(key: torch.Tensor, cfg):
    """The reference's ``encdec_init(jax.random.PRNGKey(seed), cfg)``, key
    for key: the same splits and normal draws (``repro_torch.random``), so
    each parameter is within two float32 ulps of the reference's (one from
    the normal draw, one from its scale)."""
    d = cfg.d_model

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=key.device)

    def ffn(k):
        if cfg.moe is not None:
            return {"moe": moe_mod.moe_init(k, d, cfg.d_ff, cfg.moe.num_experts, cfg.mlp_act)}
        return {"mlp": mlp_init(k, None, cfg)}

    def enc_layer(k):
        k1, k2 = split(k)
        return {"attn": attention_init(k1, None, cfg, extras=False), "norm1_scale": ones(),
                "norm2_scale": ones(), **ffn(k2)}

    def dec_layer(k):
        k1, k2, k3 = split(k, 3)
        return {"attn": attention_init(k1, None, cfg, extras=False),
                "cross": attention_init(k2, None, cfg, extras=False), "norm1_scale": ones(),
                "norm2_scale": ones(), "norm3_scale": ones(), **ffn(k3)}

    ke, k1, k2, kh = split(key, 4)
    params = {
        "embedding": normal_init(ke, (cfg.vocab_size, d), 0.02),
        "encoder": {"layers": stack_layers([enc_layer(k) for k in split(k1, cfg.enc_layers)]),
                    "norm_f_scale": ones()},
        "decoder": {"layers": stack_layers([dec_layer(k) for k in split(k2, cfg.num_layers)]),
                    "norm_f_scale": ones()},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(kh, (d, cfg.vocab_size), d ** -0.5)
    return params


def encdec_init(g, cfg):
    """Random parameters with the reference's shapes and scales: drawn from
    a torch.Generator ``g`` on its device, or, for a key from
    ``random.prng_key(seed)``, the reference's own draws for that seed."""
    if isinstance(g, torch.Tensor):
        return _init_from_key(g, cfg)
    Le, Ld, d = cfg.enc_layers, cfg.num_layers, cfg.d_model

    def ones(*shape):
        return torch.ones(shape + (d,), dtype=torch.float32, device=g.device)

    def ffn(L):
        if cfg.moe is not None:
            return {"moe": moe_mod.moe_init(g, d, cfg.d_ff, cfg.moe.num_experts,
                                            cfg.mlp_act, layers=L)}
        return {"mlp": mlp_init(g, L, cfg)}

    params = {
        "embedding": normal_init(g, (cfg.vocab_size, d), 0.02),
        "encoder": {
            "layers": {"attn": attention_init(g, Le, cfg), "norm1_scale": ones(Le),
                       "norm2_scale": ones(Le), **ffn(Le)},
            "norm_f_scale": ones()},
        "decoder": {
            "layers": {"attn": attention_init(g, Ld, cfg),
                       "cross": attention_init(g, Ld, cfg),
                       "norm1_scale": ones(Ld), "norm2_scale": ones(Ld),
                       "norm3_scale": ones(Ld), **ffn(Ld)},
            "norm_f_scale": ones()},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(g, (d, cfg.vocab_size), d ** -0.5)
    return params


def encdec_encode(ctx: Ctx, params, cfg, src_tokens=None, frames=None,
                  remat: bool = False):
    """Bidirectional encoder over src_tokens (B, Se), or an audio model's
    frames (B, F, d) (cast to the compute dtype); ``remat`` recomputes
    each layer's activations in the backward pass."""
    if frames is not None:
        x = frames.to(ctx.compute_dtype)
    else:
        x = _embed_rows(ctx, params, cfg, src_tokens)
    B, Se, _ = x.shape
    positions = _positions(B, Se, x.device)
    actx = rank_ctx(ctx, cfg, "attn")

    def body(x, lp):
        h = rms_norm(x, lp["norm1_scale"], cfg.norm_eps)
        y, _ = attn_apply(actx, lp["attn"], h, positions,
                          num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                          head_dim=cfg.head_dim, causal=False,
                          rope_theta=cfg.rope_theta, site="enc.attn")
        x = x + y
        h = rms_norm(x, lp["norm2_scale"], cfg.norm_eps)
        return x + moe_mod.layer_ffn(ctx, cfg, lp, h, "enc.ffn")[0]

    body_fn = _remat(body, remat)
    for lp in _layers(params["encoder"]["layers"], cfg.enc_layers):
        x = body_fn(x, lp)
    return rms_norm(x, params["encoder"]["norm_f_scale"], cfg.norm_eps)


def _dec_layer(ctx, cfg, lp, x, positions, enc_kv):
    """enc_kv = (k, v, enc_positions) precomputed cross K/V. Returns
    (x, aux (None for a dense FFN), (k, v))."""
    actx = rank_ctx(ctx, cfg, "attn")
    h = rms_norm(x, lp["norm1_scale"], cfg.norm_eps)
    y, kv = attn_apply(actx, lp["attn"], h, positions, num_heads=cfg.num_heads,
                       num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                       causal=True, rope_theta=cfg.rope_theta, site="dec.attn")
    x = x + y
    h = rms_norm(x, lp["norm2_scale"], cfg.norm_eps)
    y, _ = attn_apply(actx, lp["cross"], h, positions, num_heads=cfg.num_heads,
                      num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                      causal=False, kv_override=enc_kv, use_rope=False,
                      site="dec.cross")
    x = x + y
    h = rms_norm(x, lp["norm3_scale"], cfg.norm_eps)
    y, aux = moe_mod.layer_ffn(ctx, cfg, lp, h, "dec.ffn")
    return x + y, aux, kv


def _cross_kv(ctx, lp, cfg, enc_out):
    """Per-layer cross-attention K/V from the encoder output."""
    ctx = rank_ctx(ctx, cfg, "attn")
    B, Se, _ = enc_out.shape
    k = ctx.dot(enc_out, lp["cross"]["wk"], site="dec.cross.kv").reshape(
        B, Se, cfg.num_kv_heads, cfg.head_dim)
    v = ctx.dot(enc_out, lp["cross"]["wv"], site="dec.cross.kv").reshape(
        B, Se, cfg.num_kv_heads, cfg.head_dim)
    return k, v


def encdec_forward(ctx: Ctx, params, cfg, tgt_tokens, src_tokens=None,
                   frames=None, remat: bool = False):
    """Teacher-forced decoder pass over tgt_tokens (B, Sd) given
    src_tokens (B, Se) or frames (B, F, d). Returns (logits (B, Sd, V),
    aux_loss: the decoder's MoE aux losses summed, 0 without MoE);
    ``remat`` recomputes each layer's activations in the backward pass."""
    enc_out = encdec_encode(ctx, params, cfg, src_tokens, frames, remat)
    B, Sd = tgt_tokens.shape
    Se = enc_out.shape[1]
    dev = enc_out.device
    x = _embed_rows(ctx, params, cfg, tgt_tokens)
    positions, enc_pos = _positions(B, Sd, dev), _positions(B, Se, dev)

    def body(x, lp, enc_out):
        k, v = _cross_kv(ctx, lp, cfg, enc_out)
        x, aux, _ = _dec_layer(ctx, cfg, lp, x, positions, (k, v, enc_pos))
        return x, aux

    body_fn = _remat(body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for lp in _layers(params["decoder"]["layers"], cfg.num_layers):
        x, aux_l = body_fn(x, lp, enc_out)
        if aux_l is not None:
            aux = aux + aux_l
    x = rms_norm(x, params["decoder"]["norm_f_scale"], cfg.norm_eps)
    return _head(ctx, params, cfg, x), aux


def encdec_init_cache(cfg, batch: int, max_len: int, enc_len: int,
                      kv_dtype: str = "bf16", device="cuda", seq_split: bool = True):
    """Dense serving cache: self K/V at ``max_len`` (a rank's block of them
    under the sequence split, ``seq_rows``, unless ``seq_split`` is off),
    cross K/V at ``enc_len``, whole."""
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cache = {"pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
             "len": torch.zeros((batch,), dtype=torch.int32, device=device),
             "cross_len": torch.full((batch,), enc_len, dtype=torch.int32, device=device)}
    cache.update(_kv_leaves("cross_", L, batch, enc_len, Hkv, hd, kv_dtype, device))
    rows = seq_rows(cfg, max_len) if seq_split else max_len
    cache.update(_kv_leaves("", L, batch, rows, Hkv, hd, kv_dtype, device))
    return cache


def encdec_prefill(ctx: Ctx, params, cfg, cache, tgt_tokens, src_tokens=None,
                   lengths=None, *, frames=None):
    """Encode the source (tokens or frames), run the decoder prompt, fill
    self + cross caches."""
    enc_out = encdec_encode(ctx, params, cfg, src_tokens, frames)
    B, Sd = tgt_tokens.shape
    Se = enc_out.shape[1]
    dev = enc_out.device
    x = _embed_rows(ctx, params, cfg, tgt_tokens)
    positions = _positions(B, Sd, dev)
    enc_pos = _positions(B, Se, dev)
    ks, vs, cks, cvs = [], [], [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["decoder"]["layers"], i)
        ck, cv = _cross_kv(ctx, lp, cfg, enc_out)
        x, _, (k, v) = _dec_layer(ctx, cfg, lp, x, positions, (ck, cv, enc_pos))
        ks.append(k), vs.append(v), cks.append(ck), cvs.append(cv)
    ks, vs, cks, cvs = (torch.stack(t) for t in (ks, vs, cks, cvs))
    x = rms_norm(x, params["decoder"]["norm_f_scale"], cfg.norm_eps)
    logits = _head(ctx, params, cfg, x)

    lens = lengths if lengths is not None else torch.full(
        (B,), Sd, dtype=torch.int32, device=dev)
    new = _commit_prefill(dict(cache), ks, vs, lens, ctx)
    layout = _kv_layout(cache)
    if layout != "float":
        _, sfx, qfn = SCALED_KV[layout]
        for name, t in (("k", cks), ("v", cvs)):
            new[f"cross_{name}{sfx}"], new[f"cross_{name}_scales"] = qfn(t)
    else:
        new["cross_k"] = cks.to(cache["cross_k"].dtype)
        new["cross_v"] = cvs.to(cache["cross_v"].dtype)
    new["cross_len"] = torch.full((B,), Se, dtype=torch.int32, device=dev)
    return new, logits


def encdec_init_paged_cache(cfg, slots: int, max_pages: int, num_pages: int,
                            page_size: int, kv_dtype: str = "bf16",
                            enc_len: int = 0, device="cuda"):
    """Paged enc-dec serving cache: block-paged decoder self-attention KV
    in a shared pool; the cross-attention cache stays per-slot dense at
    ``enc_len`` capacity, masked per slot by ``cross_len``."""
    from ..serving.paged_cache import TRASH_PAGE, init_paged_kv
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    enc_len = enc_len or cfg.enc_len
    cache = init_paged_kv(L, num_pages, page_size, Hkv, hd, kv_dtype, device)
    cache.update(_kv_leaves("cross_", L, slots, enc_len, Hkv, hd, kv_dtype, device))
    cache["cross_len"] = torch.zeros((slots,), dtype=torch.int32, device=device)
    cache["block_tables"] = torch.full((slots, max_pages), TRASH_PAGE,
                                       dtype=torch.int32, device=device)
    cache["len"] = torch.zeros((slots,), dtype=torch.int32, device=device)
    cache["active"] = torch.zeros((slots,), dtype=torch.int32, device=device)
    return cache


def _enc_positions(cache, B: int, Se: int, device):
    """Cross-attention key positions, -1 beyond each slot's source."""
    enc_pos = _positions(B, Se, device)
    return torch.where(enc_pos < cache["cross_len"][:, None], enc_pos, -1)


def _layer_kv(cache, i: int, layout: str):
    """Layer ``i``'s self-attention leaves (the cache's own tensors, for
    in-place writes) and its dense cross-attention K / V."""
    leaves = _self_leaves(cache, i, layout)
    if layout == "float":
        return leaves, cache["cross_k"][i], cache["cross_v"][i]
    sfx = SCALED_KV[layout][1]
    ck = _dense_kv(cache[f"cross_k{sfx}"][i], cache["cross_k_scales"][i])
    cv = _dense_kv(cache[f"cross_v{sfx}"][i], cache["cross_v_scales"][i])
    return leaves, ck, cv


def _cross_len(cache, layout: str) -> int:
    key = "cross_k_codes" if layout == "int8" else "cross_k"
    return cache[key].shape[2]


def encdec_decode_step(ctx: Ctx, params, cfg, tokens, cache):
    """One decoder token (tokens (B, 1)) against dense self + cross
    caches. Returns (cache, logits (B, 1, V)).

    A cache carrying ``block_tables`` routes to the paged step. A dense
    cache may carry an optional ``active`` (B,) mask (the engine's
    horizon loop injects it): inactive slots decode into masked positions
    (``pos`` stays -1) and their ``len`` freezes. The fresh token's K/V
    is written into the cache in place (quantized on int8 / fp8 caches)."""
    if "block_tables" in cache:
        return encdec_paged_decode_step(ctx, params, cfg, tokens, cache)
    layout = _kv_layout(cache)
    B = tokens.shape[0]
    positions = cache["len"][:, None]
    whole = cache["pos"].shape[1]
    actx = rank_ctx(ctx, cfg, "attn")
    x = _embed_rows(ctx, params, cfg, tokens)
    enc_pos = _enc_positions(cache, B, _cross_len(cache, layout), x.device)
    for i in range(cfg.num_layers):
        lp = _layer(params["decoder"]["layers"], i)
        leaves, ck, cv = _layer_kv(cache, i, layout)
        if layout == "float":
            k_dense, v_dense = leaves
        else:
            k_dense, v_dense = _dense_kv(*leaves[:2]), _dense_kv(*leaves[2:])
        h = rms_norm(x, lp["norm1_scale"], cfg.norm_eps)
        y, k_new, v_new = decode_attn_apply(
            actx, lp["attn"], h, positions, k_dense, v_dense, cache["pos"],
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, site="dec.attn",
            group=ctx.tp)
        x = x + y
        h = rms_norm(x, lp["norm2_scale"], cfg.norm_eps)
        y, _ = attn_apply(actx, lp["cross"], h, positions, num_heads=cfg.num_heads,
                          num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                          causal=False, kv_override=(ck, cv, enc_pos),
                          use_rope=False, site="dec.cross")
        x = x + y
        h = rms_norm(x, lp["norm3_scale"], cfg.norm_eps)
        x = x + moe_mod.layer_ffn(ctx, cfg, lp, h, "dec.ffn", dropless=True)[0]
        if layout == "float":
            new = (k_new, v_new)
        else:
            qfn = SCALED_KV[layout][2]
            new = (*qfn(k_new), *qfn(v_new))
        for leaf, t in zip(leaves, new):
            _scatter_rows(ctx, leaf, t, cache["len"], whole)
    x = rms_norm(x, params["decoder"]["norm_f_scale"], cfg.norm_eps)
    logits = _head(ctx, params, cfg, x)
    return _commit_decode_position(dict(cache), cache, positions), logits


def encdec_paged_decode_step(ctx: Ctx, params, cfg, tokens, cache):
    """One decoder token (tokens (B, 1)): paged self-attention + per-slot
    dense cross-attention. Returns (cache, logits (B, 1, V))."""
    tables, active = cache["block_tables"], cache["active"]
    layout = _kv_layout(cache)
    B = tokens.shape[0]
    positions = cache["len"][:, None]
    view_pos, pid, off = paged_view(cache)
    x = _embed_rows(ctx, params, cfg, tokens)
    enc_pos = _enc_positions(cache, B, _cross_len(cache, layout), x.device)
    use_kernel = ctx.paged_attn_impl == "kernel"
    lengths_now = torch.where(active > 0, cache["len"] + 1, 0)
    actx = rank_ctx(ctx, cfg, "attn")
    for i in range(cfg.num_layers):
        lp = _layer(params["decoder"]["layers"], i)
        leaves, ck, cv = _layer_kv(cache, i, layout)
        h = rms_norm(x, lp["norm1_scale"], cfg.norm_eps)
        y, _ = paged_attn(actx, lp["attn"], h, positions, leaves, view_pos, pid,
                          off, lengths_now, tables, use_kernel=use_kernel,
                          num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                          head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                          site="dec.attn")
        x = x + y
        h = rms_norm(x, lp["norm2_scale"], cfg.norm_eps)
        y, _ = attn_apply(actx, lp["cross"], h, positions, num_heads=cfg.num_heads,
                          num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                          causal=False, kv_override=(ck, cv, enc_pos),
                          use_rope=False, site="dec.cross")
        x = x + y
        h = rms_norm(x, lp["norm3_scale"], cfg.norm_eps)
        x = x + moe_mod.layer_ffn(ctx, cfg, lp, h, "dec.ffn", dropless=True)[0]
    x = rms_norm(x, params["decoder"]["norm_f_scale"], cfg.norm_eps)
    logits = _head(ctx, params, cfg, x)
    new = dict(cache)
    new["len"] = torch.where(active > 0, cache["len"] + 1, cache["len"])
    return new, logits
