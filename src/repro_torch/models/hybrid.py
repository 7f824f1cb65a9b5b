"""Griffin-style hybrid LM (recurrentgemma-9b): RG-LRU + local attention.

The layer pattern is 2 recurrent : 1 local-attention (arXiv:2402.19427):
``num_layers // 3`` super-blocks of (rglru, rglru, attn), their
parameters stacked on a leading ``n_super`` axis under ``blocks``
(``r1``, ``r2``, ``at``), then a recurrent tail stacked under ``tail``
(recurrentgemma-9b: 12 super-blocks and 2 tail layers). The stacks run as
Python loops over per-block slices.

Decode state is O(1) per recurrent layer (conv + h). The attention
layers keep a rolling KV buffer of W = min(local_window, max_len) rows:
a token at position p sits at row p % W, and ``pos_roll`` (B, W) holds
each row's absolute position (-1 = empty), so the window mask drops
stale rows by itself. The buffer is bf16 whatever the KV format says,
as in the reference. A tensor-parallel rank whose attention is
replicated holds its block of the W rows where tp divides W (the
sequence split, ``layers.seq_rows``); ``pos_roll`` stays whole.
"""

from __future__ import annotations

import torch

from ..random import split
from ..tree import map_like
from .layers import (Ctx, attention_init, attn_apply, decode_attn_apply, draw_sources,
                     mlp, mlp_init, normal_init, rank_ctx, remat as _remat, rms_norm,
                     seq_block, seq_rows, stack_layers)
from .rglru import rglru_apply, rglru_decode_step, rglru_init, rglru_init_state
from .transformer import _embed, _layer, _layers, _lm_head, _positions, _scatter_rows

__all__ = ["hybrid_init", "hybrid_forward", "hybrid_init_cache", "hybrid_prefill",
           "hybrid_decode_step", "hybrid_layout"]


def hybrid_layout(cfg):
    """(#super-blocks, #tail recurrent layers) for the 2:1 pattern."""
    n_super = cfg.num_layers // 3
    return n_super, cfg.num_layers - 3 * n_super


def _mixer_block_init(g, cfg, kind: str, n=None):
    """One (mixer + MLP) block, stacked on ``n`` (unstacked for None): from
    a torch.Generator, or from a key split in 2 as the reference's
    ``_mixer_block_init`` (k1 the mixer, k2 the MLP). The attention has
    no bias and no q / k norm, as in the reference."""
    d = cfg.d_model
    lead = () if n is None else (n,)
    k1, k2 = draw_sources(g, 2)
    p = {"norm_t_scale": torch.ones(lead + (d,), device=g.device),
         "norm_m_scale": torch.ones(lead + (d,), device=g.device),
         "mlp": mlp_init(k2, n, cfg)}
    if kind == "rglru":
        p["rglru"] = rglru_init(k1, d, cfg.d_rec, lead)
    else:
        p["attn"] = attention_init(k1, n, cfg, extras=False)
    return p


_SUPER = (("r1", "rglru"), ("r2", "rglru"), ("at", "attn"))


def _hybrid_init_from_key(key, cfg):
    """The reference's ``hybrid_init(jax.random.PRNGKey(seed), cfg)``, key
    for key: split 4 (embedding, super-blocks, tail, head), each
    super-block's key split 3 (r1, r2, at)."""
    n_super, tail = hybrid_layout(cfg)
    ke, kb, kt, kh = split(key, 4)

    def super_init(k):
        return {name: _mixer_block_init(kk, cfg, kind)
                for (name, kind), kk in zip(_SUPER, split(k, 3))}

    params = {
        "embedding": normal_init(ke, (cfg.vocab_size, cfg.d_model), 0.02),
        # the reference's vmap over no keys gives empty stacks
        "blocks": map_like(lambda t: t[:n_super], stack_layers(
            [super_init(k) for k in split(kb, max(n_super, 1))])),
        "norm_f_scale": torch.ones((cfg.d_model,), device=key.device),
    }
    if tail:
        params["tail"] = stack_layers([_mixer_block_init(k, cfg, "rglru")
                                       for k in split(kt, tail)])
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(kh, (cfg.d_model, cfg.vocab_size),
                                        cfg.d_model ** -0.5)
    return params


def hybrid_init(g, cfg):
    """Random parameters with the reference's shapes and scales: drawn
    from the torch.Generator ``g`` on its device, or, for a key from
    ``random.prng_key(seed)``, the reference's own draws for that seed."""
    if isinstance(g, torch.Tensor):
        return _hybrid_init_from_key(g, cfg)
    n_super, tail = hybrid_layout(cfg)
    params = {
        "embedding": normal_init(g, (cfg.vocab_size, cfg.d_model), 0.02),
        "blocks": {name: _mixer_block_init(g, cfg, kind, n_super) for name, kind in _SUPER},
        "norm_f_scale": torch.ones((cfg.d_model,), device=g.device),
    }
    if tail:
        params["tail"] = _mixer_block_init(g, cfg, "rglru", tail)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(g, (cfg.d_model, cfg.vocab_size),
                                        cfg.d_model ** -0.5)
    return params


def _mlp_residual(ctx: Ctx, cfg, bp, x):
    h = rms_norm(x, bp["norm_m_scale"], cfg.norm_eps)
    return x + mlp(rank_ctx(ctx, cfg, "ffn"), bp["mlp"], h, cfg.mlp_act)


def _residual_mixer(ctx: Ctx, cfg, bp, x, positions, kind: str, state=None):
    """One (mixer + MLP) residual pair from ``state`` (a recurrent
    layer's (conv, h); None = zeros). Returns (x, the recurrent layer's
    new (conv, h) or the attention layer's (k, v))."""
    h = rms_norm(x, bp["norm_t_scale"], cfg.norm_eps)
    if kind == "rglru":
        y, out = rglru_apply(rank_ctx(ctx, cfg, "rec"), bp["rglru"], h, state,
                             return_state=True)
    else:
        y, out = attn_apply(rank_ctx(ctx, cfg, "attn"), bp["attn"], h, positions,
                            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                            head_dim=cfg.head_dim,
                            causal=True, window=cfg.local_window,
                            rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
    return _mlp_residual(ctx, cfg, bp, x + y), out


def hybrid_forward(ctx: Ctx, params, cfg, tokens, remat: bool = False):
    """Full-sequence forward, tokens (B, S). Returns (logits f32, aux=0).
    ``remat`` recomputes each super-block's and each tail layer's
    activations in the backward pass, as the reference's checkpointed
    scans do."""
    n_super, tail = hybrid_layout(cfg)
    x = _embed(ctx, params, cfg, tokens)
    positions = _positions(*tokens.shape, x.device)

    def block(x, bp):
        for name, kind in _SUPER:
            x, _ = _residual_mixer(ctx, cfg, bp[name], x, positions, kind)
        return x

    def tail_layer(x, bp):
        return _residual_mixer(ctx, cfg, bp, x, positions, "rglru")[0]

    block, tail_layer = _remat(block, remat), _remat(tail_layer, remat)
    for bp in _layers(params["blocks"], n_super):
        x = block(x, bp)
    for bp in _layers(params["tail"], tail) if tail else ():
        x = tail_layer(x, bp)
    return _lm_head(ctx, params, cfg, x), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# serving: O(1) recurrent state + rolling local-attention KV
# ---------------------------------------------------------------------------

def hybrid_init_cache(cfg, batch: int, max_len: int, kv_dtype: str = "bf16",
                      device="cuda", seq_split: bool = True):
    """The serving cache. ``kv_dtype`` is accepted and ignored: the
    rolling K/V are bf16, as in the reference. A rank-local config
    (``parallel.tp.local_config``) gives a rank's ``d_rec / tp`` states
    and the one KV head its query heads read, or its block of the W rows
    (``seq_rows``, unless ``seq_split`` is off)."""
    n_super, tail = hybrid_layout(cfg)
    W = min(cfg.local_window, max_len)
    kv = (n_super, batch, seq_rows(cfg, W) if seq_split else W, cfg.num_kv_heads,
          cfg.head_dim)

    def states(n):
        return tuple(t.expand(n, *t.shape).clone()
                     for t in rglru_init_state(batch, cfg.d_rec, device))

    cache = {}
    cache["b_conv1"], cache["b_h1"] = states(n_super)
    cache["b_conv2"], cache["b_h2"] = states(n_super)
    cache.update(b_k=torch.zeros(kv, dtype=torch.bfloat16, device=device),
                 b_v=torch.zeros(kv, dtype=torch.bfloat16, device=device),
                 pos_roll=torch.full((batch, W), -1, dtype=torch.int32, device=device),
                 len=torch.zeros((batch,), dtype=torch.int32, device=device))
    if tail:
        cache["t_conv"], cache["t_h"] = states(tail)
    return cache


def _roll_slots(S: int, W: int, lo: int, rows: int, device):
    """Rolling-buffer fill for a prompt of length S: (source rows,
    destination rows); a prompt longer than W keeps its last W rows, at
    slot p % W. A cache holding ``rows`` of the W slots from ``lo`` (a
    rank's block, or all W from 0) keeps the sources whose slot falls
    there, at their slot's row of it."""
    src = torch.arange(max(S - W, 0), S)
    src = src[(src % W >= lo) & (src % W < lo + rows)]
    return src.to(device), (src % W - lo).to(device)


def _put_state(cache, conv_key, h_key, i, st):
    """Store a recurrent layer's new (conv, h) in its cache leaves, in
    place: the conv state rounds to the leaf's bf16."""
    cache[conv_key][i] = st[0].to(cache[conv_key].dtype)
    cache[h_key][i] = st[1]


_BLOCK_STATES = (("r1", "b_conv1", "b_h1"), ("r2", "b_conv2", "b_h2"))


def hybrid_prefill(ctx: Ctx, params, cfg, tokens, cache, lengths=None, read=None):
    """Run the prompt tokens (B, S) from the cache's states and fill it in
    place. Returns (cache, logits (B, S, V)), or with ``read`` (B,) the
    logits (B, V) of one position a row: the rows a tensor-parallel rank
    gathers (``transformer._head``)."""
    B, S = tokens.shape
    n_super, tail = hybrid_layout(cfg)
    W, rows = cache["pos_roll"].shape[1], cache["b_k"].shape[2]
    x = _embed(ctx, params, cfg, tokens)
    positions = _positions(B, S, x.device)
    src, dst = _roll_slots(S, W, seq_block(ctx.tp, rows, W), rows, x.device)
    cache = dict(cache)
    for i in range(n_super):
        bp = _layer(params["blocks"], i)
        for name, ck, hk in _BLOCK_STATES:
            x, st = _residual_mixer(ctx, cfg, bp[name], x, positions, "rglru",
                                    (cache[ck][i], cache[hk][i]))
            _put_state(cache, ck, hk, i, st)
        x, (k, v) = _residual_mixer(ctx, cfg, bp["at"], x, positions, "attn")
        for key, t in (("b_k", k), ("b_v", v)):
            cache[key][i] = 0
            cache[key][i][:, dst] = t[:, src].to(torch.bfloat16)
    for i in range(tail):
        x, st = _residual_mixer(ctx, cfg, _layer(params["tail"], i), x, positions,
                                "rglru", (cache["t_conv"][i], cache["t_h"][i]))
        _put_state(cache, "t_conv", "t_h", i, st)
    cache["pos_roll"][:] = -1
    keep = torch.arange(max(S - W, 0), S, device=x.device)
    cache["pos_roll"][:, keep % W] = keep.to(torch.int32)
    cache["len"] = lengths if lengths is not None else torch.full(
        (B,), S, dtype=torch.int32, device=x.device)
    return cache, _lm_head(ctx, params, cfg, x, read)


def _rglru_step(ctx: Ctx, cfg, bp, x, cache, conv_key, h_key, i):
    h = rms_norm(x, bp["norm_t_scale"], cfg.norm_eps)
    y, st = rglru_decode_step(rank_ctx(ctx, cfg, "rec"), bp["rglru"], h,
                              (cache[conv_key][i], cache[h_key][i]))
    _put_state(cache, conv_key, h_key, i, st)
    return _mlp_residual(ctx, cfg, bp, x + y)


def hybrid_decode_step(ctx: Ctx, params, cfg, tokens, cache):
    """One decode step, tokens (B, 1) -> (cache, logits (B, 1, V)). The
    states, the fresh K/V (at row len % W) and ``pos_roll`` are written in
    place."""
    B = tokens.shape[0]
    n_super, tail = hybrid_layout(cfg)
    W = cache["pos_roll"].shape[1]
    positions = cache["len"][:, None]
    rows = torch.arange(B, device=positions.device)
    slot = (cache["len"] % W).long()
    actx = rank_ctx(ctx, cfg, "attn")
    x = _embed(ctx, params, cfg, tokens)
    for i in range(n_super):
        bp = _layer(params["blocks"], i)
        for name, ck, hk in _BLOCK_STATES:
            x = _rglru_step(ctx, cfg, bp[name], x, cache, ck, hk, i)
        at = bp["at"]
        h = rms_norm(x, at["norm_t_scale"], cfg.norm_eps)
        y, k_new, v_new = decode_attn_apply(
            actx, at["attn"], h, positions, cache["b_k"][i], cache["b_v"][i],
            cache["pos_roll"], num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, window=cfg.local_window, rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps, group=ctx.tp)
        x = _mlp_residual(ctx, cfg, at, x + y)
        # slot len % W in [0, W): _scatter_rows' clamp leaves it be
        _scatter_rows(ctx, cache["b_k"][i], k_new, slot, W)
        _scatter_rows(ctx, cache["b_v"][i], v_new, slot, W)
    for i in range(tail):
        x = _rglru_step(ctx, cfg, _layer(params["tail"], i), x, cache, "t_conv", "t_h", i)
    logits = _lm_head(ctx, params, cfg, x)
    new = dict(cache)
    new["pos_roll"][rows, slot] = positions[:, 0]
    new["len"] = cache["len"] + 1
    return new, logits
