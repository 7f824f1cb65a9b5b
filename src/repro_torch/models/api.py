"""Unified model facade: one callable surface per architecture family.

build_model(cfg, device) -> ModelAPI with
  init(generator | key)              -> params (a key from random.prng_key(seed)
                                        draws the reference's init for that seed)
  forward(ctx, params, batch, remat=False) -> (logits, aux_loss)  (teacher-forced;
                                        remat recomputes each layer in backward)
  init_cache(batch, max_len, kv, seq_split=True)
                                     -> dense prefill cache (a tensor-parallel
                                        rank's block of the sequence where its
                                        attention is replicated, layers.seq_rows;
                                        seq_split=False keeps it whole)
  init_paged_cache(slots, max_pages, num_pages, page_size, kv)
                                     -> block-paged serving cache (attention
                                        families; the SSM and hybrid raise
                                        ValueError)
  prefill(ctx, params, cache, batch) -> (cache, logits)
                                     (a decoder-only LM's takes ``read=`` (B,):
                                      then logits (B, V), one position a row)
  decode_step(ctx, params, tok, c)   -> (cache, logits)   (dense or paged)
decode_block(model, ctx, params, tokens, cache) -> (cache, logits (B, K, V))

decode_step dispatches on the cache layout: a cache carrying
``block_tables`` runs the paged attention path, anything else the dense
path.

Batches are dicts:
  LM families (dense, moe, vlm, ssm, hybrid):
                                 {"tokens" (B,S)[, "img_embeds" (B,P,d)
                                  for vlm][, "lengths"]}
  enc-dec:                       {"tgt_in" (B,Sd), "src_tokens" (B,Se)[, "lengths"]}
  audio:                         {"tgt_in" (B,Sd), "frames" (B,F,d)[, "lengths"]}
``forward`` also takes numpy arrays (a ``data`` batch), moved to the
model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import encdec as ed
from . import hybrid as hy
from . import transformer as tf

__all__ = ["ModelAPI", "build_model", "decode_block"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: Any
    init: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    init_paged_cache: Callable


def decode_block(model: ModelAPI, ctx, params, tokens, cache):
    """Teacher-forced multi-token decode: feed ``tokens`` (B, K) through K
    ``decode_step`` micro-steps and return ``(cache, logits (B, K, V))``.

    The speculative verify: the target's forward over a drafted block.
    Per-slot masking rides on the cache's own machinery (dense ``pos`` /
    ``len``, paged ``block_tables`` / ``len`` / ``active``), so the logits
    at position i are what a sequential decode of the same prefix gives.
    A caller that needs retired slots frozen puts an ``active`` mask into
    the cache first; it holds for the whole block."""
    logits = []
    for i in range(tokens.shape[1]):
        cache, lg = model.decode_step(ctx, params, tokens[:, i:i + 1], cache)
        logits.append(lg[:, -1])
    return cache, torch.stack(logits, dim=1)


def _on(device, batch, key):
    v = batch.get(key)
    return None if v is None else torch.as_tensor(v, device=device)


def _no_paged_cache(fam: str) -> Callable:
    def init_paged_cache(*a, **k):
        raise ValueError(
            f"family {fam!r} keeps O(1)-per-sequence recurrent state; "
            "block-paged KV caches apply to attention families only")
    return init_paged_cache


def _lm_model(cfg, device) -> ModelAPI:
    def forward(ctx, params, batch, remat=False):
        logits, aux, _ = tf.lm_forward(ctx, params, cfg, _on(device, batch, "tokens"),
                                       img_embeds=_on(device, batch, "img_embeds"),
                                       remat=remat)
        return logits, aux

    def init_cache(batch_size, max_len, kv_dtype="bf16", seq_split=True):
        return tf.lm_init_cache(cfg, batch_size, max_len, kv_dtype, device, seq_split)

    def prefill(ctx, params, cache, batch, read=None):
        return tf.lm_prefill(ctx, params, cfg, batch["tokens"], cache,
                             lengths=batch.get("lengths"),
                             img_embeds=batch.get("img_embeds"), read=read)

    def decode_step(ctx, params, tokens, cache):
        return tf.lm_decode_step(ctx, params, cfg, tokens, cache)

    def init_paged_cache(slots, max_pages, num_pages, page_size, kv_dtype="bf16"):
        return tf.lm_init_paged_cache(cfg, slots, max_pages, num_pages, page_size,
                                      kv_dtype, device)

    return ModelAPI(cfg, lambda g: tf.lm_init(g, cfg), forward, init_cache, prefill,
                    decode_step, _no_paged_cache("ssm") if cfg.family == "ssm"
                    else init_paged_cache)


def _hybrid_model(cfg, device) -> ModelAPI:
    def forward(ctx, params, batch, remat=False):
        return hy.hybrid_forward(ctx, params, cfg, _on(device, batch, "tokens"), remat=remat)

    def init_cache(batch_size, max_len, kv_dtype="bf16", seq_split=True):
        return hy.hybrid_init_cache(cfg, batch_size, max_len, kv_dtype, device, seq_split)

    def prefill(ctx, params, cache, batch, read=None):
        return hy.hybrid_prefill(ctx, params, cfg, batch["tokens"], cache,
                                 lengths=batch.get("lengths"), read=read)

    def decode_step(ctx, params, tokens, cache):
        return hy.hybrid_decode_step(ctx, params, cfg, tokens, cache)

    return ModelAPI(cfg, lambda g: hy.hybrid_init(g, cfg), forward, init_cache, prefill,
                    decode_step, _no_paged_cache("hybrid"))


def build_model(cfg, device="cuda") -> ModelAPI:
    """The family's ModelAPI on ``device``; a tensor-parallel rank's is
    built on its rank-local config (``parallel.tp.local_config``), whose
    widths, ``tp`` and replicated kinds its caches take."""
    if cfg.family in ("dense", "vlm", "moe", "ssm"):
        return _lm_model(cfg, device)
    if cfg.family == "hybrid":
        return _hybrid_model(cfg, device)
    if cfg.family not in ("encdec", "audio"):
        raise ValueError(f"unknown family {cfg.family!r}")

    def init(generator):
        return ed.encdec_init(generator, cfg)

    def forward(ctx, params, batch, remat=False):
        return ed.encdec_forward(ctx, params, cfg, _on(device, batch, "tgt_in"),
                                 src_tokens=_on(device, batch, "src_tokens"),
                                 frames=_on(device, batch, "frames"), remat=remat)

    def init_cache(batch_size, max_len, kv_dtype="bf16", enc_len=None, seq_split=True):
        return ed.encdec_init_cache(cfg, batch_size, max_len,
                                    enc_len or cfg.enc_len, kv_dtype, device, seq_split)

    def prefill(ctx, params, cache, batch):
        return ed.encdec_prefill(ctx, params, cfg, cache, batch["tgt_in"],
                                 src_tokens=batch.get("src_tokens"),
                                 frames=batch.get("frames"), lengths=batch.get("lengths"))

    def decode_step(ctx, params, tokens, cache):
        return ed.encdec_decode_step(ctx, params, cfg, tokens, cache)

    def init_paged_cache(slots, max_pages, num_pages, page_size,
                         kv_dtype="bf16", enc_len=None):
        return ed.encdec_init_paged_cache(cfg, slots, max_pages, num_pages,
                                          page_size, kv_dtype,
                                          enc_len or cfg.enc_len, device)

    return ModelAPI(cfg, init, forward, init_cache, prefill, decode_step,
                    init_paged_cache)
