"""Fused per-slot token sampler: greedy next to temperature / top-k / top-p.

All slots decode in one batched step and may carry different
SamplingParams; the per-slot knobs (temperature, top_k, top_p, PRNG key,
stream offset) enter as tensors and the greedy-vs-sampled choice is a
per-row ``where``, as in the reference.

Per-slot PRNG streams: each request owns a base key from its ``seed``;
token ``t`` of that request draws from ``fold_in(key, t)`` with the
reference's threefry bits (``repro_torch.random``), so a seeded request
samples the same tokens as the JAX engine, whatever its slot, admission
order or horizon.

A slot whose logits hold NaN/Inf samples the ``ERR_TOKEN`` sentinel
instead, so the engine can retire just that slot.
"""

from __future__ import annotations

import torch

from .. import random as prng

__all__ = ["filter_logits", "sample_tokens", "sample_tokens_scan", "ERR_TOKEN"]

# never a vocab id, a pad (0) or an eos_id
ERR_TOKEN = -2
_NEG = -1e30            # mask value: exp() underflows to exactly 0


def _guard(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    ok = torch.isfinite(logits).all(dim=-1)
    return torch.where(ok, toks.to(torch.int32), ERR_TOKEN)


def filter_logits(lg, temps, top_ks, top_ps):
    """Temperature, then top-k (keep logits >= the k-th largest; k <= 0
    disables), then nucleus top-p over the sorted probabilities with the
    top-1 token always kept. Rows of lg (S, V) f32; knobs (S,)."""
    V = lg.shape[-1]
    lg = lg / torch.clamp_min(temps, 1e-6)[:, None]
    kk = torch.where(top_ks <= 0, V, torch.clamp_max(top_ks, V)).long()
    srt = torch.sort(lg, dim=-1, descending=True).values
    kth = srt.gather(-1, torch.clamp_min(kk - 1, 0)[:, None])
    lg = torch.where(lg < kth, _NEG, lg)
    probs = torch.softmax(lg, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    keep = (torch.cumsum(sp, dim=-1) - sp) < top_ps[:, None]
    pth = torch.where(keep, sp, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(probs < pth, _NEG, lg)


def sample_tokens(logits, temps, top_ks, top_ps, keys, offsets, *,
                  all_greedy: bool = False):
    """Batched next-token sampling across slots.

    logits (S, V), temps / top_ps (S,) f32, top_ks / offsets (S,) int,
    keys (S, 2) int64 key words -> tokens (S,) int32. Rows with
    ``temps <= 0`` take the argmax (the first maximum on ties); rows with
    any non-finite logit return ``ERR_TOKEN``. ``all_greedy`` is the
    caller's promise, known on the host, that every row has
    ``temps <= 0``: the tokens are the same, and the filter and the draw
    are skipped.
    """
    lg = logits.to(torch.float32)
    greedy = torch.argmax(lg, dim=-1)
    if all_greedy:
        return _guard(lg, greedy)
    masked = filter_logits(lg, temps, top_ks, top_ps)
    drawn = prng.categorical(prng.fold_in(keys, offsets), masked)
    return _guard(lg, torch.where(temps <= 0, greedy, drawn))


def sample_tokens_scan(logits, temps, top_ks, top_ps, keys, offsets, alive,
                       pad_id: int = 0, *, all_greedy: bool = False):
    """Horizon-loop form: slots retired earlier in the horizon (alive=0)
    emit ``pad_id``."""
    toks = sample_tokens(logits, temps, top_ks, top_ps, keys, offsets,
                         all_greedy=all_greedy)
    return torch.where(alive > 0, toks, pad_id)
