"""Fused per-slot token sampler — the greedy path.

Greedy decoding takes the argmax of each slot's logits (the first
maximum on ties). A slot whose logits hold NaN/Inf samples the
``ERR_TOKEN`` sentinel instead, so the engine can retire just that slot.
Temperature / top-k / top-p sampling comes with a later slice (it needs
the reference's threefry random bits).
"""

from __future__ import annotations

import torch

__all__ = ["sample_tokens", "sample_tokens_scan", "ERR_TOKEN"]

# never a vocab id, a pad (0) or an eos_id
ERR_TOKEN = -2


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """logits (S, V) -> tokens (S,) int32 (greedy, with the non-finite guard)."""
    lg = logits.to(torch.float32)
    toks = torch.argmax(lg, dim=-1).to(torch.int32)
    ok = torch.isfinite(lg).all(dim=-1)
    return torch.where(ok, toks, ERR_TOKEN)


def sample_tokens_scan(logits, alive, pad_id: int = 0):
    """Horizon-loop form: slots retired earlier in the horizon (alive=0)
    emit ``pad_id``."""
    return torch.where(alive > 0, sample_tokens(logits), pad_id)
