"""Quantized-draft speculative decoding: draft cheap, verify exact.

A *draft* arm, the SAME checkpoint quantized a second time at another
spec (e.g. a 4-bit draft for a 4-bit or 8-bit target), proposes K tokens
per round through the engine's horizon loop; the *target* arm replays
the drafted block teacher-forced (``models.decode_block``) and accepts
the longest prefix that matches its own greedy argmax.

For greedy requests the emitted stream is token for token the
target-only stream, whatever the draft spec: each round emits the
accepted prefix plus the target's own token at the first divergence. The
draft changes how fast tokens arrive, never which. A rejection rolls
BOTH arms' caches back to the emitted length. Sampled requests fall the
whole round back to the target-only path (the draft cache goes stale,
which lowers acceptance later and never changes a token).

Any spec serves as a draft: weight-only, act-quantizing (calibrated on
the deployment's ``calib_batches``, or dynamic with a warning) and fp8-KV
specs alike. The draft's activation format is its own spec's; its
attention format is the target's, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional, Tuple

import torch

from ..core import QuantSpec, calibrated_ctx, quantize_tree, resolve_spec
from ..models.layers import Ctx

__all__ = ["DraftArm", "accept_longest_prefix", "build_draft_arm"]


@dataclasses.dataclass(frozen=True)
class DraftArm:
    """The draft side of a speculative deployment: the checkpoint
    quantized at ``spec``, its Ctx and its KV-cache dtype. ``lookahead``
    is K, the tokens drafted per verify round."""

    params: Any
    ctx: Ctx
    spec: QuantSpec
    kv_dtype: str
    lookahead: int = 4

    def __post_init__(self):
        if self.lookahead < 1:
            raise ValueError(f"draft lookahead must be >= 1, got {self.lookahead}")


def accept_longest_prefix(draft_block: torch.Tensor, target_block: torch.Tensor,
                          alive: torch.Tensor, pad_id: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The acceptance rule, vectorized over slots.

    draft_block / target_block: (K, S) int — the drafted tokens and the
    target's greedy argmax at each drafted position (position i of
    ``target_block`` is the target's choice given ``cur, d_0..d_{i-1}``).
    alive: (S,) mask.

    Returns ``(out, n_emit, accepted, new_cur)``: ``out`` (K, S) the
    accepted prefix, then the target's token at the first divergence,
    then ``pad_id``; ``n_emit`` (S,) = min(accepted + 1, K); ``accepted``
    (S,) the matching prefix length (0 on dead slots); ``new_cur`` (S,)
    the last emitted token. When all K match, the target's bonus token
    is not emitted, so both arms advanced exactly K positions and the
    rollback is one shared truncation."""
    K = draft_block.shape[0]
    live = alive > 0
    match = (draft_block == target_block) & live[None, :]
    accepted = torch.cumprod(match.to(torch.int32), dim=0).sum(dim=0).to(torch.int32)
    n_emit = torch.clamp(accepted + 1, max=K)
    idx = torch.arange(K, dtype=torch.int32, device=draft_block.device)[:, None]
    pad = torch.full_like(draft_block, pad_id)
    out = torch.where(idx < accepted[None, :], draft_block,
                      torch.where(idx == accepted[None, :], target_block, pad))
    out = torch.where(live[None, :], out, pad)
    new_cur = out.gather(0, (n_emit - 1).long()[None, :])[0]
    return out, n_emit, torch.where(live, accepted, 0), new_cur


def build_draft_arm(model, raw_params, base_ctx: Ctx, draft_spec, *,
                    lookahead: int = 4,
                    calib_batches: Optional[Iterable[dict]] = None,
                    place: Optional[Callable] = None) -> DraftArm:
    """Quantize a second arm of ``raw_params`` (the UN-quantized
    checkpoint) at ``draft_spec`` and bundle it as a DraftArm.

    ``base_ctx`` supplies the compute dtype, the kernel routes, the
    attention format and a tensor-parallel rank's group; the draft's
    activation format and (calibrated on ``calib_batches``) static scales
    replace the target's. An act-quantizing draft without batches warns
    and stays dynamic. ``place`` maps the quantized whole tree to what
    ``model`` serves: a rank's shard (``parallel.tp.shard_params``), on
    which a rank calibrates as the target does."""
    spec = resolve_spec(draft_spec)
    ctx = dataclasses.replace(base_ctx, act_fmt=spec.act, act_scales=None)
    params = raw_params
    if spec.weights != "f32":
        params = quantize_tree(raw_params, spec.policy())
    if place is not None:
        params = place(params)
    if spec.quantizes_act:
        ctx = calibrated_ctx(ctx, model, params, calib_batches, spec.act,
                             f"draft spec {spec} quantizes activations")
    return DraftArm(params=params, ctx=ctx, spec=spec, kv_dtype=spec.kv,
                    lookahead=int(lookahead))
