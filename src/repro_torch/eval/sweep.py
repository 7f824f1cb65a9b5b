"""Quant sweep: one trained checkpoint across precision presets.

The reference's ``eval/sweep.py`` over the port's ``deploy``.

The paper's Tables IV-V reduced to a function: deploy the same trained
parameters at each requested preset (bf16, fp8, int8 — including the
calibrated w8a8 arm via core.calibration — int4, fp4, nf4), run the full
pair matrix through each deployed engine, and emit one row per format
with quality (mean BLEU/chrF over the grid), model bytes
(core.tree_nbytes via the pipeline), compression, throughput, and the
per-format quality delta against the bf16 anchor — the number the
paper's "quality parity under sub-octet precision" claim lives or dies
on, per pair and per direction.

One engine is deployed per format and reused for every pair (the pair
matrix streams through it request-by-request); nothing here decodes
outside the serving engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core import resolve_spec
from ..obs import PHASES
from ..serving import TraceConfig, deploy
from .suite import PairScore, evaluate_pairs, summarize

__all__ = ["FormatRow", "quant_sweep", "ANCHOR"]

ANCHOR = "bf16"        # deltas are measured against this spec name


@dataclasses.dataclass(frozen=True)
class FormatRow:
    """One precision spec's quality-vs-size-vs-throughput summary."""

    fmt: str                           # the spec as requested (alias ok)
    spec: str                          # fully-resolved grammar string
    model_bytes: int                   # quantized parameter storage
    fp_bytes: int                      # pre-quantization parameter bytes
    compression: float
    kv_cache_bytes: int
    mean_bleu: float
    mean_chrf: float
    mean_token_acc: float
    mean_tok_s: float
    gen_tokens: int
    # worst-direction serving latency over the pair grid (schema v4) —
    # the numbers an SLATarget for this format is written against
    ttft_p95_ms: Optional[float]
    tpot_p95_ms: Optional[float]
    # scheduler round-phase wall-time totals for the whole grid
    # ({admit,dispatch,sync,walk}_ms, schema v5) — where this format's
    # serving time went; None when the sweep ran untraced
    round_phases: Optional[Dict[str, float]]
    bleu_delta: Optional[float]        # vs the anchor row (None = anchor
    chrf_delta: Optional[float]        # itself, or anchor not in sweep)
    calibrated: bool                   # per-site static act scales set?
    pair_scores: Tuple[PairScore, ...]

    def as_row(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["pair_scores"] = [s.as_row() for s in self.pair_scores]
        return d


def quant_sweep(arch_or_cfg, formats: Sequence[str], *, params: Any,
                pair_list: Optional[Sequence[Tuple[str, str]]] = None,
                languages: Optional[Sequence[str]] = None,
                n_sent: int = 8, seed: int = 0,
                max_new_tokens: Optional[int] = None,
                calib_batches_fn=None,
                deploy_kwargs: Optional[Dict[str, Any]] = None,
                trace: bool = False, log=print) -> List[FormatRow]:
    """Evaluate one checkpoint across precision presets.

    params:     trained parameter tree (pre-quantization); each format
                deploys its own quantized copy of it.
    formats:    quantization specs — registered aliases and/or grammar
                strings (core.resolve_spec), evaluated in order. Put
                ``"bf16"`` among them to populate the delta columns.
    calib_batches_fn: zero-arg callable returning a fresh iterable of
                calibration batches; invoked once per act-quantizing
                spec (a8 / afp8 arms) and passed to
                ``deploy(calib_batches=...)``. None = dynamic per-token
                activation quantization.
    deploy_kwargs: serving knobs forwarded to every deploy() call —
                slots, max_len, paged, page_size, num_pages, horizon,
                matmul_impl/paged_attn_impl, smoke, ctx, device,
                draft_spec/draft_lookahead (speculative decoding: the
                grid's token streams are unchanged by the
                greedy-equivalence invariant, but every pair row gains
                its acceptance_rate column)... (deploy() itself derives
                each format's activation route from the spec, so one
                ctx serves the whole sweep).
    trace:      deploy each format's engine with lifecycle tracing on
                and record its scheduler round-phase totals in the
                row's ``round_phases`` column (schema v5) — token
                streams and scores are unchanged (tracing is a pure
                observer); untraced sweeps record None.
    """
    resolved = [resolve_spec(f) for f in formats]   # fail fast on typos
    dk = dict(deploy_kwargs or {})
    rows: List[FormatRow] = []
    anchor: Optional[FormatRow] = None
    for fmt, spec in zip(formats, resolved):
        calib = None
        if calib_batches_fn is not None and spec.quantizes_act:
            calib = calib_batches_fn()
        if trace:
            dk["trace"] = TraceConfig()   # fresh Tracer per engine
        pipe = deploy(arch_or_cfg, fmt, params=params,
                      calib_batches=calib, **dk)
        scores = evaluate_pairs(pipe, pair_list, n_sent=n_sent, seed=seed,
                                max_new_tokens=max_new_tokens,
                                languages=languages)
        agg = summarize(scores)
        phases = None
        if trace:
            m = pipe.engine.metrics()
            phases = {f"{p}_ms": round(getattr(m, f"phase_{p}_ms"), 3)
                      for p in PHASES}
        row = FormatRow(
            fmt=fmt, spec=pipe.spec_str, model_bytes=pipe.quantized_bytes,
            fp_bytes=pipe.fp_bytes,
            compression=round(pipe.compression, 3),
            kv_cache_bytes=pipe.engine.kv_cache_bytes,
            mean_bleu=agg["mean_bleu"], mean_chrf=agg["mean_chrf"],
            mean_token_acc=agg["mean_token_acc"],
            mean_tok_s=round(agg["mean_tok_s"], 1),
            gen_tokens=agg["gen_tokens"],
            ttft_p95_ms=round(max(s.ttft_p95_ms for s in scores), 3)
            if scores else None,
            tpot_p95_ms=round(max(s.tpot_p95_ms for s in scores), 3)
            if scores else None,
            round_phases=phases,
            bleu_delta=None, chrf_delta=None,
            calibrated=pipe.ctx.act_scales is not None,
            pair_scores=tuple(scores))
        if fmt == ANCHOR:
            anchor = row
        rows.append(row)
        log(f"[sweep] {fmt:5s} ({row.spec}) bleu {row.mean_bleu:.3f} chrf "
            f"{row.mean_chrf:.3f} bytes {row.model_bytes} "
            f"({row.compression:.2f}x) tok/s {row.mean_tok_s}")
    if anchor is not None:
        rows = [dataclasses.replace(
            r, bleu_delta=None if r.fmt == ANCHOR
            else round(r.mean_bleu - anchor.mean_bleu, 6),
            chrf_delta=None if r.fmt == ANCHOR
            else round(r.mean_chrf - anchor.mean_chrf, 6)) for r in rows]
    return rows
