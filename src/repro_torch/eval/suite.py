"""Bidirectional language-pair matrix runner (paper Fig. 9 grid).

The reference's ``eval/suite.py`` over the port's serving engine.

Given a deployed `TranslationPipeline` and a pair list, generates a
held-out `SyntheticTranslation` eval set per (src, tgt) direction and
serves every sentence **through the request-level engine** —
``pipe.translate`` (``engine.submit`` + ``run_until_drained``), so
whatever the pipeline was deployed with (dense or paged KV, any decode horizon, any kernel route)
is exactly what gets measured; the suite contains no decode loop of its
own. Scores therefore inherit the engine's equivalence guarantees:
dense == paged and horizon=1 == horizon=K produce identical grids
(asserted in tests/test_torch_eval.py and by chip_smoke.py's [eval]).

Per pair the suite reports corpus BLEU / chrF / token accuracy / exact
match (streamed through `metrics.CorpusStat`) plus serving figures from
`RequestStats`: tokens/s and the shared p50/p95 TTFT / per-output-token
percentiles (`serving.latency_percentiles`). Speculative deployments
(`deploy(..., draft_spec=...)`) additionally get a per-pair
`acceptance_rate` column (None on target-only pipelines), and
`assert_spec_decode_equivalence` gates the subsystem's core invariant:
the greedy spec-decode grid must equal the target-only grid
token-for-token, whatever the draft spec, cache layout, or horizon.
`assert_serving_equivalence` is the same gate generalized to any two
deployments of one checkpoint (two cache layouts, horizons or round
modes; mesh engines and replica routers come with scale-out): both must
serve the same grid exactly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..data import LANG_CODES, SyntheticTranslation, pairs as fig9_pairs
from ..serving import SamplingParams, latency_percentiles
from .metrics import CorpusStat

__all__ = ["PairScore", "evaluate_pairs", "summarize",
           "decode_token_grid", "assert_spec_decode_equivalence",
           "assert_serving_equivalence"]


@dataclasses.dataclass(frozen=True)
class PairScore:
    """Quality + serving figures for one (src -> tgt) direction."""

    src: str
    tgt: str
    bleu: float
    chrf: float
    token_acc: float
    exact_match: float
    n_sent: int
    gen_tokens: int
    tok_s: float                      # generated tokens / pair wall-clock
    ttft_p50_ms: float
    ttft_p95_ms: float
    tpot_p50_ms: float
    tpot_p95_ms: float
    # speculative decoding only: fraction of this pair's drafted tokens
    # the target verify accepted (None on target-only deployments —
    # acceptance is a *speed* signal, quality columns are identical by
    # the greedy-equivalence invariant)
    acceptance_rate: Optional[float] = None

    def as_row(self) -> Dict:
        return dataclasses.asdict(self)


def _ordered_langs(pair_list: Sequence[Tuple[str, str]]) -> List[str]:
    """Languages covered by the pairs, in canonical LANG_CODES order —
    permutation draws depend on language order, so train and eval must
    derive the tuple the same way (launch.eval uses this helper too)."""
    used = {lang for pair in pair_list for lang in pair}
    return [lang for lang in LANG_CODES if lang in used]


def evaluate_pairs(pipe, pair_list: Optional[Sequence[Tuple[str, str]]] = None,
                   *, n_sent: int = 8, seed: int = 0,
                   max_new_tokens: Optional[int] = None,
                   languages: Optional[Sequence[str]] = None,
                   warmup: bool = True) -> List[PairScore]:
    """Score every (src, tgt) direction through the deployed engine.

    pair_list:  (src, tgt) directions to evaluate; default is the full
                bidirectional Indic<->overseas Fig. 9 grid (72 cells).
    n_sent:     held-out sentences per direction.
    seed:       dataset seed — MUST match the seed the checkpoint was
                trained with so the per-language permutations line up
                (the eval *content* stream is disjoint regardless;
                see SyntheticTranslation split="eval").
    max_new_tokens: decode budget per sentence; default = the reference
                length, clamped to the engine's max_len - 1 (the 1-token
                lang-code prompt takes one cache position). References
                are truncated to the same budget so corpus statistics
                compare equal spans.
    languages:  language tuple the corpus was built over; default = the
                languages appearing in pair_list, in LANG_CODES order.
                Pass the training tuple explicitly when it was larger.
    warmup:     serve the first pair once untimed before measuring, so
                first-call costs (kernel loads, allocator growth) don't land in the first pair's tok_s/TTFT
                columns (scores are deterministic, only the serving
                figures change).
    """
    if pipe.cfg.family != "encdec":
        raise TypeError(
            f"pair evaluation needs a token-to-token enc-dec pipeline "
            f"(the synthetic corpus is src_tokens -> tgt), got family "
            f"{pipe.cfg.family!r}")
    pair_list = list(pair_list) if pair_list is not None else fig9_pairs()
    if not pair_list:
        raise ValueError("pair_list is empty")
    langs = list(languages) if languages is not None \
        else _ordered_langs(pair_list)
    cfg = pipe.cfg
    ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=seed,
                              languages=langs, split="eval")
    ref_len = cfg.enc_len - 2          # non-pad target span per sentence
    budget = pipe.engine.max_len - 1   # minus the lang-code prompt token
    gen = min(max_new_tokens or ref_len, ref_len, budget)
    if gen < 1:
        raise ValueError(
            f"engine max_len {pipe.engine.max_len} leaves no decode budget")
    sp = SamplingParams(max_new_tokens=gen)     # greedy, deterministic

    if warmup:
        # prime the engine on the first pair's exact request shapes,
        # then drop the first-call-tainted run. A separate dataset instance keeps the scored content
        # stream identical whether or not warmup ran.
        wds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=seed,
                                   languages=langs, split="eval")
        wsrc, wtgt = pair_list[0]
        pipe.translate(wds.sample(n_sent, pair=(wsrc, wtgt))["src_tokens"],
                       wtgt, sp)
        pipe.engine.reset_metrics()

    eng = pipe.engine
    scores: List[PairScore] = []
    for src_l, tgt_l in pair_list:
        batch = ds.sample(n_sent, pair=(src_l, tgt_l))
        refs = batch["tgt_out"][:, :gen]
        d0, a0 = eng.drafted_tokens, eng.accepted_tokens
        t0 = time.perf_counter()
        outs = pipe.translate(batch["src_tokens"], tgt_l, sp)
        dt = time.perf_counter() - t0
        # per-pair acceptance from the counter deltas (None when the
        # pair ran target-only: no draft arm, or no speculative rounds)
        drafted = eng.drafted_tokens - d0
        acc_rate = round((eng.accepted_tokens - a0) / drafted, 4) \
            if drafted else None

        stat = CorpusStat()
        for out, ref in zip(outs, refs):
            stat.update(out.token_ids, [int(t) for t in ref])
        m = stat.results()
        toks = sum(o.num_generated for o in outs)
        lat = latency_percentiles(outs)
        scores.append(PairScore(
            src=src_l, tgt=tgt_l, bleu=m["bleu"], chrf=m["chrf"],
            token_acc=m["token_acc"], exact_match=m["exact_match"],
            n_sent=n_sent, gen_tokens=toks,
            tok_s=round(toks / dt, 1) if dt > 0 else 0.0,
            acceptance_rate=acc_rate, **lat))
    return scores


def summarize(scores: Sequence[PairScore]) -> Dict[str, float]:
    """Grid-level aggregate (unweighted mean over directions)."""
    n = max(len(scores), 1)
    return {"pairs": len(scores),
            "mean_bleu": sum(s.bleu for s in scores) / n,
            "mean_chrf": sum(s.chrf for s in scores) / n,
            "mean_token_acc": sum(s.token_acc for s in scores) / n,
            "gen_tokens": sum(s.gen_tokens for s in scores),
            "mean_tok_s": sum(s.tok_s for s in scores) / n}


def decode_token_grid(pipe, pair_list: Optional[Sequence[Tuple[str, str]]]
                      = None, *, n_sent: int = 4, seed: int = 0,
                      max_new_tokens: Optional[int] = None,
                      languages: Optional[Sequence[str]] = None
                      ) -> Dict[Tuple[str, str], tuple]:
    """The raw greedy token grid: (src, tgt) -> per-sentence
    (token_ids, finish_reason) tuples, served through the engine exactly
    like evaluate_pairs but without scoring — the comparable object for
    equivalence gates (dense vs paged, horizon=1 vs K, spec-decode vs
    target-only)."""
    if pipe.cfg.family != "encdec":
        raise TypeError(
            f"token grids need a token-to-token enc-dec pipeline, got "
            f"family {pipe.cfg.family!r}")
    pair_list = list(pair_list) if pair_list is not None else fig9_pairs()
    langs = list(languages) if languages is not None \
        else _ordered_langs(pair_list)
    cfg = pipe.cfg
    ds = SyntheticTranslation(cfg.vocab_size, cfg.enc_len, seed=seed,
                              languages=langs, split="eval")
    ref_len = cfg.enc_len - 2
    budget = pipe.engine.max_len - 1
    gen = min(max_new_tokens or ref_len, ref_len, budget)
    sp = SamplingParams(max_new_tokens=gen)
    grid: Dict[Tuple[str, str], tuple] = {}
    for src_l, tgt_l in pair_list:
        batch = ds.sample(n_sent, pair=(src_l, tgt_l))
        outs = pipe.translate(batch["src_tokens"], tgt_l, sp)
        grid[(src_l, tgt_l)] = tuple(
            (tuple(o.token_ids), o.finish_reason) for o in outs)
    return grid


def assert_spec_decode_equivalence(spec_pipe, target_pipe,
                                   pair_list: Optional[
                                       Sequence[Tuple[str, str]]] = None,
                                   **grid_kwargs) -> None:
    """Gate the speculative-decoding invariant: the greedy grid served
    by a draft-armed pipeline must equal the target-only pipeline's
    grid token-for-token (finish reasons included). Raises
    AssertionError naming the first diverging pair. ``grid_kwargs``
    are forwarded to decode_token_grid (n_sent / seed / max_new_tokens
    / languages)."""
    want = decode_token_grid(target_pipe, pair_list, **grid_kwargs)
    got = decode_token_grid(spec_pipe, pair_list, **grid_kwargs)
    for pair, ref in want.items():
        if got[pair] != ref:
            raise AssertionError(
                f"speculative decode diverged from target-only on "
                f"{pair[0]}->{pair[1]} (draft "
                f"{spec_pipe.draft_spec_str}): {got[pair]} != {ref}")


def assert_serving_equivalence(pipe, ref_pipe,
                               pair_list: Optional[
                                   Sequence[Tuple[str, str]]] = None,
                               label: str = "deployment",
                               **grid_kwargs) -> None:
    """Gate the cluster invariant: ``pipe`` (a tensor-parallel mesh
    engine, a ReplicaRouter deployment — any serving stack over the
    same checkpoint) must serve the identical greedy grid as
    ``ref_pipe``, token-for-token with finish reasons. Raises
    AssertionError naming ``label`` and the first diverging pair;
    ``grid_kwargs`` forward to decode_token_grid."""
    want = decode_token_grid(ref_pipe, pair_list, **grid_kwargs)
    got = decode_token_grid(pipe, pair_list, **grid_kwargs)
    for pair, ref in want.items():
        if got[pair] != ref:
            raise AssertionError(
                f"{label} serving diverged from reference on "
                f"{pair[0]}->{pair[1]}: {got[pair]} != {ref}")
