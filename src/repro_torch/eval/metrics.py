"""Corpus translation-quality metrics, dependency-free.

The port's copy of the reference's ``eval/metrics.py`` (standard library
only): the same sentence pairs give the same scores, float for float.

BLEU (Papineni 2002) and chrF/chrF++ (Popović 2015/2017) implemented
directly over *token-id sequences* so the synthetic permutation-
translation task (data/synthetic.py) scores without a tokenizer: each
token id plays the role of a word (BLEU) or a character (chrF). An
optional ``detok`` callable maps an id sequence to a string, recovering
the standard text-level definitions for real checkpoints.

Everything streams: the per-metric accumulators (`BleuStat`, `ChrFStat`)
fold one (hypothesis, reference) pair at a time and merge across shards,
so million-sentence corpora never need materialization — `CorpusStat`
bundles all four metrics behind one ``update``.

Conventions (matching sacrebleu where a choice exists):
  * BLEU: clipped n-gram precisions up to ``max_n`` (default 4),
    multiplicative brevity penalty ``exp(1 - ref/hyp)`` for short
    hypotheses, smoothing ``"none"`` | ``"add-k"`` (k added to the
    numerator and denominator of every order > 1) | ``"floor"``
    (zero-match orders contribute ``eps`` precision).
  * chrF: per-order match/total counts summed over the corpus; the
    final score averages precision and recall over orders that appear
    in hypothesis or reference, then takes the F_beta (beta=2). A
    ``word_order`` of n > 0 (chrF++ uses 2) appends n-gram slots over
    the word stream (``detok(ids).split()`` when detok is given, the
    raw id sequence otherwise).
  * Degenerate corpora score 0.0 rather than raising: empty hypothesis,
    empty corpus, or no overlapping orders.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["BleuScore", "BleuStat", "ChrFStat", "CorpusStat", "corpus_bleu",
           "corpus_chrf", "token_accuracy", "exact_match"]

Seq = Sequence  # token ids (ints) or characters (str elements)


def _ngram_counts(seq: Seq, n: int) -> Dict[Tuple, int]:
    counts: Dict[Tuple, int] = {}
    for i in range(len(seq) - n + 1):
        g = tuple(seq[i:i + n])
        counts[g] = counts.get(g, 0) + 1
    return counts


def _clipped_matches(hyp_counts: Dict, ref_counts: Dict) -> int:
    return sum(min(c, ref_counts.get(g, 0)) for g, c in hyp_counts.items())


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BleuScore:
    """Corpus BLEU decomposition (score in [0, 1], not percent)."""

    score: float
    precisions: Tuple[float, ...]
    brevity_penalty: float
    hyp_len: int
    ref_len: int


class BleuStat:
    """Streaming corpus-BLEU sufficient statistics.

    ``update`` folds one sentence pair; ``merge`` combines shards;
    ``score`` is pure (call it at any point, keep updating after).
    """

    def __init__(self, max_n: int = 4):
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1, got {max_n}")
        self.max_n = max_n
        self.matched = [0] * max_n       # clipped matches per order
        self.total = [0] * max_n         # hypothesis n-grams per order
        self.hyp_len = 0
        self.ref_len = 0

    def update(self, hyp: Seq, ref: Seq) -> None:
        self.hyp_len += len(hyp)
        self.ref_len += len(ref)
        for n in range(1, self.max_n + 1):
            hc = _ngram_counts(hyp, n)
            self.matched[n - 1] += _clipped_matches(hc, _ngram_counts(ref, n))
            self.total[n - 1] += max(len(hyp) - n + 1, 0)

    def merge(self, other: "BleuStat") -> "BleuStat":
        if other.max_n != self.max_n:
            raise ValueError(
                f"cannot merge BleuStat(max_n={other.max_n}) into max_n="
                f"{self.max_n}")
        self.matched = [a + b for a, b in zip(self.matched, other.matched)]
        self.total = [a + b for a, b in zip(self.total, other.total)]
        self.hyp_len += other.hyp_len
        self.ref_len += other.ref_len
        return self

    def score(self, smoothing: str = "add-k", k: float = 1.0,
              eps: float = 0.1) -> BleuScore:
        precisions = []
        for n in range(1, self.max_n + 1):
            m, t = self.matched[n - 1], self.total[n - 1]
            if smoothing == "add-k" and n > 1:
                m, t = m + k, t + k
            if t == 0:
                precisions.append(0.0)
                continue
            p = m / t
            if smoothing == "floor" and p == 0.0:
                p = eps / t
            precisions.append(p)
        if smoothing not in ("none", "add-k", "floor"):
            raise ValueError(f"unknown smoothing {smoothing!r}")
        if self.hyp_len == 0 or any(p == 0.0 for p in precisions):
            return BleuScore(0.0, tuple(precisions), 0.0 if not self.hyp_len
                             else self._bp(), self.hyp_len, self.ref_len)
        bp = self._bp()
        log_mean = sum(math.log(p) for p in precisions) / self.max_n
        return BleuScore(bp * math.exp(log_mean), tuple(precisions), bp,
                         self.hyp_len, self.ref_len)

    def _bp(self) -> float:
        if self.hyp_len >= self.ref_len:
            return 1.0
        return math.exp(1.0 - self.ref_len / self.hyp_len)


def corpus_bleu(hyps: Sequence[Seq], refs: Sequence[Seq], *, max_n: int = 4,
                smoothing: str = "add-k", k: float = 1.0,
                detok: Optional[Callable[[Seq], str]] = None) -> BleuScore:
    """One-shot corpus BLEU over parallel (hypothesis, reference) lists.

    With ``detok`` the unit is whitespace-split words of ``detok(ids)``;
    without it, the raw token ids.
    """
    if len(hyps) != len(refs):
        raise ValueError(f"got {len(hyps)} hypotheses vs {len(refs)} refs")
    stat = BleuStat(max_n)
    for h, r in zip(hyps, refs):
        if detok is not None:
            h, r = detok(h).split(), detok(r).split()
        stat.update(h, r)
    return stat.score(smoothing=smoothing, k=k)


# ---------------------------------------------------------------------------
# chrF / chrF++
# ---------------------------------------------------------------------------

class ChrFStat:
    """Streaming chrF sufficient statistics (char orders + word orders).

    Slots 0..max_n-1 hold character (= token id, unless detokenized)
    n-gram counts; slots max_n..max_n+word_order-1 hold word n-gram
    counts (the chrF++ extension; ``word_order=0`` is plain chrF).
    """

    def __init__(self, max_n: int = 6, beta: float = 2.0,
                 word_order: int = 0):
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1, got {max_n}")
        self.max_n = max_n
        self.beta = beta
        self.word_order = word_order
        slots = max_n + word_order
        self.matched = [0] * slots
        self.hyp_total = [0] * slots
        self.ref_total = [0] * slots

    def _fold(self, slot: int, hyp: Seq, ref: Seq, n: int) -> None:
        hc = _ngram_counts(hyp, n)
        rc = _ngram_counts(ref, n)
        self.matched[slot] += _clipped_matches(hc, rc)
        self.hyp_total[slot] += sum(hc.values())
        self.ref_total[slot] += sum(rc.values())

    def update(self, hyp: Seq, ref: Seq,
               hyp_words: Optional[Seq] = None,
               ref_words: Optional[Seq] = None) -> None:
        """Fold one pair. ``hyp``/``ref`` are the character streams; the
        word streams default to them when chrF++ word orders are on."""
        for n in range(1, self.max_n + 1):
            self._fold(n - 1, hyp, ref, n)
        if self.word_order:
            hw = hyp if hyp_words is None else hyp_words
            rw = ref if ref_words is None else ref_words
            for n in range(1, self.word_order + 1):
                self._fold(self.max_n + n - 1, hw, rw, n)

    def merge(self, other: "ChrFStat") -> "ChrFStat":
        if (other.max_n, other.word_order) != (self.max_n, self.word_order):
            raise ValueError("cannot merge ChrFStat of different orders")
        self.matched = [a + b for a, b in zip(self.matched, other.matched)]
        self.hyp_total = [a + b
                          for a, b in zip(self.hyp_total, other.hyp_total)]
        self.ref_total = [a + b
                          for a, b in zip(self.ref_total, other.ref_total)]
        return self

    def score(self) -> float:
        """Average P and R over populated orders, then F_beta."""
        precisions: List[float] = []
        recalls: List[float] = []
        for m, ht, rt in zip(self.matched, self.hyp_total, self.ref_total):
            if ht == 0 and rt == 0:
                continue                 # order absent from both streams
            precisions.append(m / ht if ht else 0.0)
            recalls.append(m / rt if rt else 0.0)
        if not precisions:
            return 0.0
        p = sum(precisions) / len(precisions)
        r = sum(recalls) / len(recalls)
        if p == 0.0 or r == 0.0:
            return 0.0
        b2 = self.beta ** 2
        return (1 + b2) * p * r / (b2 * p + r)


def corpus_chrf(hyps: Sequence[Seq], refs: Sequence[Seq], *, max_n: int = 6,
                beta: float = 2.0, word_order: int = 0,
                detok: Optional[Callable[[Seq], str]] = None) -> float:
    """One-shot corpus chrF (``word_order=2`` gives chrF++).

    With ``detok`` the character stream is the detokenized string and
    the word stream its whitespace split; without it both are the raw
    token-id sequence.
    """
    if len(hyps) != len(refs):
        raise ValueError(f"got {len(hyps)} hypotheses vs {len(refs)} refs")
    stat = ChrFStat(max_n, beta, word_order)
    for h, r in zip(hyps, refs):
        if detok is not None:
            hs, rs = detok(h), detok(r)
            stat.update(hs, rs, hs.split(), rs.split())
        else:
            stat.update(h, r)
    return stat.score()


# ---------------------------------------------------------------------------
# token accuracy / exact match
# ---------------------------------------------------------------------------

def token_accuracy(hyp: Seq, ref: Seq) -> float:
    """Position-aligned token accuracy; length mismatch counts as error."""
    denom = max(len(hyp), len(ref))
    if denom == 0:
        return 1.0
    hits = sum(1 for a, b in zip(hyp, ref) if a == b)
    return hits / denom


def exact_match(hyp: Seq, ref: Seq) -> bool:
    return len(hyp) == len(ref) and all(a == b for a, b in zip(hyp, ref))


# ---------------------------------------------------------------------------
# combined streaming accumulator
# ---------------------------------------------------------------------------

class CorpusStat:
    """All four metrics behind one streaming ``update(hyp, ref)``.

    Used by the pair-matrix suite so a pair's corpus is scored without
    ever holding more than one sentence pair (plus O(orders) counters).
    """

    def __init__(self, max_n: int = 4, chrf_max_n: int = 6,
                 beta: float = 2.0, word_order: int = 0,
                 detok: Optional[Callable[[Seq], str]] = None):
        self.bleu = BleuStat(max_n)
        self.chrf = ChrFStat(chrf_max_n, beta, word_order)
        self.detok = detok
        self.n_sent = 0
        self._acc_sum = 0.0
        self._exact = 0

    def update(self, hyp: Seq, ref: Seq) -> None:
        self.n_sent += 1
        self._acc_sum += token_accuracy(hyp, ref)
        self._exact += int(exact_match(hyp, ref))
        if self.detok is not None:
            hs, rs = self.detok(hyp), self.detok(ref)
            self.bleu.update(hs.split(), rs.split())
            self.chrf.update(hs, rs, hs.split(), rs.split())
        else:
            self.bleu.update(hyp, ref)
            self.chrf.update(hyp, ref)

    def merge(self, other: "CorpusStat") -> "CorpusStat":
        self.bleu.merge(other.bleu)
        self.chrf.merge(other.chrf)
        self.n_sent += other.n_sent
        self._acc_sum += other._acc_sum
        self._exact += other._exact
        return self

    def results(self, smoothing: str = "add-k") -> Dict[str, float]:
        n = max(self.n_sent, 1)
        return {"bleu": self.bleu.score(smoothing=smoothing).score,
                "chrf": self.chrf.score(),
                "token_acc": self._acc_sum / n,
                "exact_match": self._exact / n}
