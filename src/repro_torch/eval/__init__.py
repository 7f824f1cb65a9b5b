"""Quality evaluation: the paper's experimental grid as a subsystem.

The reference's ``eval`` package over the port's serving engine:

  metrics  — dependency-free corpus BLEU / chrF / chrF++ over token-id
             sequences, streaming accumulators (a copy of the
             reference's);
  suite    — bidirectional language-pair matrix runner driven through
             the serving engine (no decode loop of its own);
  sweep    — one trained checkpoint evaluated across precision presets,
             quality-vs-size-vs-throughput with bf16-anchor deltas;
  report   — JSON + markdown artifact writer, schema shared with the
             reference (a report written by either package loads in the
             other).

CLI: ``python -m repro_torch.launch.eval --smoke --device cpu --json out.json``.
"""

from .metrics import (BleuScore, BleuStat, ChrFStat, CorpusStat,
                      corpus_bleu, corpus_chrf, exact_match, token_accuracy)
from .report import load, make_report, render_markdown, save
from .suite import (PairScore, assert_serving_equivalence,
                    assert_spec_decode_equivalence, decode_token_grid,
                    evaluate_pairs, summarize)
from .sweep import FormatRow, quant_sweep

__all__ = ["BleuScore", "BleuStat", "ChrFStat", "CorpusStat", "corpus_bleu",
           "corpus_chrf", "exact_match", "token_accuracy", "PairScore",
           "evaluate_pairs", "summarize", "FormatRow", "quant_sweep",
           "make_report", "render_markdown", "save", "load",
           "decode_token_grid", "assert_spec_decode_equivalence",
           "assert_serving_equivalence"]
