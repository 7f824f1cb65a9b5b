"""Quality-report artifact: stable JSON schema + markdown rendering.

The port's copy of the reference's ``eval/report.py``. The schema and its
``kind`` ("repro.eval") are the reference's, so a report written by either
package loads in the other.

CI's eval-smoke job uploads these next to the perf BENCH JSONs, so a
run-over-run quality trajectory exists for the same commits the perf
trajectory covers. The schema is deliberately boring and guaranteed to
round-trip: ``load(dump(report)) == report`` (enforced by ``save`` on
every write and by a CI guard) — dicts/lists/str/int/float/bool/None
only, non-finite floats mapped to None, numpy scalars unwrapped.

    report = make_report(arch="nllb600m", rows=[r.as_row() for r in rows],
                         config={"formats": [...], "pairs": [...]})
    save(report, "eval_report.json")
    print(render_markdown(report))
"""

from __future__ import annotations

import json
import math
import subprocess
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["SCHEMA_VERSION", "make_report", "dump", "load", "save",
           "render_markdown"]

# v2: every sweep row records the fully-resolved quantization spec
# string ("spec") next to the requested alias ("fmt").
# v3: every per-pair entry carries an "acceptance_rate" column
# (speculative-decode draft acceptance; None for target-only runs).
# v4: every sweep row carries format-level "ttft_p95_ms"/"tpot_p95_ms"
# columns (worst direction over the pair grid — the numbers an
# SLATarget is written against; None for pre-v4 runs).
# v5: every sweep row carries a "round_phases" column — the serving
# engine's scheduler round-phase wall-time totals
# ({admit,dispatch,sync,walk}_ms from the obs tracer) for the grid
# that produced the row; None for untraced (and all pre-v5) runs.
# Older reports are upgraded on load, one version at a time.
SCHEMA_VERSION = 5


def _git_rev() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def _jsonify(x: Any) -> Any:
    """Coerce to round-trippable JSON types (see module docstring)."""
    if hasattr(x, "item") and not isinstance(x, (str, bytes)):
        x = x.item()                   # numpy scalars
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, (str, int, bool)) or x is None:
        return x
    if isinstance(x, dict):
        return {str(k): _jsonify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set)):
        return [_jsonify(v) for v in x]
    raise TypeError(f"cannot serialize {type(x).__name__} into a report")


def make_report(*, arch: str, rows: Sequence[Dict[str, Any]],
                config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble a current-schema report dict (already JSON-clean).

    ``rows`` is one dict per precision format (FormatRow.as_row()), each
    carrying its nested per-pair grid. ``config`` records how the run
    was produced (formats, pairs, train steps, serving knobs, seed) so
    trajectories compare like with like.
    """
    return _jsonify({
        "schema": SCHEMA_VERSION,
        "kind": "repro.eval",
        "arch": arch,
        "git_rev": _git_rev(),
        "config": config or {},
        "rows": list(rows),
    })


def dump(report: Dict[str, Any]) -> str:
    return json.dumps(report, indent=2, sort_keys=True, allow_nan=False)


def _upgrade_v1(report: Dict[str, Any]) -> Dict[str, Any]:
    """Schema 1 -> 2: derive each row's resolved spec string from its
    format alias (falling back to the alias itself for names the current
    registry no longer resolves)."""
    from ..core import resolve_spec
    rows = []
    for row in report.get("rows", []):
        row = dict(row)
        if "spec" not in row:
            try:
                row["spec"] = str(resolve_spec(row.get("fmt")))
            except (ValueError, TypeError):
                row["spec"] = row.get("fmt")
        rows.append(row)
    return {**report, "schema": 2, "rows": rows}


def _upgrade_v2(report: Dict[str, Any]) -> Dict[str, Any]:
    """Schema 2 -> 3: per-pair entries gain the speculative-decode
    "acceptance_rate" column — None, the exact value a target-only run
    records, since pre-v3 runs had no draft arm."""
    rows = []
    for row in report.get("rows", []):
        row = dict(row)
        if row.get("pair_scores"):
            row["pair_scores"] = [
                {"acceptance_rate": None, **p} for p in row["pair_scores"]]
        rows.append(row)
    return {**report, "schema": 3, "rows": rows}


def _upgrade_v3(report: Dict[str, Any]) -> Dict[str, Any]:
    """Schema 3 -> 4: sweep rows gain format-level "ttft_p95_ms" /
    "tpot_p95_ms" latency columns. Pre-v4 runs measured per-pair
    percentiles but never rolled them up, so the roll-up is recomputed
    where pair data exists (max over directions, matching quant_sweep)
    and None otherwise."""
    rows = []
    for row in report.get("rows", []):
        row = dict(row)
        for col in ("ttft_p95_ms", "tpot_p95_ms"):
            if col not in row:
                vals = [p[col] for p in row.get("pair_scores") or []
                        if isinstance(p.get(col), (int, float))]
                row[col] = max(vals) if vals else None
        rows.append(row)
    return {**report, "schema": 4, "rows": rows}


def _upgrade_v4(report: Dict[str, Any]) -> Dict[str, Any]:
    """Schema 4 -> 5: sweep rows gain the "round_phases" column — the
    scheduler's per-phase wall-time totals from the obs tracer. Pre-v5
    runs were never traced, so the value is None: exactly what an
    untraced v5 run records."""
    rows = []
    for row in report.get("rows", []):
        row = dict(row)
        if "round_phases" not in row:
            row["round_phases"] = None
        rows.append(row)
    return {**report, "schema": 5, "rows": rows}


_UPGRADES = {1: _upgrade_v1, 2: _upgrade_v2, 3: _upgrade_v3, 4: _upgrade_v4}


def load(text: str) -> Dict[str, Any]:
    """Parse a report; older artifacts are upgraded one schema version
    at a time (current-schema reports round-trip unchanged:
    load(dump(x)) == x)."""
    report = json.loads(text)
    if isinstance(report, dict) and report.get("kind") == "repro.eval":
        while report.get("schema") in _UPGRADES:
            report = _UPGRADES[report["schema"]](report)
    return report


def save(report: Dict[str, Any], path: str) -> None:
    """Write the artifact; refuses to emit anything that won't round-trip."""
    text = dump(report)
    if load(text) != report:
        raise ValueError(
            "report does not round-trip through JSON — non-native types "
            "slipped past make_report")
    with open(path, "w") as f:
        f.write(text + "\n")


# ---------------------------------------------------------------------------
# markdown rendering
# ---------------------------------------------------------------------------

def _fmt(v: Any, nd: int = 3, signed: bool = False) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:+.{nd}f}" if signed else f"{v:.{nd}f}"
    return str(v)


def _sweep_table(rows: List[Dict[str, Any]]) -> List[str]:
    head = ("| format | spec | BLEU | ΔBLEU | chrF | ΔchrF | model MB "
            "| compr | kv MB | tok/s | ttft p95 | tpot p95 | calib |")
    sep = "|---" * 13 + "|"
    lines = [head, sep]
    for r in rows:
        lines.append(
            f"| {r['fmt']} | {r.get('spec', r['fmt'])}"
            f" | {_fmt(r['mean_bleu'])}"
            f" | {_fmt(r['bleu_delta'], signed=True)}"
            f" | {_fmt(r['mean_chrf'])}"
            f" | {_fmt(r['chrf_delta'], signed=True)}"
            f" | {r['model_bytes'] / 2**20:.2f} | {_fmt(r['compression'], 2)}x"
            f" | {r['kv_cache_bytes'] / 2**20:.2f}"
            f" | {_fmt(r['mean_tok_s'], 1)}"
            f" | {_fmt(r.get('ttft_p95_ms'), 1)}"
            f" | {_fmt(r.get('tpot_p95_ms'), 2)}"
            f" | {'static' if r.get('calibrated') else 'dyn'} |")
    return lines


def _pair_grid(pair_scores: List[Dict[str, Any]], metric: str) -> List[str]:
    """src-rows x tgt-cols grid of one metric ('—' for absent cells)."""
    srcs = sorted({p["src"] for p in pair_scores})
    tgts = sorted({p["tgt"] for p in pair_scores})
    cell = {(p["src"], p["tgt"]): p[metric] for p in pair_scores}
    lines = ["| src\\tgt | " + " | ".join(tgts) + " |",
             "|---" * (len(tgts) + 1) + "|"]
    for s in srcs:
        vals = [_fmt(cell.get((s, t))) for t in tgts]
        lines.append(f"| {s} | " + " | ".join(vals) + " |")
    return lines


def render_markdown(report: Dict[str, Any], metric: str = "chrf") -> str:
    """Human-readable summary: sweep table + per-format pair grids."""
    rows = report.get("rows", [])
    lines = [f"# {report.get('kind', 'repro.eval')} — "
             f"{report.get('arch', '?')} @ {report.get('git_rev') or 'dirty'}",
             ""]
    cfg = report.get("config") or {}
    if cfg:
        lines += ["```", json.dumps(cfg, sort_keys=True), "```", ""]
    if rows:
        lines += ["## Quality vs precision (pair-grid means)", ""]
        lines += _sweep_table(rows)
        lines.append("")
        for r in rows:
            ps = r.get("pair_scores") or []
            if not ps:
                continue
            lines += [f"## {r['fmt']}: per-pair {metric}", ""]
            lines += _pair_grid(ps, metric)
            lines.append("")
    return "\n".join(lines)
