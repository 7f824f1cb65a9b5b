"""Histogram + percentile primitives and Prometheus text exposition.

One percentile definition for the whole repo
--------------------------------------------
:func:`percentile` is the single definition (nearest rank) that
``serving.latency_percentiles``, ``SLAController``'s windowed p95 and
the ``EngineMetrics`` histogram columns all use, so an SLA the
controller holds can never read as violated in a report.

``Histogram`` is a fixed log-bucket histogram: O(1) memory regardless
of sample count, mergeable across engines/replicas, and cheap enough to
record into from the serving engine's retire path unconditionally. Its
``percentile`` returns the *upper edge* of the bucket holding the
nearest-rank sample (the standard Prometheus-style bound; exact values
are not retained).
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = ["percentile", "Histogram", "render_prometheus",
           "render_prometheus_labeled"]


def percentile(vals: Iterable[float], q: float) -> float:
    """Nearest-rank percentile over raw samples.

    ``rank = round(q/100 * (n - 1))`` on the sorted sample — exactly the
    definition ``SLAController`` shipped with, so consolidating onto
    this helper changes no admission decisions. Returns 0.0 on an empty
    sample (callers treat "no data" as "no latency to report").
    """
    s = sorted(float(v) for v in vals)
    if not s:
        return 0.0
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    rank = int(round(q / 100.0 * (len(s) - 1)))
    return s[max(0, min(len(s) - 1, rank))]


# Bucket boundaries are derived from (lo, growth, n_buckets) once per
# config and shared between histograms so merge() can compare cheaply.
_BOUNDS_CACHE: Dict[Tuple[float, float, int], Tuple[float, ...]] = {}


def _bounds(lo: float, growth: float, n_buckets: int) -> Tuple[float, ...]:
    key = (lo, growth, n_buckets)
    b = _BOUNDS_CACHE.get(key)
    if b is None:
        if lo <= 0.0:
            raise ValueError(f"histogram lo must be > 0, got {lo}")
        if growth <= 1.0:
            raise ValueError(f"histogram growth must be > 1, got {growth}")
        if n_buckets < 1:
            raise ValueError(f"histogram needs >= 1 bucket, got {n_buckets}")
        b = tuple(lo * growth**i for i in range(n_buckets))
        _BOUNDS_CACHE[key] = b
    return b


class Histogram:
    """Fixed log-bucket histogram with merge and nearest-rank quantiles.

    Bucket ``i`` counts samples in ``(bounds[i-1], bounds[i]]``; bucket 0
    additionally absorbs everything ``<= lo`` (including zeros), and one
    overflow bucket absorbs samples above the last bound. Defaults cover
    1 microsecond to ~18 minutes when samples are milliseconds.
    """

    __slots__ = ("lo", "growth", "n_buckets", "bounds", "counts",
                 "overflow", "count", "total")

    def __init__(self, lo: float = 1e-3, growth: float = 2.0,
                 n_buckets: int = 30):
        self.lo = float(lo)
        self.growth = float(growth)
        self.n_buckets = int(n_buckets)
        self.bounds = _bounds(self.lo, self.growth, self.n_buckets)
        self.counts = [0] * self.n_buckets
        self.overflow = 0
        self.count = 0
        self.total = 0.0

    def config(self) -> Tuple[float, float, int]:
        return (self.lo, self.growth, self.n_buckets)

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        b = self.bounds
        if v > b[-1]:
            self.overflow += 1
            return
        self.counts[bisect.bisect_left(b, v)] += 1

    def merge(self, other: "Histogram") -> "Histogram":
        """Add ``other``'s samples into self (in place); returns self."""
        if other.config() != self.config():
            raise ValueError(
                f"cannot merge histograms with configs {self.config()} "
                f"and {other.config()}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.overflow += other.overflow
        self.count += other.count
        self.total += other.total
        return self

    def reset(self) -> None:
        self.counts = [0] * self.n_buckets
        self.overflow = 0
        self.count = 0
        self.total = 0.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Upper bucket edge holding the nearest-rank sample (0.0 if empty)."""
        if self.count == 0:
            return 0.0
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        rank = int(round(q / 100.0 * (self.count - 1)))
        rank = max(0, min(self.count - 1, rank))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen > rank:
                return self.bounds[i]
        return self.bounds[-1]  # nearest-rank sample sits in overflow

    def as_dict(self) -> Dict[str, object]:
        return {
            "lo": self.lo, "growth": self.growth,
            "n_buckets": self.n_buckets, "count": self.count,
            "total": self.total, "overflow": self.overflow,
            "counts": list(self.counts),
        }


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render without exponent."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels: Optional[Mapping[str, str]],
               extra: Optional[Tuple[str, str]] = None) -> str:
    """Rendered ``{k="v",...}`` block (empty string when no labels)."""
    pairs = sorted((labels or {}).items())
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def render_prometheus(
    snapshot: object,
    histograms: Optional[Mapping[str, Histogram]] = None,
    prefix: str = "repro_serving",
    labels: Optional[Mapping[str, str]] = None,
    emit_type: bool = True,
) -> str:
    """Render an ``EngineMetrics``-like snapshot + histograms as
    Prometheus text exposition (version 0.0.4).

    ``snapshot`` needs ``as_dict()`` (or may already be a mapping); a
    ``GAUGES`` class attribute names fields that are levels rather than
    monotone counters. Everything else integral is typed ``counter``,
    floats are typed ``gauge`` (derived values such as percentiles).

    ``labels`` stamps every sample line with the same label set (e.g.
    ``{"replica": "2"}`` for a per-replica cluster section); histogram
    buckets merge them with their ``le`` label. ``emit_type=False``
    drops the ``# TYPE`` comments — required when a caller renders one
    metric family several times with different label values (the text
    format allows each TYPE declaration at most once per exposition).
    """
    if hasattr(snapshot, "as_dict"):
        d = snapshot.as_dict()  # type: ignore[attr-defined]
    else:
        d = dict(snapshot)  # type: ignore[arg-type]
    gauges = frozenset(getattr(type(snapshot), "GAUGES", ()) or ())
    lbl = _label_str(labels)
    lines: List[str] = []
    for k in sorted(d):
        v = d[k]
        if v is None or isinstance(v, (str, bytes, dict, list, tuple)):
            continue
        name = f"{prefix}_{k}"
        typ = "gauge" if (k in gauges or isinstance(v, float)) else "counter"
        if emit_type:
            lines.append(f"# TYPE {name} {typ}")
        lines.append(f"{name}{lbl} {_fmt(v)}")
    for hname in sorted(histograms or {}):
        h = histograms[hname]  # type: ignore[index]
        name = f"{prefix}_{hname}"
        if emit_type:
            lines.append(f"# TYPE {name} histogram")
        cum = 0
        for le, c in zip(h.bounds, h.counts):
            cum += c
            bl = _label_str(labels, ("le", _fmt(le)))
            lines.append(f"{name}_bucket{bl} {cum}")
        lines.append(f'{name}_bucket{_label_str(labels, ("le", "+Inf"))} '
                     f"{h.count}")
        lines.append(f"{name}_sum{lbl} {_fmt(h.total)}")
        lines.append(f"{name}_count{lbl} {h.count}")
    return "\n".join(lines) + "\n"


def render_prometheus_labeled(
    snapshots: Sequence[Tuple[Mapping[str, str], object]],
    prefix: str = "repro_serving",
) -> str:
    """One exposition over N label-distinguished snapshots of the same
    family set (e.g. per-replica EngineMetrics, labelled
    ``{"replica": "0"}`` .. ``{"replica": "N-1"}``).

    Unlike calling :func:`render_prometheus` once per snapshot and
    concatenating — which interleaves metric families and repeats TYPE
    declarations, both invalid in the text format — this groups lines
    per family: one TYPE comment, then one labelled sample per
    snapshot, for every field present in any snapshot.
    """
    dicts = []
    gauges: set = set()
    for labels, snap in snapshots:
        d = snap.as_dict() if hasattr(snap, "as_dict") else dict(snap)
        dicts.append((labels, d))
        gauges.update(getattr(type(snap), "GAUGES", ()) or ())
    keys = sorted({k for _, d in dicts for k in d})
    lines: List[str] = []
    for k in keys:
        vals = [(labels, d[k]) for labels, d in dicts
                if k in d and d[k] is not None
                and not isinstance(d[k], (str, bytes, dict, list, tuple))]
        if not vals:
            continue
        name = f"{prefix}_{k}"
        typ = ("gauge" if (k in gauges
                           or any(isinstance(v, float) for _, v in vals))
               else "counter")
        lines.append(f"# TYPE {name} {typ}")
        for labels, v in vals:
            lines.append(f"{name}{_label_str(labels)} {_fmt(v)}")
    return "\n".join(lines) + "\n"
