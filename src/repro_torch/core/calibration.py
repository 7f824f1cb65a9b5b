"""Per-site activation calibration for static quantization (paper §III).

The act-quantizing arms (w8a8, the fp8 end-to-end arm) quantize their
activations at static scales calibrated on sample batches. The
calibrator keeps one absmax statistic *per matmul site* (``enc.attn.qkv``,
``dec.ffn.in``, ``dec.cross.kv``, ``head``, ...: the labels model code
passes to ``Ctx.dot``) instead of one global scalar:

    scales = calibrate_act_scales(model, params, ctx, batches)
    ctx = dataclasses.replace(ctx, act_scales=tuple(sorted(scales.items())))

Each site's static scale is ``absmax / max_code`` for the deployed
activation format; sites never observed fall back to dynamic per-token
quantization at serve time (core.qlinear).

On a tensor-parallel rank (``ctx.tp``) the passes run on the rank's shard
through its local model, so a row-parallel input and a per-head
attention operand are observed on the rank's slice; the ranks' site
tables are then merged by ``max`` once (``TPGroup.all_max``), which gives
every rank the same table, and one device's absmax at every site.
"""

from __future__ import annotations

import dataclasses
import statistics
import warnings
from typing import Callable, Dict, Iterable, Optional

import torch

from .formats import get_format

__all__ = ["ActSiteStats", "SiteCollector", "calibrate_act_scales",
           "calibrate_act_scale", "calibrated_ctx", "ActStats", "calibrate"]

_UNSITED = "unsited"      # matmuls whose call site passed no label


class ActSiteStats:
    """Streaming per-site absmax registry.

    ``update`` folds one observation; ``merge`` combines registries from
    independent batch streams. Both reduce with ``max``, so the scales do
    not depend on the order of batches.
    """

    def __init__(self, absmax: Dict[str, float] | None = None):
        self.absmax: Dict[str, float] = dict(absmax or {})

    def update(self, site: str, value: float) -> None:
        self.absmax[site] = max(self.absmax.get(site, 0.0), float(value))

    def merge(self, other: "ActSiteStats") -> "ActSiteStats":
        out = ActSiteStats(self.absmax)
        for site, v in other.absmax.items():
            out.update(site, v)
        return out

    def scales(self, max_code: float = 127.0) -> Dict[str, float]:
        """site -> static activation scale (absmax / max_code)."""
        return {site: max(v, 1e-8) / max_code for site, v in self.absmax.items()}

    def __len__(self) -> int:
        return len(self.absmax)


class SiteCollector:
    """The sink ``Ctx.dot`` reports activations to. ``observe`` folds a
    site's |x| max on the tensor's device (no host sync per matmul);
    ``flush`` reads the pending maxima into ``stats`` once."""

    def __init__(self):
        self.stats = ActSiteStats()
        self._pending: Dict[str, torch.Tensor] = {}
        self.device = None

    def observe(self, site: str | None, x: torch.Tensor) -> None:
        site = site or _UNSITED
        self.device = x.device
        m = x.detach().to(torch.float32).abs().amax()
        prev = self._pending.get(site)
        self._pending[site] = m if prev is None else torch.maximum(prev, m)

    def flush(self) -> None:
        for site, m in self._pending.items():
            self.stats.update(site, m.item())
        self._pending.clear()

    def merge_ranks(self, tp) -> None:
        """Every site's absmax replaced by its max over the ranks of the
        tensor-parallel group ``tp``: one collective over the sorted
        site table (the ranks run one model, so they observe one set of
        sites)."""
        sites = sorted(self.stats.absmax)
        if tp is None or not sites:
            return
        local = torch.tensor([self.stats.absmax[k] for k in sites], dtype=torch.float32,
                             device=self.device)
        merged = tp.all_max(local).tolist()
        self.stats = ActSiteStats(dict(zip(sites, merged)))


@torch.no_grad()
def calibrate_act_scales(model, params, ctx, batches: Iterable,
                         max_code: float = 127.0) -> Dict[str, float]:
    """Per-site static activation scales for an act-quantizing deploy.

    Runs teacher-forced forward passes (``model.forward``) over
    ``batches`` with a collector-carrying Ctx on the bf16 activation
    route: every activation entering a quantized-weight matmul
    (qlinear.act_quant_eligible) reports its absmax under its site label,
    folded with ``max`` across batches and across the layers that share a
    label. ``params`` should be the already-quantized tree being deployed,
    so the observed activations are what the quantized path sees.

    ``max_code`` is the deployed format's absmax code (127 for int8, 448
    for fp8 e4m3). Returns ``{}`` when ``batches`` is empty; callers then
    quantize dynamically (deploy() warns). Under ``ctx.tp`` ``model`` and
    ``params`` are the rank's, every rank passes the same batches, and
    the tables are merged over the ranks (the module docstring).
    """
    collector = SiteCollector()
    cctx = dataclasses.replace(ctx, act_fmt="bf16", act_collector=collector)
    saw_batch = False
    for batch in batches:
        saw_batch = True
        model.forward(cctx, params, batch)
        collector.flush()
    if saw_batch and not len(collector.stats):
        raise ValueError(
            "calibration saw no quantized-weight matmuls — the deployed "
            "tree has no QTensor sites to calibrate (was the policy a "
            "bf16/f32 passthrough?)")
    collector.merge_ranks(ctx.tp)
    return collector.stats.scales(max_code)


def calibrate_act_scale(model, params, ctx, batches: Iterable,
                        max_code: float = 127.0) -> float:
    """Legacy single-scalar calibration: the largest per-site scale.
    Prefer calibrate_act_scales."""
    scales = calibrate_act_scales(model, params, ctx, batches, max_code=max_code)
    if not scales:
        raise ValueError(
            "calibration consumed no batches — pass a non-empty (fresh, "
            "not already-iterated) batch iterable")
    return max(scales.values())


def calibrated_ctx(ctx, model, params, batches: Optional[Iterable], fmt: str,
                   what: str):
    """``ctx`` with the per-site static scales calibrated on ``batches`` for
    activation format ``fmt`` (deploy()'s and the draft arm's route). With
    no batches, or an empty iterable, it warns and returns ``ctx``: the
    activations stay quantized, dynamically per token."""
    scales = {}
    if batches is not None:
        scales = calibrate_act_scales(model, params, ctx, batches,
                                      max_code=get_format(fmt).max_code)
    if scales:
        return dataclasses.replace(ctx, act_scales=tuple(sorted(scales.items())))
    warnings.warn(
        f"{what} but no calibration batches were provided (or the iterable "
        "was empty); falling back to dynamic per-token activation "
        "quantization — pass deploy(calib_batches=...) for the paper's "
        "calibrated static-scale deployment", stacklevel=3)
    return ctx


def _percentile(x: torch.Tensor, q: float) -> float:
    """Linear-interpolation percentile of all of ``x`` (torch.quantile
    refuses inputs above 2**24 elements)."""
    v = torch.sort(x.reshape(-1).to(torch.float32)).values
    pos = torch.tensor(q / 100.0, dtype=torch.float32) * (v.numel() - 1)
    lo, hi = int(torch.floor(pos)), int(torch.ceil(pos))
    w = pos - lo
    return float(v[lo].cpu() * (1 - w) + v[hi].cpu() * w)


class ActStats:
    """Streaming absmax plus a per-batch percentile estimate."""

    def __init__(self, percentile: float = 99.9):
        self.percentile = percentile
        self.absmax = 0.0
        self.samples: list[float] = []

    def update(self, x: torch.Tensor):
        ax = x.abs()
        self.absmax = max(self.absmax, float(ax.amax()))
        # per-batch percentile; the estimate is the median of them
        self.samples.append(_percentile(ax, self.percentile))

    def scale(self, max_code: float = 127.0) -> float:
        if not self.samples:
            return 1.0
        return max(statistics.median(self.samples), 1e-8) / max_code


def calibrate(apply_fn: Callable, batches: Iterable, percentile=99.9) -> ActStats:
    """Run ``apply_fn(batch) -> activation`` over batches, fold statistics."""
    stats = ActStats(percentile)
    for b in batches:
        stats.update(apply_fn(b))
    return stats
