"""LR schedules: pure functions of the step counter, computed in f32.

``step`` may be a Python number (the result is a float) or a tensor (the
result is an f32 tensor on its device, so a train step reads no value
back to the host).
"""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_linear", "warmup_cosine"]


def _schedule(step, peak_lr, warmup, total, decay_fn):
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
    out = torch.where(s < warmup, warm, decay_fn(frac))
    return out if isinstance(step, torch.Tensor) else float(out)


def warmup_linear(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.0):
    return _schedule(step, peak_lr, warmup, total,
                     lambda frac: peak_lr + (floor - peak_lr) * frac)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.0):
    return _schedule(step, peak_lr, warmup, total,
                     lambda frac: floor + 0.5 * (peak_lr - floor)
                     * (1 + torch.cos(math.pi * frac)))
