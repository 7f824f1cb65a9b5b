"""Blockwise-int8 gradient compression (the reference's
``optim/compression.py``).

``quantize_grads_int8`` flattens a gradient into 256-value blocks with
one f32 absmax scale each; its codes and scales are byte-equal to the
compiled reference's. The compressed all-reduce over data-parallel
replicas comes with scale-out.
"""

from __future__ import annotations

import torch

from ..core.qlinear import f32_reciprocal
from ..unported import later

__all__ = ["quantize_grads_int8", "compressed_psum"]

_BLOCK = 256


def quantize_grads_int8(g: torch.Tensor):
    """g -> (codes int8 (nblocks, 256), scale f32 (nblocks, 1)); the scale
    is absmax times the f32 reciprocal of 127, as the compiled reference
    computes it."""
    flat = g.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    fp = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _BLOCK)
    absmax = fp.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        absmax * f32_reciprocal(127.0))
    codes = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
    return codes, scale


def compressed_psum(tree, axis_name):
    raise later("compressed gradient all-reduce", 5)
