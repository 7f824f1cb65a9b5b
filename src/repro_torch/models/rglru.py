"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The hybrid arch interleaves 2 recurrent blocks : 1 local-attention block.
The RG-LRU is a gated first-order linear recurrence:

    r_t = sigmoid(x_t W_rg)          (recurrence gate)
    i_t = sigmoid(x_t W_ig)          (input gate)
    a_t = exp(-c * softplus(L) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full sequence runs as a log-depth scan (Hillis-Steele doubling over
the sequence axis with the reference's combine); decode carries h
(B, d_rec). The recurrence runs in f32. The block's own weights are
never quantized (the policy exempts ``rglru``), so its five products are
plain matmuls; the output gate's GELU goes through ``ctx.naf`` (the
FASST kernel when it is on).

Under a tensor-parallel group (``ctx.tp``) the block runs on the rank's
``d_rec / tp`` channels (``parallel.sharding`` layout (f)): the conv, the
gates' products with the rank's columns of ``w_rg`` / ``w_ig``, ``a``,
``b`` and the scan are the rank's own; the conv output is gathered along
channels before the gates (a channel's gates read every channel), and
``out_proj``'s partial products are summed over the ranks (an
unlabelled site, as in the reference, so the sum is explicit here).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Ctx, draw_sources, normal_init

__all__ = ["rglru_init", "rglru_apply", "rglru_decode_step", "rglru_init_state",
           "linear_scan"]

_C = 8.0
_CONV_W = 4


def rglru_init(g, d_model: int, d_rec: int, lead: tuple = ()):
    """Parameters stacked on the ``lead`` axes with the reference's shapes
    and scales, drawn from a torch.Generator or, one layer (``lead`` ()),
    from a key as the reference's ``rglru_init`` draws it (split 6)."""
    s, sr = d_model ** -0.5, d_rec ** -0.5
    dev = g.device
    ks = draw_sources(g, 6)
    return {
        "gate_proj": normal_init(ks[0], lead + (d_model, d_rec), s),
        "in_proj": normal_init(ks[1], lead + (d_model, d_rec), s),
        "conv_w": normal_init(ks[2], lead + (_CONV_W, d_rec), 0.2),
        "conv_bias": torch.zeros(lead + (d_rec,), device=dev),
        "w_rg": normal_init(ks[3], lead + (d_rec, d_rec), sr),
        "w_ig": normal_init(ks[4], lead + (d_rec, d_rec), sr),
        "a_param": torch.full(lead + (d_rec,), -4.0, device=dev),   # a ~ 0.95 at r=0.5
        "out_proj": normal_init(ks[5], lead + (d_rec, d_model), sr),
    }


def _gates(ctx: Ctx, params, xr):
    """(a, b) of the channels of ``xr``; on a group's rank the gates read
    every rank's channels (gathered) through its columns of the gate
    weights."""
    f32 = torch.float32
    xw = xr if ctx.tp is None else ctx.tp.gather(xr, -1)
    r = torch.sigmoid(ctx.dot(xw, params["w_rg"]).to(f32))
    i = torch.sigmoid(ctx.dot(xw, params["w_ig"]).to(f32))
    a = torch.exp(-_C * F.softplus(params["a_param"].to(f32)) * r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * xr.to(f32)
    return a, b


def _conv(x, w, bias, state=None):
    """Depthwise causal conv, width 4, in f32; returns (out in ``x``'s
    dtype, the new state)."""
    B, S, C = x.shape
    if state is None:
        state = torch.zeros((B, _CONV_W - 1, C), dtype=x.dtype, device=x.device)
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)
    w = w.to(torch.float32)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(_CONV_W):
        out = out + xp[:, i:i + S].to(torch.float32) * w[i]
    return (out + bias.to(torch.float32)).to(x.dtype), xp[:, -(_CONV_W - 1):]


def _out(ctx: Ctx, params, y):
    """``out_proj``, its partial products summed over a group's ranks."""
    return ctx.dot(y, params["out_proj"], row_split=True)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1: the inclusive
    scan of the combine (al, bl), (ar, br) -> (al ar, bl ar + br), by
    doubling (ceil(log2 S) elementwise steps)."""
    S = a.shape[1]
    step = 1
    while step < S:
        a_new = a.clone()
        b_new = b.clone()
        a_new[:, step:] = a[:, :-step] * a[:, step:]
        b_new[:, step:] = b[:, :-step] * a[:, step:] + b[:, step:]
        a, b = a_new, b_new
        step *= 2
    return b


def rglru_apply(ctx: Ctx, params, x, state=None, return_state: bool = False):
    """Full-sequence recurrent block, x (B, S, d) -> (B, S, d) [, (conv
    state, h at the last step)]."""
    gate = ctx.naf(ctx.dot(x, params["gate_proj"]), "gelu")
    xr = ctx.dot(x, params["in_proj"])
    conv_state, h0 = state if state is not None else (None, None)
    xr, new_conv = _conv(xr, params["conv_w"], params["conv_bias"], conv_state)
    a, b = _gates(ctx, params, xr)                       # (B, S, d_rec) f32
    if h0 is not None:      # the initial state folds into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    out = _out(ctx, params, h.to(ctx.compute_dtype) * gate)
    if return_state:
        return out, (new_conv, h[:, -1])
    return out


def rglru_init_state(batch: int, d_rec: int, device="cuda"):
    return (torch.zeros((batch, _CONV_W - 1, d_rec), dtype=torch.bfloat16, device=device),
            torch.zeros((batch, d_rec), dtype=torch.float32, device=device))


def rglru_decode_step(ctx: Ctx, params, x, state):
    """One-token step, x (B, 1, d); state (conv (B, 3, d_rec), h (B, d_rec)).
    The new conv state comes back in the projection's dtype."""
    conv_state, h = state
    f32 = torch.float32
    gate = ctx.naf(ctx.dot(x, params["gate_proj"]), "gelu")          # (B, 1, d_rec)
    xr = ctx.dot(x, params["in_proj"])
    xp = torch.cat([conv_state.to(xr.dtype), xr], dim=1)             # (B, 4, d_rec)
    conv = (xp.to(f32) * params["conv_w"].to(f32)).sum(dim=1)
    xr1 = (conv + params["conv_bias"].to(f32))[:, None, :]
    a, b = _gates(ctx, params, xr1.to(ctx.compute_dtype))
    h_new = a[:, 0] * h + b[:, 0]
    y = h_new[:, None, :].to(ctx.compute_dtype) * gate
    return _out(ctx, params, y), (xp[:, 1:], h_new)
