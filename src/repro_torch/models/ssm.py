"""Mamba-2 SSD layer (state-space duality, arXiv:2405.21060).

Prefill runs the chunked SSD dual form: quadratic attention-like math
inside chunks of length Q, a linear recurrence across the chunk states
(a loop over the S / Q chunks). Decode carries an O(1) recurrent state
(B, nh, hp, ds) and a 3-row conv state.

The projections (``in_proj`` / ``out_proj``) take the policy's weight
format (qmm on the card for 4-bit weights); the recurrence runs in f32,
as in the reference. The SiLUs are plain PyTorch (the reference calls
``jax.nn.silu``, not the FASST activation).

Under a tensor-parallel group (``ctx.tp``) the layer runs on the rank's
SSD heads (``parallel.sharding`` layout (e)): the packed projection holds
its heads' z, x and dt columns and all of B and C, the conv and the
recurrence run locally, the gated RMSNorm sums each row's sum of squares
over the ranks before it divides by the whole ``d_inner``, and
``out_proj``'s partial products are summed over the ranks. The sites are
unlabelled, as in the reference, so the sums are explicit here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Ctx, draw_sources, normal_init, rms_norm

__all__ = ["ssm_init", "ssm_apply", "ssm_decode_step", "ssm_init_state",
           "ssm_naive_ref"]

_CONV_W = 4


def _tp(ctx: Ctx) -> int:
    return ctx.tp.size if ctx.tp is not None else 1


def ssd_ranks(cfg) -> int:
    """The ranks an SSM's SSD heads split over: a rank-local config's
    (``configs.RankConfig``) ``tp``, 1 where the rank holds them whole."""
    return 1 if "ssd" in getattr(cfg, "replicated", ()) else getattr(cfg, "tp", 1)


def _dims(d_model, ssm_cfg, tp: int = 1):
    """(d_inner, SSD heads, state dim, conv channels, in_proj width), the
    rank-local ones on a group of ``tp`` ranks (layout (e))."""
    d_inner = ssm_cfg.expand * d_model // tp
    nh = d_inner // ssm_cfg.head_dim
    ds = ssm_cfg.state_dim
    conv_dim = d_inner + 2 * ds          # x + B + C (n_groups = 1)
    d_in_proj = 2 * d_inner + 2 * ds + nh
    return d_inner, nh, ds, conv_dim, d_in_proj


def _linspace(start: float, stop: float, num: int, device):
    """``jnp.linspace(start, stop, num)`` in f32 (num >= 2) as the
    reference's compiled linspace computes it, bit for bit: start *
    (1 - i / (num - 1)), the division a product with the f32 reciprocal,
    plus i times stop / (num - 1) in one fused multiply-add; then stop."""
    f32, f64 = torch.float32, torch.float64
    i = torch.arange(num - 1, dtype=f32, device=device)
    r = torch.tensor(1.0, dtype=f32) / (num - 1)
    head = (start * (1.0 - i * r)).to(f64) + i.to(f64) * float(stop * r)
    return torch.cat([head.to(f32), torch.full((1,), stop, dtype=f32, device=device)])


def _a_log(nh: int, device):
    """log(linspace(1, 16, nh)) in f32, the log rounded once from f64 so
    the CPU and the card agree (XLA's CPU log is not correctly rounded: it
    may lie one ulp away)."""
    return torch.log(_linspace(1.0, 16.0, nh, device).to(torch.float64)).to(torch.float32)


def ssm_init(g, d_model: int, ssm_cfg, layers=None):
    """Parameters with the reference's shapes and scales, stacked on a
    leading ``layers`` axis (unstacked for None), drawn from a
    torch.Generator or, one layer, from a key as the reference's
    ``ssm_init`` draws it (split 4)."""
    d_inner, nh, ds, conv_dim, d_in_proj = _dims(d_model, ssm_cfg)
    lead, dev = (() if layers is None else (layers,)), g.device
    ks = draw_sources(g, 4)

    def full(value, n):
        return torch.full(lead + (n,), value, dtype=torch.float32, device=dev)

    return {
        "in_proj": normal_init(ks[0], lead + (d_model, d_in_proj), d_model ** -0.5),
        "out_proj": normal_init(ks[1], lead + (d_inner, d_model), d_inner ** -0.5),
        "conv_w": normal_init(ks[2], lead + (_CONV_W, conv_dim), 0.2),
        "conv_bias": full(0.0, conv_dim),
        "a_log": _a_log(nh, dev).expand(lead + (nh,)).clone(),
        "dt_bias": full(0.0, nh),
        "D": full(1.0, nh),
        "norm_scale": full(1.0, d_inner),
    }


def _split_proj(ctx: Ctx, params, x, d_model, ssm_cfg):
    d_inner, _, _, conv_dim, _ = _dims(d_model, ssm_cfg, _tp(ctx))
    zxbcdt = ctx.dot(x, params["in_proj"])
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:d_inner + conv_dim],
            zxbcdt[..., d_inner + conv_dim:])


def _causal_conv(xbc, conv_w, conv_bias, init_state=None):
    """Depthwise causal conv, width 4. xbc (B, S, Cd); state (B, 3, Cd).

    The state joins ``xbc`` under the reference's type promotion (a bf16
    state and f32 rows give f32), so the new state comes back in that
    dtype; the output is in ``xbc``'s."""
    B, S, Cd = xbc.shape
    if init_state is None:
        init_state = torch.zeros((B, _CONV_W - 1, Cd), dtype=xbc.dtype, device=xbc.device)
    dt = torch.promote_types(init_state.dtype, xbc.dtype)
    xp = torch.cat([init_state.to(dt), xbc.to(dt)], dim=1)
    w = conv_w.to(torch.float32)
    out = torch.zeros((B, S, Cd), dtype=torch.float32, device=xbc.device)
    for i in range(_CONV_W):
        out = out + xp[:, i:i + S].to(torch.float32) * w[i]
    out = F.silu(out + conv_bias.to(torch.float32))
    return out.to(xbc.dtype), xp[:, -(_CONV_W - 1):]


def _ssd_chunked(xh, Bm, Cm, dt, A, chunk: int):
    """Chunked SSD. xh (B, S, nh, hp); Bm / Cm (B, S, ds); dt (B, S, nh);
    A (nh,) < 0. Returns y (B, S, nh, hp) and the final state
    (B, nh, hp, ds), f32 throughout."""
    Bsz, S, nh, hp = xh.shape
    ds = Bm.shape[-1]
    Q = min(chunk, S)
    while S % Q:          # the largest chunk <= the requested one dividing S
        Q -= 1
    nc = S // Q
    f32 = torch.float32
    xh = xh.to(f32).reshape(Bsz, nc, Q, nh, hp)
    Bm = Bm.to(f32).reshape(Bsz, nc, Q, ds)
    Cm = Cm.to(f32).reshape(Bsz, nc, Q, ds)
    dt = dt.to(f32).reshape(Bsz, nc, Q, nh)

    a = dt * A                                        # (B, nc, Q, nh) log-decay
    cum = torch.cumsum(a, dim=2)
    tot = cum[:, :, -1:, :]                           # (B, nc, 1, nh)

    # intra-chunk (the dual quadratic form); the mask goes on the
    # exponent: exp(li) * mask would be inf * 0 = NaN
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B, nc, Q, Q, nh)
    iota = torch.arange(Q, device=xh.device)
    causal = (iota[:, None] >= iota[None, :])[None, None, :, :, None]
    L = torch.exp(torch.where(causal, li, -1e30))
    cb = torch.matmul(Cm, Bm.transpose(-1, -2))                 # (B, nc, Q, Q)
    xdt = xh * dt[..., None]                                    # (B, nc, Q, nh, hp)
    # bcqk,bcqkh,bckhp->bcqhp: the elementwise product, then one batched
    # contraction over k
    w = (cb[..., None] * L).permute(0, 1, 4, 2, 3)              # (B, nc, nh, Q, K)
    y_intra = torch.matmul(w, xdt.permute(0, 1, 3, 2, 4))       # (B, nc, nh, Q, hp)
    y_intra = y_intra.permute(0, 1, 3, 2, 4)

    # chunk states: S_c = sum_j exp(tot - cum_j) dt_j B_j (x) x_j
    wx = ((torch.exp(tot - cum) * dt)[..., None] * xh)          # (B, nc, Q, nh, hp)
    sc = torch.matmul(wx.reshape(Bsz, nc, Q, nh * hp).transpose(-1, -2), Bm)
    sc = sc.reshape(Bsz, nc, nh, hp, ds)

    # the inter-chunk recurrence over nc, emitting the state before each
    # chunk
    chunk_decay = torch.exp(tot[:, :, 0, :])                    # (B, nc, nh)
    h = torch.zeros((Bsz, nh, hp, ds), dtype=f32, device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + sc[:, c]
    h_prev = torch.stack(h_prev, dim=1)                         # (B, nc, nh, hp, ds)

    # inter-chunk contribution: C_i . h_prev * exp(cum_i)
    y_inter = torch.matmul(Cm, h_prev.reshape(Bsz, nc, nh * hp, ds).transpose(-1, -2))
    y_inter = y_inter.reshape(Bsz, nc, Q, nh, hp)
    y_inter = y_inter * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(Bsz, S, nh, hp), h


def _split_rms_norm(tp, x, scale, width: int, eps=1e-6):
    """``rms_norm`` of rows whose ``width`` columns are split over the
    ranks of ``tp``: each row's f32 sum of squares summed over the ranks,
    over the whole width."""
    xf = x.to(torch.float32)
    var = tp.all_reduce(torch.sum(xf * xf, dim=-1, keepdim=True)) / width
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def _gate_out(ctx: Ctx, params, y, z, d_inner: int):
    """y (f32) -> compute dtype, times SiLU(z), RMS-normed over the whole
    ``d_inner``, ``out_proj`` (summed over a group's ranks)."""
    y = y.to(ctx.compute_dtype) * F.silu(z.to(torch.float32)).to(ctx.compute_dtype)
    if ctx.tp is None:
        return ctx.dot(rms_norm(y, params["norm_scale"]), params["out_proj"])
    y = _split_rms_norm(ctx.tp, y, params["norm_scale"], d_inner)
    return ctx.dot(y, params["out_proj"], row_split=True)


def ssm_apply(ctx: Ctx, params, x, *, d_model: int, ssm_cfg, conv_state=None,
              return_state: bool = False):
    """Full-sequence SSD block from the zero SSD state (as the reference's
    prefill runs it), x (B, S, d) -> y (B, S, d) [, (conv state, SSD
    state)]."""
    d_inner, nh, ds, _, _ = _dims(d_model, ssm_cfg, _tp(ctx))
    B, S, _ = x.shape
    z, xbc, dt = _split_proj(ctx, params, x, d_model, ssm_cfg)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_bias"], conv_state)
    xs = xbc[..., :d_inner].reshape(B, S, nh, ssm_cfg.head_dim)
    Bm = xbc[..., d_inner:d_inner + ds]
    Cm = xbc[..., d_inner + ds:]
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"].to(torch.float32))
    A = -torch.exp(params["a_log"].to(torch.float32))
    y, h_last = _ssd_chunked(xs, Bm, Cm, dt, A, ssm_cfg.chunk)
    y = y + xs.to(torch.float32) * params["D"].to(torch.float32)[:, None]
    out = _gate_out(ctx, params, y.reshape(B, S, d_inner), z, ssm_cfg.expand * d_model)
    if return_state:
        return out, (new_conv, h_last)
    return out


def ssm_init_state(batch: int, d_model: int, ssm_cfg, device="cuda", tp: int = 1):
    """Zero (conv (B, 3, conv_dim) bf16, SSD (B, nh, hp, ds) f32) states, a
    rank's widths on a group of ``tp`` (layout (e): its heads' x channels
    and all of B and C; its heads)."""
    _, nh, ds, conv_dim, _ = _dims(d_model, ssm_cfg, tp)
    return (torch.zeros((batch, _CONV_W - 1, conv_dim), dtype=torch.bfloat16, device=device),
            torch.zeros((batch, nh, ssm_cfg.head_dim, ds), dtype=torch.float32,
                        device=device))


def ssm_decode_step(ctx: Ctx, params, x, state, *, d_model: int, ssm_cfg):
    """One-token recurrent update, x (B, 1, d); state (conv, h). The new
    conv state comes back in the projection's dtype (the caller stores it
    into its cache leaf); h in f32."""
    d_inner, nh, ds, _, _ = _dims(d_model, ssm_cfg, _tp(ctx))
    B = x.shape[0]
    conv_state, h = state
    z, xbc, dt = _split_proj(ctx, params, x, d_model, ssm_cfg)
    f32 = torch.float32
    xp = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)          # (B, 4, Cd)
    conv = (xp.to(f32) * params["conv_w"].to(f32)).sum(dim=1)
    xbc1 = F.silu(conv + params["conv_bias"].to(f32))                # (B, Cd)
    xs = xbc1[:, :d_inner].reshape(B, nh, ssm_cfg.head_dim)
    Bm = xbc1[:, d_inner:d_inner + ds]
    Cm = xbc1[:, d_inner + ds:]
    dtv = F.softplus(dt[:, 0].to(f32) + params["dt_bias"].to(f32))   # (B, nh)
    A = -torch.exp(params["a_log"].to(f32))
    decay = torch.exp(dtv * A)
    h = h * decay[:, :, None, None] + (dtv[:, :, None] * xs)[..., None] * Bm[:, None, None, :]
    y = torch.matmul(h, Cm[:, None, :, None])[..., 0]                # (B, nh, hp)
    y = y + xs * params["D"].to(f32)[:, None]
    return (_gate_out(ctx, params, y.reshape(B, 1, d_inner), z, ssm_cfg.expand * d_model),
            (xp[:, 1:], h))


def ssm_naive_ref(ctx: Ctx, params, x, *, d_model: int, ssm_cfg):
    """The step-by-step recurrence (the oracle the chunked form is tested
    against)."""
    state = ssm_init_state(x.shape[0], d_model, ssm_cfg, x.device, _tp(ctx))
    outs = []
    for t in range(x.shape[1]):
        y, state = ssm_decode_step(ctx, params, x[:, t:t + 1], state, d_model=d_model,
                                   ssm_cfg=ssm_cfg)
        outs.append(y)
    return torch.cat(outs, dim=1)
