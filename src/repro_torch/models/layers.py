"""Shared neural layers (functional, quantization-aware).

Every matmul routes through core.qlinear.qmatmul, so any layer deploys at
any weight format. Activations come from the FASST NAF datapath
(kernels.fasst._naf), shared by the kernel's plain version and the model;
with the FASST kernel on, the FFN's activation rides in the qmm kernel's
epilogue wherever its input product goes to that kernel at decode rows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..core.qlinear import (act_quant_eligible, qmatmul, qmm_route,
                            quantize_activations, static_scale, token_absmax, token_scale)
from ..kernels.fasst import _naf
from ..kernels.qmm import DECODE_MAX_M
from ..random import normal, split

__all__ = ["Ctx", "rank_ctx", "seq_rows", "seq_block", "rms_norm", "rope", "linear", "mlp",
           "fuses_naf", "attn_apply", "decode_attn_apply", "GLU_ACTS", "PLAIN_ACTS",
           "normal_init", "draw_sources",
           "stack_layers", "remat", "attention_init", "mlp_init"]

_MATMUL_IMPLS = ("torch", "kernel")
_PAGED_ATTN_IMPLS = ("gather", "kernel")


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call execution context threaded through model code.

    act_fmt:         matmul activation format (bf16 | int8 | fp8).
    attn_act_fmt:    QK / PV activation format, the spec's x<fmt> slot: a
                     quantized format fake-quantizes both operands of the
                     attention einsums (attn_dot). The paged-attention
                     kernel computes QK / PV unquantized whatever this says,
                     as the reference's kernel does: the slot reaches the
                     gather and dense routes only.
    matmul_impl:     "torch" dequantizes next to a torch matmul; "kernel"
                     routes 4-bit weights through the qmm kernel.
    paged_attn_impl: "gather" materializes each chain densely; "kernel"
                     runs the paged-attention kernel (write-then-attend).
    use_fasst_kernel: route the FFN activation through the FASST datapath on
                     the card: in the qmm kernel's epilogue where the
                     product takes the qmm kernel at decode rows (and its
                     weight has no adapters), else the FASST kernel.
    act_scales:      calibrated static activation scales, a sorted tuple of
                     (site, scale) from core.calibration; a site absent
                     from it (or None) quantizes dynamically per token.
    act_collector:   a core.calibration.SiteCollector: when set, every
                     activation entering a quantized-weight matmul (and
                     each x<fmt> attention operand) reports its absmax
                     under its site label. Not part of eq / hash.
    tp:              a tensor-parallel engine's ``parallel.tp.TPGroup``:
                     every row-parallel product (a site ending in ".out",
                     or ``row_split``) is summed over its ranks, and a
                     vocabulary-split embedding and head gather over them.
                     An act-quantizing spec's dynamic scale at such a
                     product is the whole row's: the ranks' absmax
                     reduced by max. Static scales, column-parallel sites
                     and the x<fmt> attention operands (quantized along
                     head_dim or one head's keys, whole on the rank; but
                     see ``decode_attn_apply``'s sequence split) need no
                     collective. A sublayer the rank holds whole runs
                     under ``solo`` (``rank_ctx``). None on one device.
                     Not part of eq / hash.
    """
    compute_dtype: Any = torch.bfloat16
    act_fmt: str = "bf16"
    attn_act_fmt: str = "bf16"
    matmul_impl: str = "torch"
    paged_attn_impl: str = "gather"
    use_fasst_kernel: bool = False
    act_scales: Any = None
    act_collector: Any = dataclasses.field(default=None, compare=False, repr=False)
    tp: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.matmul_impl not in _MATMUL_IMPLS:
            raise ValueError(f"matmul_impl must be one of {_MATMUL_IMPLS}, "
                             f"got {self.matmul_impl!r}")
        if self.paged_attn_impl not in _PAGED_ATTN_IMPLS:
            raise ValueError(f"paged_attn_impl must be one of "
                             f"{_PAGED_ATTN_IMPLS}, got {self.paged_attn_impl!r}")

    @functools.cached_property
    def _site_scales(self):
        return dict(self.act_scales) if self.act_scales is not None else {}

    @functools.cached_property
    def _device_scales(self):
        return {}

    @functools.cached_property
    def solo(self) -> "Ctx":
        """This ctx without the group: one device's code, no collective
        (made once, so its static scales upload once)."""
        return dataclasses.replace(self, tp=None)

    def scale_for(self, site, device):
        """Calibrated static activation scale of a matmul site, as a
        StaticScale on ``device`` (made once, so a step uploads nothing);
        None = dynamic per-token quantization."""
        scale = self._site_scales.get(site) if site is not None else None
        if scale is None:
            return None
        key = (site, device)
        if key not in self._device_scales:
            self._device_scales[key] = static_scale(scale, device)
        return self._device_scales[key]

    def dot(self, x, w, site=None, naf=None, row_split=False):
        """x @ w with the context's activation route. ``site`` is the
        matmul's calibration label (e.g. "dec.ffn.in"): the collector
        files absmax observations under it, and the static-scale registry
        is keyed by it; unlabelled sites stay dynamic. Under ``tp`` a
        row-parallel product (a ".out" site, or ``row_split`` for an
        unlabelled one) holds the rank's K slice of ``x``: a dynamic
        activation scale is taken from the ranks' absmax, and the partial
        products are summed over the ranks (w8a8's int32 products before
        their rescale, exactly)."""
        if self.act_collector is not None and act_quant_eligible(w):
            self.act_collector.observe(site, x)
        scale = self.scale_for(site, x.device)
        split = self.tp is not None and (row_split or (site or "").endswith(".out"))
        if (split and scale is None and self.act_fmt in ("int8", "fp8")
                and act_quant_eligible(w)):
            scale = token_scale(self.tp.all_max(token_absmax(x)), self.act_fmt)
        return qmatmul(x, w, act=self.act_fmt, compute_dtype=self.compute_dtype,
                       impl=self.matmul_impl, naf=naf, act_scale=scale,
                       reduce=self.tp.all_reduce if split else None)

    def _attn_fq(self, x, site, group=None):
        """Fake-quantize one f32 attention operand at the attention format:
        observe its absmax when calibrating, quantize at the site's static
        scale (or per token), widen back to f32. ``group``: the rows'
        last axis is split over its ranks, so a dynamic scale is the whole
        row's, the ranks' absmax reduced by max."""
        if self.act_collector is not None:
            self.act_collector.observe(site, x)
        scale = self.scale_for(site, x.device)
        if scale is None and group is not None:
            scale = token_scale(group.all_max(token_absmax(x)), self.attn_act_fmt)
        codes, scale = quantize_activations(x, fmt=self.attn_act_fmt, scale=scale)
        return codes.to(torch.float32) * scale

    def attn_dot(self, subscripts, a, b, site=None, a_group=None):
        """QK / PV attention einsum with f32 accumulation. A quantized
        attention format fake-quantizes BOTH operands (sites "{site}.a" /
        "{site}.b") and contracts in f32; ``a_group``: ``a``'s last axis
        is split over that group's ranks (``_attn_fq``)."""
        if self.attn_act_fmt == "bf16":
            return torch.einsum(subscripts, a.to(torch.float32), b.to(torch.float32))
        af = self._attn_fq(a.to(torch.float32), f"{site}.a", a_group)
        bf = self._attn_fq(b.to(torch.float32), f"{site}.b")
        return torch.einsum(subscripts, af, bf)

    def naf(self, x, mode):
        if self.use_fasst_kernel:
            from ..kernels import ops as kops
            return kops.fasst(x, mode)
        return _naf(x.to(torch.float32), mode).to(x.dtype)


def rank_ctx(ctx: Ctx, cfg, kind: str) -> Ctx:
    """The ctx a sublayer of ``kind`` ("attn", "ffn", "rec", "ssd") runs
    under: ``ctx`` where it splits over ``ctx.tp``, ``ctx.solo`` where
    the rank holds it whole (``cfg.replicated``, a rank's
    ``configs.RankConfig``), so a replicated sublayer takes no
    collective."""
    if ctx.tp is None or kind not in getattr(cfg, "replicated", ()):
        return ctx
    return ctx.solo


def seq_rows(cfg, S: int) -> int:
    """The rows of an ``S``-row dense self-attention cache a rank holds:
    ``S / tp`` where the rank's attention is replicated and tp divides S
    (the sequence split: rank r holds rows ``[r S/tp, (r+1) S/tp)``), else
    all S."""
    tp = getattr(cfg, "tp", 1)
    if "attn" in getattr(cfg, "replicated", ()) and S % tp == 0:
        return S // tp
    return S


def seq_block(group, rows: int, whole: int) -> int:
    """The first row of ``group``'s rank's block of a dense cache of
    ``whole`` positions whose leaves hold ``rows`` (``seq_rows``): 0
    where the cache is whole. Every writer of a split cache and its
    attention read take their rows from here."""
    return 0 if rows == whole else group.rank * rows


def rms_norm(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    return torch.exp(-torch.arange(0, half, dtype=torch.float32)
                     * (log_theta / half)).to(device)


def rope(x, positions, theta: float = 1e4):
    """x (..., S, H, hd), positions (..., S) -> rotated x (pairs convention)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, theta, x.device)
    ang = positions.to(torch.float32)[..., None] * freqs     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def linear(ctx: Ctx, x, w, b=None, site=None):
    y = ctx.dot(x, w, site=site)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


GLU_ACTS = {"silu_glu": "silu", "gelu_glu": "gelu", "relu_glu": "relu"}
PLAIN_ACTS = {"squared_relu": "squared_relu", "gelu": "gelu", "relu": "relu",
              "silu": "silu"}


def normal_init(g, shape, scale):
    """A float32 normal draw times ``scale``: from the torch.Generator
    ``g`` on its device, or, for a key from ``random.prng_key`` /
    ``random.split``, ``jax.random.normal(key, shape) * scale``."""
    if isinstance(g, torch.Tensor):
        return normal(g, shape) * scale
    return torch.randn(shape, generator=g, device=g.device, dtype=torch.float32) * scale


def draw_sources(g, n: int):
    """What an init draws its ``n`` weights from: the reference's
    ``jax.random.split(key, n)`` for a key, the generator ``n`` times over
    (its draws in call order) for a torch.Generator."""
    return split(g, n) if isinstance(g, torch.Tensor) else [g] * n


def stack_layers(layers: list):
    """Per-layer parameter trees stacked on a leading ``L`` axis: the
    counterpart of the reference's ``jax.vmap`` of a layer init over the
    split layer keys (the draws of each key are the same)."""
    if isinstance(layers[0], dict):
        return {k: stack_layers([lp[k] for lp in layers]) for k in layers[0]}
    return torch.stack(layers)


def remat(body, on: bool):
    """``body`` recomputed in the backward pass when ``on`` (the
    counterpart of the reference's ``jax.checkpoint(body)``)."""
    if not on:
        return body
    return lambda *a: checkpoint(body, *a, use_reentrant=False)


def attention_init(g, L, cfg, extras: bool = True):
    """Attention weights with the reference's shapes and scales, stacked
    on a leading ``L`` axis (unstacked for ``L`` None), drawn from a
    torch.Generator or, one layer (``L`` None), from a key as the
    reference's ``attention_init`` draws it. ``extras``: the config's
    zero QKV biases (``qkv_bias``) and unit q / k norm scales
    (``qk_norm``); the reference's enc-dec and hybrid attention take
    neither."""
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = () if L is None else (L,)
    ks = draw_sources(g, 4)
    s = d ** -0.5
    p = {"wq": normal_init(ks[0], lead + (d, H * hd), s),
         "wk": normal_init(ks[1], lead + (d, Hkv * hd), s),
         "wv": normal_init(ks[2], lead + (d, Hkv * hd), s),
         "wo": normal_init(ks[3], lead + (H * hd, d), (H * hd) ** -0.5)}
    if extras and cfg.qkv_bias:
        for name, width in (("q", H * hd), ("k", Hkv * hd), ("v", Hkv * hd)):
            p[f"bias_{name}"] = torch.zeros(lead + (width,), device=g.device)
    if extras and cfg.qk_norm:
        p["q_norm_scale"] = torch.ones(lead + (hd,), device=g.device)
        p["k_norm_scale"] = torch.ones(lead + (hd,), device=g.device)
    return p


def mlp_init(g, L, cfg):
    """FFN weights (w_gate / w_up / w_down for a GLU activation, w_in /
    w_out otherwise), stacked on ``L`` as ``attention_init``'s; a key
    splits in 3 as in the reference."""
    d, ff = cfg.d_model, cfg.d_ff
    lead = () if L is None else (L,)
    ks = draw_sources(g, 3)
    if cfg.mlp_act in GLU_ACTS:
        return {"w_gate": normal_init(ks[0], lead + (d, ff), d ** -0.5),
                "w_up": normal_init(ks[1], lead + (d, ff), d ** -0.5),
                "w_down": normal_init(ks[2], lead + (ff, d), ff ** -0.5)}
    return {"w_in": normal_init(ks[0], lead + (d, ff), d ** -0.5),
            "w_out": normal_init(ks[1], lead + (ff, d), ff ** -0.5)}


def fuses_naf(ctx: Ctx, w, x) -> bool:
    """Whether the FFN activation rides in qmm's epilogue for ``x @ w``:
    the FASST kernel is on, the product takes the qmm kernel at decode
    rows, and ``w`` has no adapters (the adapter term is added after the
    product, so a fused NAF would compute naf(x @ W) + lora, not
    naf(x @ W + lora))."""
    return (ctx.use_fasst_kernel and qmm_route(w, ctx.matmul_impl)
            and w.lora_a is None and x.numel() // x.shape[-1] <= DECODE_MAX_M)


def mlp(ctx: Ctx, params, x, act: str, site="ffn"):
    """Two-layer FFN, or a gated (GLU) FFN: naf(x @ w_gate) * (x @ w_up)
    then w_down. A GLU gate's activation goes through ``ctx.naf`` (the
    FASST kernel when it is on); a plain FFN's rides in qmm's epilogue
    where ``fuses_naf`` says so."""
    if act in GLU_ACTS:
        h = ctx.naf(ctx.dot(x, params["w_gate"], site=f"{site}.in"), GLU_ACTS[act])
        h = h * ctx.dot(x, params["w_up"], site=f"{site}.in")
        return ctx.dot(h, params["w_down"], site=f"{site}.out")
    if act not in PLAIN_ACTS:
        raise ValueError(f"unknown FFN activation {act!r}")
    mode, w_in = PLAIN_ACTS[act], params["w_in"]
    # the NAF rides in qmm's epilogue at decode rows, where it saves the
    # FASST launch; at prefill rows qmm then the FASST kernel is faster
    # than the fused launch (PERF.md)
    if fuses_naf(ctx, w_in, x):
        h = ctx.dot(x, w_in, site=f"{site}.in", naf=mode)
    else:
        h = ctx.naf(ctx.dot(x, w_in, site=f"{site}.in"), mode)
    return ctx.dot(h, params["w_out"], site=f"{site}.out")


def _mask(pos_q, pos_k, causal: bool, window: int = 0):
    """Attention mask (..., Sq, Sk). pos_k < 0 marks invalid cache slots;
    ``window`` > 0 keeps keys less than ``window`` positions from the
    query either way (gemma3's local layers), 0 the full span."""
    pq = pos_q[..., :, None]
    pk = pos_k[..., None, :]
    m = pk >= 0
    if causal:
        m = m & (pk <= pq)
    if window:
        m = m & ((pq - pk) < window) & ((pk - pq) < window)
    return m


def _qk_norm(params, q, k, norm_eps):
    """The per-head q / k RMS norm of a ``qk_norm`` layer (k None: a
    cross-attention's precomputed keys stay as they are)."""
    if "q_norm_scale" not in params:
        return q, k
    q = rms_norm(q, params["q_norm_scale"], norm_eps)
    if k is not None:
        k = rms_norm(k, params["k_norm_scale"], norm_eps)
    return q, k


def _sdpa(ctx: Ctx, q, k, v, mask, sm_scale, site="attn"):
    """q (B,Sq,Hkv,G,hd), k/v (B,Sk,Hkv,hd), mask (B,Sq,Sk) -> (B,Sq,Hkv,G,hd);
    QK at site "{site}.qk", PV at "{site}.pv"."""
    scores = ctx.attn_dot("bqhgd,bkhd->bhgqk", q, k.to(q.dtype),
                          site=f"{site}.qk") * sm_scale
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return ctx.attn_dot("bhgqk,bkhd->bqhgd", p, v, site=f"{site}.pv").to(v.dtype)


def attn_apply(ctx: Ctx, params, x, positions, *, num_heads, num_kv_heads,
               head_dim, causal=True, window=0, rope_theta=1e4, kv_override=None,
               use_rope=True, norm_eps=1e-6, site="attn"):
    """Self- (or cross-, via kv_override) attention block body."""
    B, S, _ = x.shape
    H, Hkv = num_heads, num_kv_heads
    qkv = f"{site}.qkv"
    q = linear(ctx, x, params["wq"], params.get("bias_q"), site=qkv).reshape(
        B, S, H, head_dim)
    if kv_override is None:
        k = linear(ctx, x, params["wk"], params.get("bias_k"), site=qkv).reshape(
            B, S, Hkv, head_dim)
        v = linear(ctx, x, params["wv"], params.get("bias_v"), site=qkv).reshape(
            B, S, Hkv, head_dim)
        pos_k = positions
        q, k = _qk_norm(params, q, k, norm_eps)
    else:
        k, v, pos_k = kv_override          # precomputed (cross-attn / cache)
        q, _ = _qk_norm(params, q, None, norm_eps)
    if use_rope:
        q = rope(q, positions, rope_theta)
        if kv_override is None:
            k = rope(k, pos_k, rope_theta)
    qg = q.reshape(B, S, Hkv, H // Hkv, head_dim)
    mask = _mask(positions, pos_k, causal, window)
    if mask.ndim == 2:
        mask = mask[None]
    mask = mask.expand((B,) + tuple(mask.shape[-2:]))
    out = _sdpa(ctx, qg, k, v, mask, head_dim ** -0.5,
                site=site).reshape(B, S, H, head_dim)
    y = ctx.dot(out.reshape(B, S, H * head_dim), params["wo"], site=f"{site}.out")
    return y, (k, v)


def decode_attn_apply(ctx: Ctx, params, x, positions, cache_k, cache_v,
                      cache_positions, *, num_heads, num_kv_heads, head_dim,
                      window=0, rope_theta=1e4, norm_eps=1e-6, site="attn", group=None):
    """One-token decode against a dense (dequantized) KV view.

    x (B, 1, d); cache_k/v (B, Smax, Hkv, hd); cache_positions (B, Smax)
    with -1 = empty. The fresh token joins through a two-part softmax
    combine. Both QK products share the "{site}.qk" site and the cache's
    PV product is "{site}.pv"; the fresh token's PV term is an
    elementwise f32 product, not a matmul, so it stays unquantized.

    The sequence split: where cache_k / cache_v hold this rank's block of
    rows (fewer than ``cache_positions``' Smax, ``seq_rows``), the rank
    of ``group`` attends its block and the ranks' partials combine: the
    max over the ranks' cache maxima and the fresh score first, then one
    sum of each rank's packed (denominator, PV), the fresh token's term
    added once after it. An x<fmt> slot's dynamic PV scale is the whole
    row's (``a_group``). A block with no valid position gives exact
    zeros (its masked scores sit at -1e30 under a finite max).
    Returns (y, new_k_token, new_v_token).
    """
    B = x.shape[0]
    H, Hkv = num_heads, num_kv_heads
    qkv = f"{site}.qkv"
    q = linear(ctx, x, params["wq"], params.get("bias_q"), site=qkv).reshape(
        B, 1, H, head_dim)
    k_new = linear(ctx, x, params["wk"], params.get("bias_k"), site=qkv).reshape(
        B, 1, Hkv, head_dim)
    v_new = linear(ctx, x, params["wv"], params.get("bias_v"), site=qkv).reshape(
        B, 1, Hkv, head_dim)
    q, k_new = _qk_norm(params, q, k_new, norm_eps)
    q = rope(q, positions, rope_theta)
    k_new = rope(k_new, positions, rope_theta)

    rows = cache_k.shape[1]
    split = rows != cache_positions.shape[1]
    if split:
        lo = seq_block(group, rows, cache_positions.shape[1])
        cache_positions = cache_positions[:, lo:lo + rows]
    qg = q.reshape(B, 1, Hkv, H // Hkv, head_dim)
    sm_scale = head_dim ** -0.5
    cd = qg.dtype
    s_cache = ctx.attn_dot("bqhgd,bkhd->bhgqk", qg, cache_k.to(cd),
                           site=f"{site}.qk") * sm_scale
    mask = _mask(positions, cache_positions, True, window)     # (B,1,S)
    s_cache = torch.where(mask[:, None, None, :, :], s_cache, -1e30)
    s_new = ctx.attn_dot("bqhgd,bqhd->bhgq", qg, k_new.to(cd),
                         site=f"{site}.qk")[..., None] * sm_scale
    m_cache = s_cache.amax(dim=-1, keepdim=True)
    if split:
        m_cache = group.all_max(m_cache)
    m = torch.maximum(m_cache, s_new)
    e_cache = torch.exp(s_cache - m)                        # (B,Hkv,G,1,S)
    e_new = torch.exp(s_new - m)                            # (B,Hkv,G,1,1)
    denom = e_cache.sum(dim=-1, keepdim=True)
    out = ctx.attn_dot("bhgqk,bkhd->bqhgd", e_cache.to(cd), cache_v.to(cd),
                       site=f"{site}.pv", a_group=group if split else None)
    if split:
        # one sum of the packed partials: PV (B, 1, Hkv, G, hd) and the
        # denominators (B, Hkv, G, 1, 1) side by side on the last axis
        packed = group.all_reduce(torch.cat([out, denom.permute(0, 3, 1, 2, 4)], dim=-1))
        out, denom = packed[..., :-1], packed[..., -1:].permute(0, 2, 3, 1, 4)
    denom = denom + e_new
    out = out + e_new.permute(0, 3, 1, 2, 4) * v_new[:, :, :, None, :].to(torch.float32)
    out = out / denom.permute(0, 3, 1, 2, 4)
    y = ctx.dot(out.to(cd).reshape(B, 1, H * head_dim), params["wo"],
                site=f"{site}.out")
    return y, k_new, v_new
