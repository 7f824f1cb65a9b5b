"""Quantized linear algebra front-end.

Every matmul of the model routes through :func:`qmatmul`, which
dispatches on the weight's storage and the activation format, in the
reference's order:

  * plain tensor           -> matmul in the compute dtype;
  * QTensor int8 + act int8 -> integer matmul (int8 x int8 -> int32,
                              ``torch._int_mm``) with the per-token x
                              per-channel rescale: the w8a8 route;
  * act int8 / fp8 otherwise -> the activations are quantized (absmax
                              grid / e4m3 codes) and widened back, then
                              take the route below: an act-quantizing
                              spec never runs its activations unquantized;
  * QTensor, "torch"       -> dequantize to the compute dtype, then matmul
                              (the counterpart of the reference's XLA route);
  * QTensor, "kernel"      -> 4-bit weights with 2-D codes go through the
                              hand-written qmm kernel (kernels/qmm.py);
                              other formats take the dequantize route, as in
                              the reference.

QLoRA adapters on the weight add their low-rank term last:
y += (x @ A) @ B * (alpha / r), from the unquantized ``x``.

On the kernel route ``naf`` names a FASST activation that the qmm kernel
applies in its epilogue (``qmm_route`` says whether a product takes that
route); the caller of any other route, or of an adapted weight, applies
its activation itself.

Static per-site activation scales (core.calibration) arrive as
``act_scale``; ``None`` means dynamic per-token quantization. A
tensor-parallel rank's row-parallel product passes the dynamic per-token
scale itself (``token_scale`` of the absmax over the ranks), so the rank
quantizes its K slice on the whole row's scale.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .formats import SUB_OCTET
from .qtensor import QTensor
from .quantize import dequantize_blockwise

__all__ = ["qmatmul", "qmm_route", "embed_lookup", "quantize_activations",
           "quantize_activations_int8", "int8_mac_eligible", "act_quant_eligible",
           "StaticScale", "static_scale", "token_absmax", "token_scale", "f32_reciprocal"]

_MAX_CODE = {"int8": 127.0, "fp8": 448.0}


def f32_reciprocal(v: float) -> float:
    """1 / v rounded to f32. The reference's compiled programs divide by a
    constant as a product with its f32 reciprocal (XLA rewrites
    ``a / c`` so), which rounds differently from the division; the port
    computes what they compute."""
    return float(np.float32(1.0) / np.float32(v))


class StaticScale(NamedTuple):
    """A calibrated static activation scale as two f32 scalar tensors on
    the activations' device: the scale and its f32 reciprocal."""
    scale: torch.Tensor
    inv: torch.Tensor


def static_scale(value: float, device) -> StaticScale:
    return StaticScale(torch.tensor(value, dtype=torch.float32, device=device),
                       torch.tensor(f32_reciprocal(value), dtype=torch.float32,
                                    device=device))


# torch._int_mm on the card (cuBLASLt, torch 2.11) takes more than 16 rows,
# and at 24 or 48 rows refuses K <= 96; at every multiple of 32 rows it
# took every K and N from 32 to 1024 (a probe on the H100). So the codes
# are padded with zero rows to a multiple of this and the product sliced
_INT_MM_ROWS = 32


def qmm_route(w: Any, impl: str) -> bool:
    """Whether ``x @ w`` goes to the qmm kernel under ``impl``."""
    return (impl == "kernel" and isinstance(w, QTensor) and w.fmt in SUB_OCTET
            and w.data.ndim == 2)


def int8_mac_eligible(w: Any) -> bool:
    """True when ``w`` takes the integer w8a8 route: int8 storage with
    per-channel scales (one K-block)."""
    return (isinstance(w, QTensor) and w.fmt == "int8"
            and w.block_scales().shape[-2] == 1)


def act_quant_eligible(w: Any) -> bool:
    """True when a matmul against ``w`` quantizes its activations under an
    act-quantizing spec: the sites the calibration collector observes."""
    return isinstance(w, QTensor)


def token_absmax(x: torch.Tensor) -> torch.Tensor:
    """The f32 absmax of each row of ``x``'s last axis, ``(..., 1)``."""
    return x.to(torch.float32).abs().amax(dim=-1, keepdim=True)


def token_scale(absmax: torch.Tensor, fmt: str) -> torch.Tensor:
    """The dynamic per-token scale of rows with this absmax: absmax times
    the f32 reciprocal of the format's max code (1 for an all-zero row)."""
    return torch.where(absmax == 0, torch.ones_like(absmax),
                       absmax * f32_reciprocal(_MAX_CODE[fmt]))


def quantize_activations(x: torch.Tensor, fmt: str = "int8", scale=None):
    """Symmetric quantization of activations to int8 or fp8 (e4m3).

    ``scale=None`` is the dynamic per-token path (each row of the last
    axis gets its absmax scale); a per-token f32 tensor ``(..., 1)`` is
    that scale given (a row-parallel rank's, from the whole row's absmax);
    a static ``scale`` (a per-site scalar from core.calibration, as a
    float or a StaticScale) saturates outliers at the format's edge. The
    codes are computed in f32 whatever ``x``'s dtype, as the reference's
    f32 scale makes JAX compute them, and with the reference's compiled
    arithmetic: the dynamic scale is absmax times the f32 reciprocal of
    the format's max code, and a static scale multiplies by its f32
    reciprocal. Returns ``(codes, scale)``.
    """
    if fmt not in _MAX_CODE:
        raise ValueError(f"activation format must be int8 | fp8, got {fmt!r}")
    xf = x.to(torch.float32)
    if scale is None or (isinstance(scale, torch.Tensor) and scale.ndim):
        if scale is None:
            scale = token_scale(token_absmax(xf), fmt)
        y = xf / scale
    else:
        if not isinstance(scale, StaticScale):
            scale = static_scale(float(scale), x.device)
        y = xf * scale.inv
        scale = scale.scale
    if fmt == "int8":
        q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    else:
        q = torch.clamp(y, -448.0, 448.0).to(torch.float8_e4m3fn)
    return q, scale


def quantize_activations_int8(x: torch.Tensor, scale=None):
    """Legacy alias for ``quantize_activations(x, "int8", scale)``."""
    return quantize_activations(x, "int8", scale)


def _lora_term(x, w: QTensor, compute_dtype):
    if w.lora_a is None:
        return None
    scaling = w.lora_alpha / w.lora_a.shape[-1]
    xa = torch.matmul(x.to(compute_dtype), w.lora_a.to(compute_dtype))
    return torch.matmul(xa, w.lora_b.to(compute_dtype)) * scaling


def _int8_path(x, w: QTensor, compute_dtype, act_scale=None, total=None):
    """w8a8 integer matmul; None for an int8 weight with several K-blocks
    (it fake-quantizes instead). ``total`` sums the int32 products over a
    row-parallel rank's group before the rescale (qmatmul's ``reduce``)."""
    if not int8_mac_eligible(w):
        return None
    xq, sx = quantize_activations(x, "int8", act_scale)
    K, N = w.data.shape
    x2 = xq.reshape(-1, K)
    M = x2.shape[0]
    if M % _INT_MM_ROWS:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, -M % _INT_MM_ROWS))
    out = torch._int_mm(x2, w.data)[:M].reshape(*x.shape[:-1], N)
    if total is not None:
        out = total(out)
    sw = w.block_scales().squeeze(-2)                      # (N,)
    return (out.to(torch.float32) * sx * sw).to(compute_dtype)


def _fake_quant_act(x, fmt: str, act_scale, compute_dtype):
    """Quantize-then-widen activations for a (weight, act) pair with no
    integer route: the quantization error is real, the accumulate wide."""
    xq, sx = quantize_activations(x, fmt, act_scale)
    return (xq.to(torch.float32) * sx).to(compute_dtype)


def qmatmul(x: torch.Tensor, w: Any, *, act: str = "bf16",
            compute_dtype=torch.bfloat16, impl: str = "torch",
            naf: str | None = None, act_scale=None, reduce=None) -> torch.Tensor:
    """y = x @ w for plain or quantized ``w`` (last-2-axis contraction);
    with ``naf``, the qmm kernel's FASST activation of it (kernel route of
    an unadapted weight only: ``act`` is the activation *format*, not
    this). ``act_scale``: a calibrated static scale for the int8 / fp8
    activation routes, or a per-token scale tensor (quantize_activations).
    ``reduce``: a row-parallel rank's sum over its group
    (``TPGroup.all_reduce``). The integer route sums its int32 products
    before the rescale, so the result is one device's, bit for bit (an
    adapter term beside it is summed on its own); every other route sums
    its product, the adapter term included."""
    if naf is not None and not (qmm_route(w, impl) and w.lora_a is None):
        raise ValueError(f"naf={naf!r} fuses into the qmm kernel only, for a "
                         f"weight without adapters; this product takes the "
                         f"{impl!r} route")
    total = reduce if reduce is not None else (lambda t: t)
    if not isinstance(w, QTensor):
        return total(torch.matmul(x.to(compute_dtype), w.to(compute_dtype)))
    lora = _lora_term(x, w, compute_dtype)
    y = None
    if act == "int8" and w.fmt == "int8":
        y = _int8_path(x, w, compute_dtype, act_scale, total)
    if y is not None:
        return y if lora is None else y + total(lora).to(y.dtype)
    if act in _MAX_CODE:
        x = _fake_quant_act(x, act, act_scale, compute_dtype)
    if qmm_route(w, impl):
        from ..kernels import ops as kops  # lazy: avoid import cycle
        y = kops.qmm(x, w, compute_dtype=compute_dtype, naf=naf)
    else:
        y = torch.matmul(x.to(compute_dtype), w.dequantize(compute_dtype))
    return total(y if lora is None else y + lora.to(y.dtype))


def embed_lookup(table: Any, ids: torch.Tensor, compute_dtype=torch.bfloat16):
    """Embedding gather with row-wise dequantization for QTensor tables."""
    ids = ids.long()
    if not isinstance(table, QTensor):
        return table[ids].to(compute_dtype)
    return dequantize_blockwise(table.data[ids], table.block_scales()[ids],
                                table.fmt, q_axis=-1, out_dtype=compute_dtype)
