"""FASST — one reconfigurable non-linear activation kernel (paper Figs. 7-8).

The paper's FASST unit is a single datapath reused for ReLU, sigmoid,
tanh, GeLU, SiLU, SELU, ... at low-precision I/O. Here that is one
Triton kernel with the mode as a compile-time constant: one masked
load, f32 math, one store. It replaces the TPU kernel
``kernels/fasst.py::fasst_act_call`` (body ``_act_kernel``, datapath
``_naf``) of the JAX package.

What bounds it on the H100: it reads and writes each element once and
does a handful of operations per element, so it is bound by bytes.
Elementwise work has no reuse, so the design is simply a flat pass
with wide blocks; Triton is enough for that, CUDA would buy nothing.

``_naf`` / ``fasst_act_plain`` is the plain PyTorch version.
"""

from __future__ import annotations

import torch

__all__ = ["MODES", "fasst_act_plain", "fasst_act_call"]

MODES = ("relu", "sigmoid", "tanh", "gelu", "silu", "squared_relu", "selu",
         "identity")
_GELU_C = 0.7978845608028654                 # sqrt(2/pi)
_SELU_ALPHA, _SELU_LAMBDA = 1.6732632423543772, 1.0507009873554805
_BLOCK = 1024
_kernel = None


def _naf(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The shared NAF datapath, f32 in/out."""
    if mode == "relu":
        return torch.clamp_min(x, 0.0)
    if mode == "sigmoid":
        return torch.sigmoid(x)
    if mode == "tanh":
        return torch.tanh(x)
    if mode == "gelu":                       # tanh approximation
        return 0.5 * x * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * x ** 3)))
    if mode == "silu":
        return x * torch.sigmoid(x)
    if mode == "squared_relu":
        r = torch.clamp_min(x, 0.0)
        return r * r
    if mode == "selu":
        return _SELU_LAMBDA * torch.where(x > 0, x, _SELU_ALPHA * (torch.exp(x) - 1.0))
    if mode == "identity":
        return x
    raise ValueError(f"unknown NAF mode {mode!r}")


def fasst_act_plain(x: torch.Tensor, mode: str, out_dtype=None) -> torch.Tensor:
    return _naf(x.to(torch.float32), mode).to(out_dtype or x.dtype)


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def fasst_act_kernel(x_ptr, y_ptr, n, MODE: tl.constexpr,
                         BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        if MODE == 0:                                   # relu
            y = tl.maximum(x, 0.0)
        elif MODE == 1:                                 # sigmoid
            y = 1.0 / (1.0 + tl.exp(-x))
        elif MODE == 2:                                 # tanh = 2 sigmoid(2x) - 1
            y = 2.0 / (1.0 + tl.exp(-2.0 * x)) - 1.0
        elif MODE == 3:                                 # gelu, tanh approximation
            u = 0.7978845608028654 * (x + 0.044715 * x * x * x)
            y = 0.5 * x * (2.0 / (1.0 + tl.exp(-2.0 * u)))
        elif MODE == 4:                                 # silu
            y = x / (1.0 + tl.exp(-x))
        elif MODE == 5:                                 # squared relu
            r = tl.maximum(x, 0.0)
            y = r * r
        elif MODE == 6:                                 # selu
            y = 1.0507009873554805 * tl.where(
                x > 0, x, 1.6732632423543772 * (tl.exp(x) - 1.0))
        else:                                           # identity
            y = x
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return fasst_act_kernel


def fasst_act_call(x: torch.Tensor, *, mode: str, out_dtype=None) -> torch.Tensor:
    """Launch the Triton kernel on a CUDA tensor; raises on anything else."""
    global _kernel
    if not x.is_cuda:
        raise ValueError("fasst_act_call takes CUDA tensors only")
    if mode not in MODES:
        raise ValueError(f"unknown NAF mode {mode!r}")
    if _kernel is None:
        _kernel = _build_kernel()
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype or x.dtype, device=x.device)
    n = x.numel()
    if n:
        _kernel[(-(-n // _BLOCK),)](x, out, n, MODE=MODES.index(mode),
                                           BLOCK=_BLOCK, num_warps=4)
    return out

