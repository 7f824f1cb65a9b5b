"""FASST — one reconfigurable non-linear activation kernel (paper Figs. 7-8),
and the fused row softmax.

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

The row softmax (``fasst_softmax_call``) replaces the TPU kernel
``kernels/fasst.py::fasst_softmax_call`` (body ``_softmax_kernel``):
x * scale, columns at or past ``valid_cols`` masked to -inf (so they
come out exactly 0), max-subtract, exp, normalize, all in f32 with one
cast to the output type. It is a one-pass row reduction with no matrix
product, bound by bytes (each element read twice, written once). The
TPU kernel held a whole row in VMEM; a row here may be the 256,204-wide
vocabulary, so each program walks its row in column chunks: pass 1
keeps a running max and rescaled sum per lane, pass 2 writes
``exp(x * scale - m) / s``. ``fasst_softmax_plain`` is its plain
version.
"""

from __future__ import annotations

import torch

__all__ = ["MODES", "fasst_act_plain", "fasst_act_call", "fasst_softmax_plain",
           "fasst_softmax_call"]

MODES = ("relu", "sigmoid", "tanh", "gelu", "silu", "squared_relu", "selu",
         "identity")
_GELU_C = 0.7978845608028654                 # sqrt(2/pi)
_SELU_ALPHA, _SELU_LAMBDA = 1.6732632423543772, 1.0507009873554805
_BLOCK = 1024
_SOFTMAX_MAX_CHUNK = 4096
_kernel = None
_softmax_kernel = None


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


def _valid(valid_cols: int, C: int) -> int:
    """Columns that take part: all when < 0, at most C."""
    return C if valid_cols < 0 else min(valid_cols, C)


def fasst_softmax_plain(x: torch.Tensor, *, scale: float = 1.0,
                        valid_cols: int = -1, out_dtype=None) -> torch.Tensor:
    """Row softmax over the last axis of (M, C), f32 inside."""
    C = x.shape[-1]
    xf = x.to(torch.float32) * scale
    mask = torch.arange(C, device=x.device) < _valid(valid_cols, C)
    xf = torch.where(mask, xf, float("-inf"))
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    y = torch.where(mask, e / e.sum(dim=-1, keepdim=True), 0.0)
    return y.to(out_dtype or x.dtype)


def _build_softmax_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def fasst_softmax_kernel(x_ptr, y_ptr, C, valid, scale,
                             CHUNK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        xr = x_ptr + row * C
        yr = y_ptr + row * C
        lanes = tl.arange(0, CHUNK)
        # pass 1: running max and rescaled sum, per lane
        m = tl.full([CHUNK], float("-inf"), tl.float32)
        s = tl.zeros([CHUNK], tl.float32)
        for start in range(0, valid, CHUNK):
            cols = start + lanes
            x = tl.load(xr + cols, mask=cols < valid, other=0.0)
            x = tl.where(cols < valid, x.to(tl.float32) * scale, float("-inf"))
            m_new = tl.maximum(m, x)
            live = m_new > float("-inf")
            alpha = tl.where(live, tl.exp(m - m_new), 0.0)
            s = s * alpha + tl.where(live, tl.exp(x - m_new), 0.0)
            m = m_new
        m_row = tl.max(m, axis=0)
        s_row = tl.sum(tl.where(m > float("-inf"), s * tl.exp(m - m_row), 0.0),
                       axis=0)
        # pass 2: normalized probabilities; masked columns exactly 0
        for start in range(0, C, CHUNK):
            cols = start + lanes
            x = tl.load(xr + cols, mask=cols < valid, other=0.0).to(tl.float32)
            y = tl.where(cols < valid, tl.exp(x * scale - m_row) / s_row, 0.0)
            tl.store(yr + cols, y.to(y_ptr.dtype.element_ty), mask=cols < C)

    return fasst_softmax_kernel


def fasst_softmax_call(x: torch.Tensor, *, scale: float = 1.0,
                       valid_cols: int = -1, out_dtype=None) -> torch.Tensor:
    """Launch the Triton row softmax on a CUDA (M, C) tensor; raises on
    anything else."""
    global _softmax_kernel
    if not x.is_cuda:
        raise ValueError("fasst_softmax_call takes CUDA tensors only")
    if x.ndim != 2:
        raise ValueError(f"fasst_softmax_call takes (M, C), got {tuple(x.shape)}")
    if _softmax_kernel is None:
        _softmax_kernel = _build_softmax_kernel()
    x = x.contiguous()
    M, C = x.shape
    out = torch.empty((M, C), dtype=out_dtype or x.dtype, device=x.device)
    if M and C:
        chunk = max(16, min(_SOFTMAX_MAX_CHUNK, 1 << (C - 1).bit_length()))
        _softmax_kernel[(M,)](x, out, C, _valid(valid_cols, C), float(scale),
                              CHUNK=chunk, num_warps=8 if chunk >= 2048 else 4)
    return out
