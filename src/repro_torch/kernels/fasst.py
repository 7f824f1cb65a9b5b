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
cast to the output type. It is a row reduction followed by an
elementwise pass, with no matrix product and no reuse in shared memory,
so bound by bytes (each element read twice, written once); Triton's
masked block loads give coalesced accesses, and CUDA would buy nothing.
The TPU kernel held a whole row in VMEM; a row here may be the
256,204-wide vocabulary, and a few such rows must still spread over
every SM. ``softmax_plan`` cuts each row into ``nseg`` segments of whole
column chunks, enough for two programs per SM:

- ``nseg == 1`` (M alone fills the card, or the row fits one chunk): one
  launch, one program per row walks its row in chunks, pass 1 keeping a
  running max and rescaled sum per lane, pass 2 writing
  ``exp(x * scale - m) / s``;
- ``nseg > 1``: two launches over (row, segment) programs. The first
  writes each segment's max and rescaled sum to (M, nseg) f32 partials
  (a segment wholly past ``valid_cols`` writes (-inf, 0)); the second
  merges the row's partials in segment order and writes the segment's
  probabilities, re-reading x from the L2.

``fasst_softmax_plain`` is its plain version.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from .build import H100_SMS, sm_count

__all__ = ["MODES", "fasst_act_plain", "fasst_act_call", "fasst_softmax_plain",
           "fasst_softmax_call", "softmax_plan", "SoftmaxPlan"]

MODES = ("relu", "sigmoid", "tanh", "gelu", "silu", "squared_relu", "selu",
         "identity")
_GELU_C = 0.7978845608028654                 # sqrt(2/pi)
_SELU_ALPHA, _SELU_LAMBDA = 1.6732632423543772, 1.0507009873554805
_BLOCK = 1024
_SOFTMAX_MAX_CHUNK = 4096
_kernel = None
_softmax_kernels = None
# per (device index, stream): the split softmax's partials (see _partials)
_SOFTMAX_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


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


class SoftmaxPlan(NamedTuple):
    chunk: int      # columns a program loads at once (a power of two)
    seg: int        # columns of one segment, a whole number of chunks
    nseg: int       # segments per row; segment z holds [z * seg, (z + 1) * seg)


@functools.lru_cache(maxsize=None)
def softmax_plan(M: int, C: int, sms: int = H100_SMS) -> SoftmaxPlan:
    """Chunk, segment width and segments per row of an (M, C) softmax.

    One segment a row (the one-launch kernel) when M alone gives two
    programs per SM or the row fits one chunk. Otherwise the segments are
    made narrow enough (chunks of a power of two, at least 16 columns)
    that ``M * nseg`` reaches two programs per SM, where C allows.
    """
    chunk = max(16, min(_SOFTMAX_MAX_CHUNK, 1 << max(C - 1, 0).bit_length()))
    if M >= 2 * sms or C <= chunk:
        return SoftmaxPlan(chunk, chunk * max(1, math.ceil(C / chunk)), 1)
    want = math.ceil(2 * sms / max(M, 1))
    width = max(1, C // want)                 # widest segment that makes `want`
    chunk = max(16, min(_SOFTMAX_MAX_CHUNK, 1 << (width.bit_length() - 1)))
    seg = chunk * max(1, width // chunk)
    return SoftmaxPlan(chunk, seg, math.ceil(C / seg))


def _build_softmax_kernels():
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

    # Split rows. Rows start at row * CQ * VEC elements, so Triton knows
    # they are VEC-aligned; chunks wholly inside the valid columns load
    # and store without masks (16-byte accesses).
    @triton.jit
    def softmax_partials_kernel(x_ptr, part_ptr, CQ, valid, scale, seg, nseg,
                                VEC: tl.constexpr, CHUNK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        z = tl.program_id(1)
        xr = x_ptr + row * CQ * VEC
        lanes = tl.arange(0, CHUNK)
        start = z * seg
        stop = tl.minimum(start + seg, valid)
        m = tl.full([CHUNK], float("-inf"), tl.float32)
        s = tl.zeros([CHUNK], tl.float32)
        for off in range(start, stop, CHUNK):
            cols = off + lanes
            if off + CHUNK <= stop:
                x = tl.load(xr + cols).to(tl.float32) * scale
            else:
                x = tl.load(xr + cols, mask=cols < stop, other=0.0)
                x = tl.where(cols < stop, x.to(tl.float32) * scale, float("-inf"))
            m_new = tl.maximum(m, x)
            live = m_new > float("-inf")
            alpha = tl.where(live, tl.exp(m - m_new), 0.0)
            s = s * alpha + tl.where(live, tl.exp(x - m_new), 0.0)
            m = m_new
        m_seg = tl.max(m, axis=0)
        s_seg = tl.sum(tl.where(m > float("-inf"), s * tl.exp(m - m_seg), 0.0), axis=0)
        tl.store(part_ptr + row * nseg + z, m_seg)
        tl.store(part_ptr + (tl.num_programs(0) + row) * nseg + z, s_seg)

    @triton.jit
    def softmax_normalize_kernel(x_ptr, y_ptr, part_ptr, C, CQ, valid, scale, seg,
                                 nseg, VEC: tl.constexpr, CHUNK: tl.constexpr,
                                 NSEG: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        z = tl.program_id(1)
        # the row's partials, merged in segment order
        segs = tl.arange(0, NSEG)
        pm = tl.load(part_ptr + row * nseg + segs, mask=segs < nseg,
                     other=float("-inf"))
        ps = tl.load(part_ptr + (tl.num_programs(0) + row) * nseg + segs,
                     mask=segs < nseg, other=0.0)
        m_row = tl.max(pm, axis=0)
        s_row = tl.sum(tl.where(pm > float("-inf"), ps * tl.exp(pm - m_row), 0.0),
                       axis=0)
        xr = x_ptr + row * CQ * VEC
        yr = y_ptr + row * CQ * VEC
        lanes = tl.arange(0, CHUNK)
        start = z * seg
        stop = tl.minimum(start + seg, C)
        for off in range(start, stop, CHUNK):
            cols = off + lanes
            if off + CHUNK <= valid:
                x = tl.load(xr + cols).to(tl.float32)
                y = tl.exp(x * scale - m_row) / s_row
                tl.store(yr + cols, y.to(y_ptr.dtype.element_ty))
            else:
                x = tl.load(xr + cols, mask=cols < valid, other=0.0).to(tl.float32)
                y = tl.where(cols < valid, tl.exp(x * scale - m_row) / s_row, 0.0)
                tl.store(yr + cols, y.to(y_ptr.dtype.element_ty), mask=cols < stop)

    return fasst_softmax_kernel, softmax_partials_kernel, softmax_normalize_kernel


def fasst_softmax_call(x: torch.Tensor, *, scale: float = 1.0,
                       valid_cols: int = -1, out_dtype=None) -> torch.Tensor:
    """Launch the Triton row softmax on a CUDA (M, C) tensor: one launch,
    or two where ``softmax_plan`` splits the rows; raises on anything
    else."""
    global _softmax_kernels
    if not x.is_cuda:
        raise ValueError("fasst_softmax_call takes CUDA tensors only")
    if x.ndim != 2:
        raise ValueError(f"fasst_softmax_call takes (M, C), got {tuple(x.shape)}")
    if _softmax_kernels is None:
        _softmax_kernels = _build_softmax_kernels()
    x = x.contiguous()
    M, C = x.shape
    dev = x.device
    out = torch.empty((M, C), dtype=out_dtype or x.dtype, device=dev)
    if not (M and C):
        return out
    plan = softmax_plan(M, C, sm_count(dev.index))
    valid, scale = _valid(valid_cols, C), float(scale)
    one, partials, normalize = _softmax_kernels
    warps = 8 if plan.chunk >= 2048 else 4
    if plan.nseg == 1:
        one[(M,)](x, out, C, valid, scale, CHUNK=plan.chunk, num_warps=warps)
        return out
    vec = 4 if C % 4 == 0 else 1
    part = _partials(dev.index, 2 * M * plan.nseg)
    grid = (M, plan.nseg)
    partials[grid](x, part, C // vec, valid, scale, plan.seg, plan.nseg, VEC=vec,
                   CHUNK=plan.chunk, num_warps=warps)
    normalize[grid](x, out, part, C, C // vec, valid, scale, plan.seg, plan.nseg,
                    VEC=vec, CHUNK=plan.chunk, NSEG=1 << (plan.nseg - 1).bit_length(),
                    num_warps=warps)
    return out


def _partials(dev: int, elems: int) -> torch.Tensor:
    """The split softmax's f32 partials (at least ``elems``) of the current
    stream, made at first use and grown as needed. Launches on one stream
    run in order, so they share it."""
    key = (dev, torch._C._cuda_getCurrentRawStream(dev))
    part = _SOFTMAX_SCRATCH.get(key)
    if part is None or part.numel() < elems:
        part = _SOFTMAX_SCRATCH[key] = torch.empty(max(elems, 1 << 14),
                                                   dtype=torch.float32, device=dev)
    return part
