"""Fused dequant-matmul — the RMMEC SIMD MAC analogue (paper Figs. 5-6).

``qmm_kernel_call`` launches the hand-written CUDA kernel
(``csrc/qmm.cu``); ``qmm_plain`` is the same function in plain PyTorch.
Both compute ``x (M,K) @ dequant(codes, scales) (K,N)`` with the TPU
kernel's rounding: weights are dequantized in f32, both operands are
rounded to bf16, products are summed in f32 and cast once.

Codes are ``(K/2, N)`` uint8 for the packed 4-bit formats (low nibble =
even k), ``(K, N)`` int8 / float8_e4m3fn otherwise; scales are
``(K/sub_block, N)`` f32 (double-quantized scales expanded first).

``qmm_plan`` picks the kernel's regime from M and its tiles and K splits
(decode rows: split-K over every SM; prefill rows: tensor-core tiles,
split-K only where the tiles cannot fill the card). It is pure Python,
so the CPU tests hold its invariants.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..core.formats import FORMATS
from ..core.quantize import dequantize_blockwise

__all__ = ["qmm_plain", "qmm_kernel_call", "qmm_plan", "QmmPlan", "FMT_IDS"]

FMT_IDS = {"int4": 0, "fp4": 1, "nf4": 2, "int8": 3, "fp8": 4}
_IO_DTYPES = (torch.float32, torch.bfloat16)
_lib = None
# per (device index, stream): the split-K workspace and int32 tile counters,
# made at first use and grown as needed (see _scratch)
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_SMS: Dict[int, int] = {}
# per thread: launch shapes -> (plan, packed launch arguments, their address)
_ARGS = threading.local()

# csrc/qmm.cu's configurations: regime -> (BM, BN); slabs are BK deep
REGIMES = {"decode": (16, 64), "prefill": (128, 128)}
REGIME_IDS = {"decode": 0, "prefill": 1}
DECODE_MAX_M = 16
PREFILL_MAX_SPLITS = 8
BK = 64
H100_SMS = 132


class QmmPlan(NamedTuple):
    regime: str                 # "decode" (M <= 16) or "prefill"
    grid: Tuple[int, int, int]  # (column tiles, row tiles, K splits)
    splits: int
    k_per_split: int            # K range of each split; the last may be shorter
    workspace_elems: int        # f32 partials, splits * M * N (0 if one split)


@functools.lru_cache(maxsize=None)
def qmm_plan(M: int, N: int, K: int, sub_block: int, fmt_name: str,
             sms: int = H100_SMS) -> QmmPlan:
    """Regime, grid and K splits of one kernel launch.

    Decode rows are bound by the weight bytes and latency: the plan
    splits K until there are at least two blocks per SM. Prefill rows
    are bound by operations: split only as far as one wave of blocks
    fills the SMs, and at most 8 ways, since the last block of each tile
    sums all its partials alone, through one SM's share of the L2
    bandwidth. Every K range is a multiple of the 64-deep slab and of
    ``sub_block`` (so even, and each block reads whole scale rows); only
    the last may be shorter.
    """
    if fmt_name not in FMT_IDS:
        raise ValueError(f"qmm kernel formats are {sorted(FMT_IDS)}, got {fmt_name!r}")
    regime = "decode" if M <= DECODE_MAX_M else "prefill"
    bm, bn = REGIMES[regime]
    tiles = math.ceil(N / bn) * math.ceil(M / bm)
    unit = math.lcm(BK, sub_block)
    if regime == "decode":
        want = math.ceil(2 * sms / tiles)
    else:
        want = max(1, min(PREFILL_MAX_SPLITS, sms // tiles))
    want = max(1, min(want, math.ceil(K / unit)))
    kps = math.ceil(math.ceil(K / want) / unit) * unit
    splits = math.ceil(K / kps)
    if splits == 1:
        kps = K
    grid = (math.ceil(N / bn), math.ceil(M / bm), splits)
    return QmmPlan(regime, grid, splits, kps, splits * M * N if splits > 1 else 0)


def qmm_plain(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
              fmt_name: str, out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same rounding points)."""
    w = dequantize_blockwise(codes, scales, fmt_name, q_axis=-2,
                             out_dtype=torch.float32).to(torch.bfloat16)
    xb = x.to(torch.float32).to(torch.bfloat16)
    return torch.matmul(xb.to(torch.float32), w.to(torch.float32)).to(out_dtype)


def _library():
    global _lib
    if _lib is None:
        from .build import library
        lib = library("qmm")
        # one int64 array of qmm_launch's 19 arguments (see _launch_args)
        lib.qmm_launch_packed.restype = ctypes.c_int
        lib.qmm_launch_packed.argtypes = [ctypes.c_void_p]
        lib.qmm_set_codebooks.restype = ctypes.c_int
        lib.qmm_set_codebooks.argtypes = [ctypes.c_void_p]
        tables = np.ascontiguousarray(np.stack(
            [FORMATS["fp4"].codebook, FORMATS["nf4"].codebook]), np.float32)
        err = lib.qmm_set_codebooks(tables.ctypes.data)
        if err != 0:
            raise RuntimeError(f"qmm codebook upload failed: CUDA error {err}")
        _lib = lib
    return _lib


def qmm_kernel_call(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                    *, fmt_name: str, sub_block: int,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on anything else.
    (Every 4-bit linear of a decode step comes through here, and the step
    is bound by host time: the checks stay, written to cost little.)"""
    if fmt_name not in FMT_IDS:
        raise ValueError(f"qmm kernel formats are {sorted(FMT_IDS)}, got {fmt_name!r}")
    fmt = FORMATS[fmt_name]
    if not (x.is_cuda and codes.is_cuda and scales.is_cuda):
        raise ValueError("qmm_kernel_call takes CUDA tensors only")
    if x.dtype not in _IO_DTYPES or out_dtype not in _IO_DTYPES:
        raise ValueError(f"x and out must be f32 or bf16, got {x.dtype}, {out_dtype}")
    if scales.dtype != torch.float32:
        raise ValueError(f"scales must be f32, got {scales.dtype}")
    if codes.dtype != fmt.storage_dtype:
        raise ValueError(f"{fmt_name} codes must be {fmt.storage_dtype}, got {codes.dtype}")
    M, K = x.shape
    N = codes.shape[-1]
    if codes.ndim != 2 or codes.shape[0] * (2 if fmt.bits == 4 else 1) != K:
        raise ValueError(f"codes {tuple(codes.shape)} do not match K={K} ({fmt_name})")
    if K % sub_block or scales.shape != (K // sub_block, N):
        raise ValueError(f"scales {tuple(scales.shape)} do not match "
                         f"K={K}, N={N}, sub_block={sub_block}")
    x = x.contiguous()
    codes = codes.contiguous()
    scales = scales.contiguous()
    dev = x.device
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = _library()
    plan, args, addr = _launch_args(dev.index, M, N, K, sub_block, fmt_name,
                                    x.dtype == torch.bfloat16,
                                    out_dtype == torch.bfloat16)
    # the current stream's handle in one call (torch.cuda.current_stream
    # builds a Stream object first, several µs of host time a launch)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args[0], args[2], args[3], args[4] = (x.data_ptr(), codes.data_ptr(),
                                          scales.data_ptr(), out.data_ptr())
    if plan.splits > 1:
        args[16], args[17] = _scratch(dev.index, stream, plan.workspace_elems,
                                      plan.grid[0] * plan.grid[1])
    args[18] = stream
    err = lib.qmm_launch_packed(addr)
    if err != 0:
        raise RuntimeError(f"qmm kernel launch failed: CUDA error {err}")
    return out


def _launch_args(dev: int, M, N, K, sub_block, fmt_name, x_bf16, out_bf16):
    """The plan of these shapes and its packed launch arguments (19
    int64 in qmm_launch's order), cached per thread; the caller writes
    the pointers and the stream into it before each launch."""
    key = (dev, M, N, K, sub_block, fmt_name, x_bf16, out_bf16)
    hit = _ARGS.__dict__.get(key)
    if hit is None:
        if dev not in _SMS:
            _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = qmm_plan(M, N, K, sub_block, fmt_name, _SMS[dev])
        args = (ctypes.c_int64 * 19)(
            0, int(x_bf16), 0, 0, 0, int(out_bf16), M, N, K, sub_block, FMT_IDS[fmt_name],
            REGIME_IDS[plan.regime], plan.grid[0], plan.grid[1], plan.splits,
            plan.k_per_split, 0, 0, 0)
        hit = _ARGS.__dict__[key] = (plan, args, ctypes.addressof(args))
    return hit


def _scratch(dev: int, stream: int, ws_elems: int, tiles: int):
    """Pointers to the split-K workspace (at least ``ws_elems`` f32) and
    tile counters (at least ``tiles`` int32, all 0) of one stream, made
    with ``torch.empty`` / ``torch.zeros`` at first use and grown as
    needed. Launches on one stream run in order, and each leaves every
    counter at 0, so they share both."""
    ws, counters = _SCRATCH.get((dev, stream), (None, None))
    if ws is None or ws.numel() < ws_elems:
        ws = torch.empty(max(ws_elems, 1 << 16), dtype=torch.float32, device=dev)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=dev)
    _SCRATCH[(dev, stream)] = ws, counters
    return ws.data_ptr(), counters.data_ptr()
