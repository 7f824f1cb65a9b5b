"""Fused dequant-matmul — the RMMEC SIMD MAC analogue (paper Figs. 5-6).

``qmm_kernel_call`` launches the hand-written CUDA kernel
(``csrc/qmm.cu``); ``qmm_plain`` is the same function in plain PyTorch.
Both compute ``x (M,K) @ dequant(codes, scales) (K,N)`` with the TPU
kernel's rounding: weights are dequantized in f32, both operands are
rounded to bf16, products are summed in f32 and cast once.

Codes are ``(K/2, N)`` uint8 for the packed 4-bit formats (low nibble =
even k), ``(K, N)`` int8 / float8_e4m3fn otherwise; scales are
``(K/sub_block, N)`` f32 (double-quantized scales expanded first).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.formats import FORMATS
from ..core.quantize import dequantize_blockwise

__all__ = ["qmm_plain", "qmm_kernel_call", "FMT_IDS"]

FMT_IDS = {"int4": 0, "fp4": 1, "nf4": 2, "int8": 3, "fp8": 4}
_IO_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


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
        lib.qmm_launch.restype = ctypes.c_int
        lib.qmm_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    """Launch the CUDA kernel on CUDA tensors; raises on anything else."""
    if fmt_name not in FMT_IDS:
        raise ValueError(f"qmm kernel formats are {sorted(FMT_IDS)}, got {fmt_name!r}")
    if not (x.is_cuda and codes.is_cuda and scales.is_cuda):
        raise ValueError("qmm_kernel_call takes CUDA tensors only")
    if x.dtype not in _IO_DTYPES or out_dtype not in _IO_DTYPES:
        raise ValueError(f"x and out must be f32 or bf16, got {x.dtype}, {out_dtype}")
    if scales.dtype != torch.float32:
        raise ValueError(f"scales must be f32, got {scales.dtype}")
    if codes.dtype != FORMATS[fmt_name].storage_dtype:
        raise ValueError(f"{fmt_name} codes must be {FORMATS[fmt_name].storage_dtype}, "
                         f"got {codes.dtype}")
    M, K = x.shape
    pack = 2 if FORMATS[fmt_name].bits == 4 else 1
    N = codes.shape[-1]
    if codes.ndim != 2 or codes.shape[0] * pack != K:
        raise ValueError(f"codes {tuple(codes.shape)} do not match K={K} ({fmt_name})")
    if K % sub_block or tuple(scales.shape) != (K // sub_block, N):
        raise ValueError(f"scales {tuple(scales.shape)} do not match "
                         f"K={K}, N={N}, sub_block={sub_block}")
    x = x.contiguous()
    codes = codes.contiguous()
    scales = scales.contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    err = _library().qmm_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
        scales.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
        M, N, K, sub_block, FMT_IDS[fmt_name],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qmm kernel launch failed: CUDA error {err}")
    return out
