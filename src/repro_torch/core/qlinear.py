"""Quantized linear algebra front-end.

Every matmul of the model routes through :func:`qmatmul`:

  * plain tensor        -> matmul in the compute dtype;
  * QTensor, "torch"    -> dequantize to the compute dtype, then matmul
                           (the counterpart of the reference's XLA route);
  * QTensor, "kernel"   -> 4-bit weights with 2-D codes go through the
                           hand-written qmm kernel (kernels/qmm.py);
                           other formats take the dequantize route, as in
                           the reference.

On the kernel route ``naf`` names a FASST activation that the qmm kernel
applies in its epilogue (``qmm_route`` says whether a product takes that
route); the caller of any other route applies its activation itself.

Activation quantization (a8 / afp8 specs) and QLoRA adapters are not part
of this slice and raise.
"""

from __future__ import annotations

from typing import Any

import torch

from ..unported import later
from .formats import SUB_OCTET
from .qtensor import QTensor
from .quantize import dequantize_blockwise

__all__ = ["qmatmul", "qmm_route", "embed_lookup"]


def qmm_route(w: Any, impl: str) -> bool:
    """Whether ``x @ w`` goes to the qmm kernel under ``impl``."""
    return (impl == "kernel" and isinstance(w, QTensor) and w.fmt in SUB_OCTET
            and w.data.ndim == 2)


def qmatmul(x: torch.Tensor, w: Any, *, act: str = "bf16",
            compute_dtype=torch.bfloat16, impl: str = "torch",
            naf: str | None = None) -> torch.Tensor:
    """y = x @ w for plain or quantized ``w`` (last-2-axis contraction);
    with ``naf``, the qmm kernel's FASST activation of it (kernel route
    only: ``act`` is the activation *format*, not this)."""
    if act != "bf16":
        raise later(f"activation format {act!r} (act-quantizing matmuls)", 3)
    if qmm_route(w, impl):
        from ..kernels import ops as kops  # lazy: avoid import cycle
        return kops.qmm(x, w, compute_dtype=compute_dtype, naf=naf)
    if naf is not None:
        raise ValueError(f"naf={naf!r} fuses into the qmm kernel only; this product "
                         f"takes the {impl!r} route (qmm_route is False)")
    if not isinstance(w, QTensor):
        return torch.matmul(x.to(compute_dtype), w.to(compute_dtype))
    return torch.matmul(x.to(compute_dtype), w.dequantize(compute_dtype))


def embed_lookup(table: Any, ids: torch.Tensor, compute_dtype=torch.bfloat16):
    """Embedding gather with row-wise dequantization for QTensor tables."""
    ids = ids.long()
    if not isinstance(table, QTensor):
        return table[ids].to(compute_dtype)
    return dequantize_blockwise(table.data[ids], table.block_scales()[ids],
                                table.fmt, q_axis=-1, out_dtype=compute_dtype)
