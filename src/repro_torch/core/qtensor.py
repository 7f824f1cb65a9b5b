"""QTensor: a quantized weight — packed codes plus blockwise scales, and
optional QLoRA adapters.

The field names and static metadata are those of the reference's
QTensor, so a quantized parameter tree has the same shape in both
packages. A layer-stacked QTensor (leading ``L`` axis on every child,
adapters included) yields one layer's weight through
:meth:`QTensor.select`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .formats import Format
from .quantize import (dequantize_blockwise, dequantize_scales,
                       quantize_blockwise, quantize_scales)

__all__ = ["QTensor", "maybe_dequantize"]


@dataclasses.dataclass
class QTensor:
    data: torch.Tensor                       # packed codes
    scales: Optional[torch.Tensor]           # f32 block scales (None if dq)
    scales_q: Optional[torch.Tensor] = None  # int8 scale codes (double quant)
    scales_cscale: Optional[torch.Tensor] = None
    scales_offset: Optional[torch.Tensor] = None
    lora_a: Optional[torch.Tensor] = None    # (K, r) QLoRA adapter
    lora_b: Optional[torch.Tensor] = None    # (r, N) QLoRA adapter
    fmt: str = "int4"
    q_axis: int = -2
    shape: tuple = ()                        # logical (dequantized) shape
    scales_shape: tuple = ()                 # shape of the f32 scales tensor
    lora_alpha: float = 16.0

    _CHILDREN = ("data", "scales", "scales_q", "scales_cscale", "scales_offset",
                 "lora_a", "lora_b")

    @classmethod
    def quantize(cls, w: torch.Tensor, fmt: str | Format, block_size: int = 64,
                 q_axis: int = -2, double_quant: bool = False) -> "QTensor":
        fmt_name = fmt if isinstance(fmt, str) else fmt.name
        codes, scales = quantize_blockwise(w, fmt_name, block_size, q_axis)
        meta = dict(fmt=fmt_name, q_axis=q_axis % w.ndim - w.ndim,
                    shape=tuple(w.shape), scales_shape=tuple(scales.shape))
        if double_quant:
            sq, sc, so, _ = quantize_scales(scales)
            return cls(codes, None, sq, sc, so, **meta)
        return cls(codes, scales, **meta)

    def select(self, i: int) -> "QTensor":
        """Layer ``i`` of a layer-stacked QTensor (every child sliced)."""
        return dataclasses.replace(self, **{
            n: getattr(self, n)[i] for n in self._CHILDREN
            if getattr(self, n) is not None})

    def block_scales(self) -> torch.Tensor:
        if self.scales is not None:
            return self.scales
        # the target shape follows the runtime data shape (a layer slice
        # drops the leading axis); only the q_axis dim differs from data's
        shape = list(self.data.shape)
        shape[self.q_axis] = self.scales_shape[self.q_axis]
        return dequantize_scales(self.scales_q, self.scales_cscale,
                                 self.scales_offset, tuple(shape))

    def with_lora(self, lora_a: torch.Tensor, lora_b: torch.Tensor,
                  alpha: float = 16.0) -> "QTensor":
        return dataclasses.replace(self, lora_a=lora_a, lora_b=lora_b,
                                   lora_alpha=alpha)

    def nbytes(self) -> int:
        """Storage bytes of the codes, every scale tensor and the adapters."""
        return sum(t.numel() * t.element_size()
                   for t in (getattr(self, n) for n in self._CHILDREN) if t is not None)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return dequantize_blockwise(self.data, self.block_scales(), self.fmt,
                                    q_axis=self.q_axis, out_dtype=dtype)


def maybe_dequantize(w: Any, dtype=torch.bfloat16) -> torch.Tensor:
    """QTensor -> dense tensor; plain tensors pass through (cast)."""
    if isinstance(w, QTensor):
        return w.dequantize(dtype)
    return w.to(dtype)
