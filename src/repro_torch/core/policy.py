"""PrecisionPolicy — per-parameter format selection and tree PTQ.

Norms and biases stay high precision, embeddings take the embed format,
and the matmul weights take the (sub-octet) weight format. Parameter
paths are spelled as the reference spells them (``['decoder']['layers']
['attn']['wq']``), so the same regexes pick the same leaves.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Tuple

import torch

from .qtensor import QTensor

__all__ = ["PrecisionPolicy", "quantize_tree", "tree_nbytes"]

_EXEMPT = re.compile(
    r"(norm|bias|scale_|rope|a_log|dt_|conv|rglru|router|a_param|\['D'\])")
_EMBED = re.compile(r"(embedding|lm_head|pos_embed)")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    name: str = "bf16"
    weights: str = "bf16"
    embed: str = "bf16"
    kv_cache: str = "bf16"
    act: str = "bf16"
    block_size: int = 64
    double_quant: bool = False
    compute_dtype: Any = torch.bfloat16
    overrides: Tuple[Tuple[str, str], ...] = ()   # (path regex, fmt)

    def format_for(self, path: str) -> str:
        for pat, fmt in self.overrides:
            if re.search(pat, path):
                return fmt
        if _EXEMPT.search(path):
            return "bf16"
        if _EMBED.search(path):
            return self.embed
        return self.weights


def _is_quantizable(leaf: Any, fmt: str) -> bool:
    return (fmt not in ("bf16", "f32") and isinstance(leaf, torch.Tensor)
            and leaf.ndim >= 2 and leaf.is_floating_point())


def quantize_tree(params: Any, policy: PrecisionPolicy) -> Any:
    """PTQ a nested-dict parameter tree per the policy (paper §III)."""

    def visit(path: str, node: Any):
        if isinstance(node, dict):
            return {k: visit(f"{path}['{k}']", v) for k, v in node.items()}
        if isinstance(node, QTensor):
            return node
        fmt = policy.format_for(path)
        if not _is_quantizable(node, fmt):
            if isinstance(node, torch.Tensor) and node.is_floating_point():
                return node.to(policy.compute_dtype)
            return node
        q_axis = -1 if _EMBED.search(path) else -2
        return QTensor.quantize(node, fmt, block_size=policy.block_size,
                                q_axis=q_axis, double_quant=policy.double_quant)

    return visit("", params)


def tree_nbytes(params: Any) -> int:
    """Total storage bytes of a (possibly quantized) parameter tree."""
    if isinstance(params, dict):
        return sum(tree_nbytes(v) for v in params.values())
    if isinstance(params, QTensor):
        return params.nbytes()
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
