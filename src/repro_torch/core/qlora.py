"""QLoRA: low-rank adapters over frozen quantized weights (paper §III).

The base weights stay quantized and frozen; small A / B adapters carry the
update. Adapters live inside the QTensor (``lora_a`` / ``lora_b``), so the
parameter tree keeps its shape: ``extract_adapters`` pulls the adapter
subtree out and ``inject_adapters`` writes one back. Parameter paths are
spelled as the reference spells them (``['decoder']['layers']['attn']['wq']``),
so the same target regex picks the same weights.
"""

from __future__ import annotations

import re
from typing import Any

import torch

from .qtensor import QTensor

__all__ = ["attach_lora", "extract_adapters", "inject_adapters",
           "count_adapter_params", "merge_lora"]

_DEFAULT_TARGETS = r"(wq|wk|wv|wo|wqkv|w_in|w_gate|w_up|w_down|w_out)"


def _map(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}['{k}']") for k, v in tree.items()}
    return fn(path, tree)


def attach_lora(params: Any, generator: torch.Generator, rank: int = 16,
                targets: str = _DEFAULT_TARGETS, alpha: float = 16.0) -> Any:
    """Attach zero-B / gaussian-A adapters to the QTensors whose path
    matches ``targets``, drawing A from ``generator`` on its device."""
    pat = re.compile(targets)

    def attach(path, leaf):
        if not (isinstance(leaf, QTensor) and pat.search(path) and len(leaf.shape) >= 2):
            return leaf
        *batch, kdim, ndim = leaf.shape
        a = torch.randn((*batch, kdim, rank), generator=generator,
                        device=generator.device, dtype=torch.float32) * (1.0 / kdim ** 0.5)
        b = torch.zeros((*batch, rank, ndim), dtype=torch.float32, device=generator.device)
        return leaf.with_lora(a, b, alpha=alpha)

    return _map(attach, params)


def extract_adapters(params: Any) -> Any:
    """Parallel tree holding {'a', 'b'} per adapted QTensor, None elsewhere."""
    return _map(lambda _, leaf: {"a": leaf.lora_a, "b": leaf.lora_b}
                if isinstance(leaf, QTensor) and leaf.lora_a is not None else None,
                params)


def inject_adapters(params: Any, adapters: Any) -> Any:
    """Inverse of extract_adapters: write adapter tensors into the QTensors."""
    if isinstance(params, dict):
        return {k: inject_adapters(v, adapters[k]) for k, v in params.items()}
    if isinstance(params, QTensor) and adapters is not None:
        return params.with_lora(adapters["a"], adapters["b"], alpha=params.lora_alpha)
    return params


def count_adapter_params(adapters: Any) -> int:
    if isinstance(adapters, dict):
        return sum(count_adapter_params(v) for v in adapters.values())
    return adapters.numel() if isinstance(adapters, torch.Tensor) else 0


def merge_lora(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Export path: dense W' = dequant(W) + A @ B * alpha / r."""
    w = qt.dequantize(torch.float32)
    if qt.lora_a is not None:
        w = w + torch.matmul(qt.lora_a, qt.lora_b) * (qt.lora_alpha / qt.lora_a.shape[-1])
    return w.to(dtype)
