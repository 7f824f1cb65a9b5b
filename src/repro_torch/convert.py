"""Weight bridge: a nested dict of numpy arrays -> the port's parameter tree.

A quantized leaf arrives as a dict of the reference QTensor's fields
(``data``, ``scales`` or ``scales_q``/``scales_cscale``/``scales_offset``,
``lora_a``/``lora_b`` QLoRA adapters or None, ``fmt``, ``q_axis``,
``shape``, ``scales_shape``, ``lora_alpha``); every other leaf is a
numpy array. bf16 arrays cross as 16-bit views and float8 arrays as
8-bit views (by dtype name, so no extension dtype is needed here), and
come out as torch bf16 / float8_e4m3fn tensors. Layer-stacked ``(L, ...)``
trees cross unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.qtensor import QTensor

__all__ = ["to_torch", "from_numpy_tree"]

_VIEWS = {"bfloat16": (np.uint16, torch.uint16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn)}
_QT_ARRAYS = ("data", "scales", "scales_q", "scales_cscale", "scales_offset",
              "lora_a", "lora_b")


def to_torch(arr, device="cpu") -> torch.Tensor:
    """One numpy array -> tensor on ``device`` (bit-exact)."""
    arr = np.asarray(arr)
    view = _VIEWS.get(arr.dtype.name)
    if view is not None:
        np_view, t_view, t_dtype = view
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np_view).copy())
        return t.view(t_view).view(t_dtype).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def from_numpy_tree(tree: Any, device="cpu") -> Any:
    """Nested dict of numpy arrays / QTensor field dicts -> port tree."""
    if isinstance(tree, dict) and "data" in tree and "fmt" in tree:
        arrays = {k: None if tree.get(k) is None else to_torch(tree[k], device)
                  for k in _QT_ARRAYS}
        return QTensor(**arrays, fmt=tree["fmt"], q_axis=int(tree["q_axis"]),
                       shape=tuple(tree["shape"]),
                       scales_shape=tuple(tree["scales_shape"]),
                       lora_alpha=float(tree.get("lora_alpha", 16.0)))
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    return to_torch(tree, device)
