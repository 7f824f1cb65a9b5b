"""Weight bridge: a nested dict of numpy arrays -> the port's parameter tree.

A quantized leaf arrives as a dict of the reference QTensor's fields
(``data``, ``scales`` or ``scales_q``/``scales_cscale``/``scales_offset``,
``lora_a``/``lora_b`` QLoRA adapters or None, ``fmt``, ``q_axis``,
``shape``, ``scales_shape``, ``lora_alpha``); every other leaf is a
numpy array. bf16 arrays cross as 16-bit views and float8 arrays as
8-bit views (by dtype name, so no extension dtype is needed here), and
come out as torch bf16 / float8_e4m3fn tensors. Layer-stacked ``(L, ...)``
trees cross unchanged, and so do optimizer states: None leaves stay None
and an 8-bit moment's ``{codes, scale}`` dict is a dict of arrays.

``to_raw`` / ``from_raw`` are the same views one way and the other for a
single leaf: a tensor as a numpy array of its raw bits plus its dtype's
name, as the checkpoints of both packages store it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.qtensor import QTensor

__all__ = ["to_torch", "from_numpy_tree", "to_raw", "from_raw"]

_VIEWS = {"bfloat16": (np.uint16, torch.uint16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn)}
_QT_ARRAYS = ("data", "scales", "scales_q", "scales_cscale", "scales_offset",
              "lora_a", "lora_b")


def to_torch(arr, device="cpu") -> torch.Tensor:
    """One numpy array -> tensor on ``device`` (bit-exact)."""
    arr = np.asarray(arr)
    return from_raw(arr, arr.dtype.name, device)


def from_raw(arr: np.ndarray, dtype_name: str, device="cpu") -> torch.Tensor:
    """A numpy array holding the bits of a ``dtype_name`` array (bf16 and
    float8 as 16 / 8-bit integers) -> tensor on ``device``."""
    arr = np.array(arr, order="C")          # a C-ordered copy; 0-d stays 0-d
    view = _VIEWS.get(dtype_name)
    if view is not None:
        np_view, t_view, t_dtype = view
        return torch.from_numpy(arr.view(np_view)).view(t_view).view(t_dtype).to(device)
    return torch.from_numpy(arr).to(device)


_RAW = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
        torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8)}


def to_raw(t) -> tuple:
    """A tensor (or numpy array) -> (numpy array of its bits on the host,
    dtype name)."""
    if not isinstance(t, torch.Tensor):
        arr = np.asarray(t)
        return arr, arr.dtype.name
    t = t.detach().cpu()
    if t.dtype in _RAW:
        name, t_view, np_view = _RAW[t.dtype]
        return t.view(t_view).numpy().view(np_view), name
    arr = t.numpy()
    return arr, arr.dtype.name


def from_numpy_tree(tree: Any, device="cpu") -> Any:
    """Nested dict of numpy arrays / QTensor field dicts (None leaves
    kept) -> port tree."""
    if tree is None:
        return None
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
