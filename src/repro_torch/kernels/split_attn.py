"""What the two split-and-merge decode-attention wrappers share.

``csrc/attend_split.cuh`` holds the split body and the merge of the paged
(``paged_attn.py``) and the dense (``decode_attn.py``) decode-attention
kernels. This module holds their Python side: the kernels' block size,
the mirror of the header's shared-memory layout (``smem_bytes``), the
per-stream workspace and merge counters (``scratch``), and the int32
view of an index tensor (``int32``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["THREADS", "SMEM_LIMIT", "TARGET_TOKENS", "smem_bytes", "scratch", "int32"]

THREADS = 128               # threads of one block (attend_split.cuh)
SMEM_LIMIT = 48 * 1024      # shared memory of one block (the kernels take no more)
TARGET_TOKENS = 64          # tokens of one split, where the row and shared memory allow

# per (device index, stream): the split workspace and the int32 counters
# of each (row, kv head), made at first use and grown as needed
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(T: int, G: int, d: int, kv_bytes: int, pps: int = 0) -> int:
    """Shared memory of one block of T tokens (attend_split.cuh::make_layout);
    ``pps`` page ids for the paged kernel, none for the dense one."""
    cols4 = G * d // 4
    slices = 1 if cols4 >= THREADS else THREADS // cols4
    row = d * kv_bytes + 16
    parts = [T * row, T * row, 4 * T, 4 * T, 4 * G * d, 4 * G * T, 4 * slices * G * d,
             4 * G, 4 * G, 4 * pps, 4]
    return sum(_align16(n) for n in parts)


def scratch(dev: int, stream: int, ws_elems: int, counters: int):
    """Pointers to the split workspace (at least ``ws_elems`` f32) and the
    counters (at least ``counters`` int32, all 0) of one stream, made with
    ``torch.empty`` / ``torch.zeros`` at first use and grown as needed.
    Launches on one stream run in order, and each leaves every counter at
    0, so the paged and the dense kernel share both."""
    ws, cnt = _SCRATCH.get((dev, stream), (None, None))
    if ws is None or ws.numel() < ws_elems:
        ws = torch.empty(max(ws_elems, 1 << 16), dtype=torch.float32, device=dev)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(max(counters, 1024), dtype=torch.int32, device=dev)
    _SCRATCH[(dev, stream)] = ws, cnt
    return ws.data_ptr(), cnt.data_ptr()


def int32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous int32, without a call where it already is."""
    return t if t.dtype == torch.int32 and t.is_contiguous() else t.to(torch.int32).contiguous()
