"""Page-walk primitives — the single source of the paged-KV layout contract.

Token ``t`` of a sequence lives at ``(tables[b, t // ps], t % ps)`` in a
``(P, ps, ...)`` page pool. The model decode paths, the engine's batched
prefill insertion and the plain version of the paged-attention kernel
all go through here. The scatters write into the pool in place.
"""

from __future__ import annotations

import torch

__all__ = ["gather_pages", "scatter_token", "scatter_prefill", "TRASH_PAGE"]

# page 0 is never allocated: unused block-table entries name it, and
# idle decode slots harmlessly write their dead token into it
TRASH_PAGE = 0


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(P, ps, ...) pool + (B, maxp) tables -> dense (B, maxp*ps, ...)."""
    B, maxp = block_tables.shape
    ps = pages.shape[1]
    return pages[block_tables.long()].reshape((B, maxp * ps) + tuple(pages.shape[2:]))


def scatter_token(pages, values, page_ids, offsets):
    """Write one token per sequence in place: values (B, ...) at
    (page, offset). Idle sequences parked on the trash page may collide;
    live (page, offset) pairs are disjoint because chains never share
    pages."""
    pages[page_ids.long(), offsets.long()] = values.to(pages.dtype)
    return pages


def scatter_prefill(pages, values, block_tables, lengths):
    """Write prompt K/V into chains in place: layer-stacked pages
    (L, P, ps, ...) and values (L, B, S, ...); tokens [0, lengths[b]) of
    row b land at (tables[b, t//ps], t%ps); pad positions are dumped on
    the trash page."""
    L, B, S = values.shape[:3]
    ps = pages.shape[2]
    t = torch.arange(S, dtype=torch.int64, device=pages.device)
    page_slot = torch.clamp(t // ps, max=block_tables.shape[1] - 1)
    pid = block_tables.long()[:, page_slot]                   # (B, S)
    valid = t[None, :] < lengths.long()[:, None]
    pid = torch.where(valid, pid, TRASH_PAGE)
    off = torch.where(valid, t[None, :] % ps, 0)
    flat = values.reshape((L, B * S) + tuple(values.shape[3:]))
    pages[:, pid.reshape(-1), off.reshape(-1)] = flat.to(pages.dtype)
    return pages
