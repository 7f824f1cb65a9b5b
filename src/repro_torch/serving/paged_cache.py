"""Block-paged KV cache: free-list page allocator + shared block storage.

The KV cache is a shared pool of ``num_pages`` pages of ``page_size``
tokens, stored layer-stacked as ``(L, P, ps, Hkv, hd)`` (bf16 / f32, or
int8 / float8 e4m3 codes with ``(L, P, ps, Hkv)`` f32 scales). Each in-flight request owns
a chain of pages handed out by the host-side ``PageAllocator``; token
``t`` lives at ``(chain[t // ps], t % ps)``. Unused block-table entries
point at the reserved trash page 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..kernels.paging import TRASH_PAGE, scatter_prefill
from ..models.transformer import SCALED_KV

__all__ = ["PageAllocator", "pages_needed", "init_paged_kv", "paged_insert",
           "TRASH_PAGE"]


def pages_needed(num_tokens: int, page_size: int) -> int:
    """Pages required to hold ``num_tokens`` cache positions."""
    return max(0, -(-num_tokens // page_size))


class PageAllocator:
    """Host-side free-list allocator over the shared page pool.

    Pages are ints in ``[reserved, capacity)``; ids below ``reserved``
    (the trash page) are never handed out. Freeing a page that is not in
    use, or allocating beyond capacity, raises.
    """

    def __init__(self, capacity: int, reserved: int = 1):
        if capacity <= reserved:
            raise ValueError(f"capacity {capacity} must exceed reserved {reserved}")
        self.capacity = capacity
        self.reserved = reserved
        self._free: List[int] = list(range(reserved, capacity))
        self._in_use: set = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return len(self._in_use)

    def can_alloc(self, n: int) -> bool:
        return n <= self.num_free

    def alloc_chain(self, n: int) -> List[int]:
        """Allocate ``n`` pages; returns the chain in token order."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > self.num_free:
            raise MemoryError(f"paged KV cache exhausted: need {n} pages, "
                              f"{self.num_free}/{self.capacity - self.reserved} free")
        chain = self._free[:n]
        del self._free[:n]
        self._in_use.update(chain)
        return chain

    def try_alloc_chain(self, n: int) -> Optional[List[int]]:
        """``alloc_chain`` that returns ``None`` on a shortage instead of
        raising: the engine's on-demand growth turns a shortage into a
        preemption, never into a MemoryError out of the serving loop."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > self.num_free:
            return None
        return self.alloc_chain(n)

    def free_chain(self, chain: Sequence[int]) -> None:
        """Return a request's pages to the free list."""
        chain = list(chain)
        if len(set(chain)) != len(chain):
            raise ValueError(f"chain contains duplicate pages: {chain}")
        for p in chain:
            if p not in self._in_use:
                raise ValueError(f"double free / foreign page {p}")
        for p in chain:
            self._in_use.remove(p)
        self._free.extend(chain)

    def check(self) -> None:
        """Invariant: every page is free xor in-use, exactly once."""
        assert len(self._free) == len(set(self._free))
        assert not set(self._free) & self._in_use
        assert len(self._free) + len(self._in_use) == self.capacity - self.reserved


def init_paged_kv(num_layers: int, num_pages: int, page_size: int,
                  num_kv_heads: int, head_dim: int, kv_dtype: str = "bf16",
                  device="cuda"):
    """Shared paged K/V storage leaves, layer-stacked: (L, P, ps, Hkv, hd)
    [+ (L, P, ps, Hkv) f32 scales for int8 / fp8]. fp8 pages keep the int8
    layout with float8 storage under the keys "k" / "v", so a pool is fp8
    when it has "k_scales" and no "k_codes" (as the dense caches)."""
    shape = (num_layers, num_pages, page_size, num_kv_heads, head_dim)
    if kv_dtype in SCALED_KV:
        dt, sfx, _ = SCALED_KV[kv_dtype]
        return {f"k{sfx}": torch.zeros(shape, dtype=dt, device=device),
                "k_scales": torch.zeros(shape[:-1], device=device),
                f"v{sfx}": torch.zeros(shape, dtype=dt, device=device),
                "v_scales": torch.zeros(shape[:-1], device=device)}
    if kv_dtype not in ("bf16", "f32"):
        raise ValueError(f"paged KV storage supports bf16|f32|int8|fp8, got {kv_dtype!r}")
    dt = torch.bfloat16 if kv_dtype == "bf16" else torch.float32
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


_CROSS_KEYS = ("cross_k", "cross_v", "cross_k_codes", "cross_k_scales",
               "cross_v_codes", "cross_v_scales")
_SELF_KEYS = ("k", "v", "k_codes", "k_scales", "v_codes", "v_scales")


def paged_insert(cache, mini, slot_ids, page_rows, lengths):
    """Commit a dense prefill mini-cache into the paged batch cache, in
    place: self-attention KV scatters into the page chains named by
    ``page_rows`` (n, maxp), an enc-dec mini-cache's cross-attention
    leaves splice into the per-slot dense cross buffers at ``slot_ids``
    (n,) (an LM's has none), and the block table / length / active rows
    go live."""
    slots = slot_ids.long()
    for key in _SELF_KEYS:
        if key in cache and key in mini:
            scatter_prefill(cache[key], mini[key], page_rows, lengths)
    for key in _CROSS_KEYS:
        if key in cache and key in mini:
            se = mini[key].shape[2]
            cache[key][:, slots, :se] = mini[key].to(cache[key].dtype)
    if "cross_len" in cache:
        cache["cross_len"][slots] = mini["cross_len"]
    cache["block_tables"][slots] = page_rows.to(torch.int32)
    cache["len"][slots] = lengths.to(torch.int32)
    cache["active"][slots] = 1
    return cache
