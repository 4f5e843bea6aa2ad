"""Paged KV allocation (counterpart of ``ray_lightning_tpu/serve/pages.py``).

:class:`PagePool` backs each request's logical KV with fixed-size
**pages** cut from one arena per layer
(:class:`~ray_lightning_tpu_torch.models.transformer.PagedKV`:
``(num_pages + 1, page_size, H, D)`` for K and for V, the last page
being the write sink; int8 arenas add ``(num_pages + 1, 1, H, 1)`` f32
scales), tracked by a per-slot **page table** -- a host
``(num_slots, pages_per_slot)`` int32 array, −1 = unmapped. A request
holds ``ceil((prompt + budget) / page_size)`` pages from admission to
retirement, so an admitted request can never run the arena dry.

All allocation decisions are host-side, exact and deterministic:
lowest-index-first for both slots and pages (fresh pages come off the
front of the free list, freed ones return by ``insort``), so identical
op sequences give the JAX package's page tables entry for entry.

:class:`PrefixCache` (a copy of the JAX package's) adds shared-prefix
reuse: prompt prefixes are content-keyed at page granularity (chain
links ``(parent_entry_id, page_tokens)``), and a request whose prompt
extends a cached chain adopts those pages **read-only** (refcounted)
instead of prefilling them again. The cache holds its own reference on
every published page, so a retired publisher keeps its prefix warm;
eviction under pressure drops least-recently-matched entries whose page
only the cache still holds.

Two storage round trips serve the engine's dense programs (JAX's names
and arithmetic): :func:`gather_pages` / :func:`scatter_pages` build the
dense per-slot view of the arena and write it back (the dense-view
paged step, ``page_native=False``), and :func:`quantize_dense_cache` /
:func:`dense_storage_values` / :func:`dense_storage_commit` hold the
dense slot pool (``page_size=None``) as int8 codes with one f32 scale
per (slot, position, head), dequantized for a dispatch and re-quantized
whole after it.
"""
from __future__ import annotations

import dataclasses
from bisect import insort
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.models.quant import (kv_dequantize,
                                                  kv_quantize, kv_scales)
from ray_lightning_tpu_torch.models.transformer import (DenseKV, PagedKV,
                                                        TransformerConfig,
                                                        new_arena)
from ray_lightning_tpu_torch.serve.request import OccupancyError, Request

#: accepted ``kv_dtype`` spellings: None/"bf16" = store KV at the model's
#: compute dtype; "int8" = absmax-scaled int8 codes with per-page-per-head
#: f32 scales (storage only: compute stays at cfg.dtype)
KV_DTYPE_INT8 = "int8"


def check_kv_dtype(kv_dtype) -> bool:
    """Normalize/validate a ``kv_dtype`` option; returns True for the
    quantized path."""
    if kv_dtype in (None, "bf16"):
        return False
    if kv_dtype == KV_DTYPE_INT8:
        return True
    raise ValueError(
        f"kv_dtype must be None, 'bf16' or 'int8', got {kv_dtype!r}")


# ------------------------------------------------------- dense int8 KV
@dataclasses.dataclass
class QuantizedDenseKV:
    """One layer of int8 dense storage: ``key``/``value`` codes
    (num_slots, max_seq_len, H, D) and ``key_scale``/``value_scale``
    (num_slots, max_seq_len, H, 1) f32 absmax scales, one per (slot,
    position, head)."""
    key: torch.Tensor
    value: torch.Tensor
    key_scale: torch.Tensor
    value_scale: torch.Tensor


#: dense pool granularity: per (slot, position, head) -- the head_dim
#: axis alone is reduced
_DENSE_AXES = (3,)


def quantize_dense_cache(cache: Sequence[DenseKV]) -> List[QuantizedDenseKV]:
    """Plain dense caches -> int8 dense storage."""
    out = []
    for kv in cache:
        ks = kv_scales(kv.key, _DENSE_AXES)
        vs = kv_scales(kv.value, _DENSE_AXES)
        out.append(QuantizedDenseKV(kv_quantize(kv.key, ks),
                                    kv_quantize(kv.value, vs), ks, vs))
    return out


def dense_storage_values(storage, dtype: torch.dtype) -> List[DenseKV]:
    """The compute-dtype caches a dispatch runs on: the storage itself
    when it is plain (writes land in place), else the dequantized
    codes."""
    if not storage or isinstance(storage[0], DenseKV):
        return storage
    return [DenseKV(kv_dequantize(kv.key, kv.key_scale, dtype),
                    kv_dequantize(kv.value, kv.value_scale, dtype))
            for kv in storage]


def dense_storage_commit(storage, values: Sequence[DenseKV]) -> None:
    """Write a dispatch's caches back into int8 storage: the whole pool
    re-quantized with fresh scales, in place (plain storage already holds
    them). Untouched rows come back with their codes, and with their
    scales up to the rounding of ``absmax / 127`` of a dequantized
    group."""
    if not storage or isinstance(storage[0], DenseKV):
        return
    for kv, new in zip(storage, values):
        for codes, scales, x in ((kv.key, kv.key_scale, new.key),
                                 (kv.value, kv.value_scale, new.value)):
            ns = kv_scales(x, _DENSE_AXES)
            codes.copy_(kv_quantize(x, ns))
            scales.copy_(ns)


# ------------------------------------------------ arena gather / scatter
def gather_pages(arena: Sequence[PagedKV], page_table: torch.Tensor,
                 dtype: torch.dtype) -> List[DenseKV]:
    """The dense per-slot view of the arena: ``page_table`` (S, pp) ->
    one ``DenseKV`` per layer, (S, pp * page_size, H, D) in ``dtype``.
    Unmapped (−1) entries clamp to page 0: finite bytes the per-row
    position mask never admits and the scatter never writes back. int8
    pages dequantize inside the gather."""
    S, pp = page_table.shape
    idx = page_table.clamp_min(0).reshape(-1).long()
    view = []
    for kv in arena:
        rows = []
        for store, scales in ((kv.k, kv.k_scale), (kv.v, kv.v_scale)):
            pages = store[idx]
            pages = (pages.to(dtype) if scales is None
                     else kv_dequantize(pages, scales[idx], dtype))
            rows.append(pages.reshape(S, pp * pages.shape[1],
                                      *pages.shape[2:]))
        view.append(DenseKV(*rows))
    return view


def scatter_pages(arena: Sequence[PagedKV], view: Sequence[DenseKV],
                  page_table: torch.Tensor) -> None:
    """Write each row of a dense per-slot view (one ``DenseKV`` per
    layer, (B, pages_per_slot * page_size, H, D)) into its arena pages,
    in place: the inverse of :func:`gather_pages`. ``page_table`` (B,
    pages_per_slot) maps the row's page columns to arena pages; −1
    entries go to the sink (the prefill's padding rows, a step's
    write-masked inactive rows). Pages two rows share receive the same
    values from both. int8 arenas quantize each page with its own
    per-head absmax scales."""
    B, pp = page_table.shape
    for kv, dense in zip(arena, view):
        idx = torch.where(page_table >= 0, page_table,
                          kv.num_pages).reshape(-1).long()
        ps = kv.k.shape[1]
        for store, scales, values in ((kv.k, kv.k_scale, dense.key),
                                      (kv.v, kv.v_scale, dense.value)):
            pages = values.reshape(B * pp, ps, *values.shape[2:])
            if scales is None:
                store[idx] = pages.to(store.dtype)
                continue
            ns = kv_scales(pages, (1, 3))
            store[idx] = kv_quantize(pages, ns)
            scales[idx] = ns


class SlotPoolFull(OccupancyError):
    """No free KV slot, or not enough free pages -- admission control
    should have prevented this."""

    def __init__(self, message: str, *, slots_free: Optional[int] = None,
                 pages_free: Optional[int] = None,
                 pages_needed: Optional[int] = None,
                 active: Optional[int] = None, **ctx):
        super().__init__(message, slots_free=slots_free,
                         pages_free=pages_free, pages_needed=pages_needed,
                         active=active, **ctx)


def check_seed_free(active_requests: Dict[int, Request],
                    request: Request) -> None:
    """Two co-resident slots may never carry the same sampling seed
    (their per-step noise streams would collide token-for-token)."""
    for req in active_requests.values():
        if req.seed == request.seed:
            raise ValueError(
                f"sampling-seed reuse across slots: request {request.id} "
                f"and in-flight request {req.id} share seed "
                f"{request.seed} -- co-resident sample streams would "
                "collide; give one an explicit distinct seed")


class PagePool:
    """Owns the paged KV arena and the slot -> pages mapping."""

    def __init__(self, cfg: TransformerConfig, num_slots: int,
                 page_size: int, num_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 device: Optional[torch.device] = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if cfg.max_seq_len % page_size != 0:
            raise ValueError(
                f"page_size ({page_size}) must divide max_seq_len "
                f"({cfg.max_seq_len}) -- the page table tiles the whole "
                "sequence axis")
        self.kv_dtype = kv_dtype
        quantized = check_kv_dtype(kv_dtype)
        self.page_size = page_size
        self.pages_per_slot = cfg.max_seq_len // page_size
        self.num_pages = (num_pages if num_pages is not None
                          else num_slots * self.pages_per_slot)
        if self.num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got "
                             f"{self.num_pages}")
        self.num_slots = num_slots
        self.page_table = np.full((num_slots, self.pages_per_slot), -1,
                                  np.int32)
        self.arena: List[PagedKV] = new_arena(cfg, self.num_pages,
                                              page_size, quantized, device)
        self._free_pages: List[int] = list(range(self.num_pages))
        self._free_slots: List[int] = list(range(num_slots))
        self._ref = np.zeros((self.num_pages,), np.int64)
        self._requests: Dict[int, Request] = {}   # slot -> request
        self._span: Dict[int, int] = {}           # slot -> mapped pages

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def active(self) -> Dict[int, Request]:
        return dict(self._requests)

    def slot_of(self, request_id: int) -> Optional[int]:
        for slot, req in self._requests.items():
            if req.id == request_id:
                return slot
        return None

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def refcounts(self, pages: np.ndarray) -> np.ndarray:
        """Refcounts of ``pages`` in one vectorized read (the prefix
        cache's evictable-count probe runs on every scheduling tick)."""
        return self._ref[pages]

    def pages_needed(self, request: Request) -> int:
        """Pages for one request: its prompt plus its whole token budget,
        allocated up front at admission."""
        total = request.prompt_len + request.max_new_tokens
        return -(-total // self.page_size)

    def acquire(self, request: Request,
                prefix_pages: Sequence[int] = ()) -> int:
        """Assign the lowest free slot and allocate its pages.
        ``prefix_pages`` are already-filled pages adopted read-only from
        a :class:`PrefixCache` chain (refcount bumped here); the rest
        come fresh from the free list, lowest index first."""
        if not self._free_slots:
            raise SlotPoolFull(
                f"all {self.num_slots} KV slots in use",
                slots_free=0, pages_free=self.free_pages,
                active=len(self._requests))
        check_seed_free(self._requests, request)
        need = self.pages_needed(request)
        fresh_need = need - len(prefix_pages)
        # adoption is capped below the full prompt (the engine always
        # recomputes at least the final prompt token into a private page)
        if fresh_need < 1:
            raise ValueError(
                f"request {request.id} adopts {len(prefix_pages)} prefix "
                f"pages of its {need}: at least one page must be its own")
        if fresh_need > len(self._free_pages):
            raise SlotPoolFull(
                f"request {request.id} needs {fresh_need} free KV "
                f"pages ({need} total, {len(prefix_pages)} from prefix "
                f"cache) but only {len(self._free_pages)} are free",
                slots_free=self.free_slots, pages_free=self.free_pages,
                pages_needed=fresh_need, active=len(self._requests))
        slot = self._free_slots.pop(0)
        fresh = self._free_pages[:fresh_need]
        del self._free_pages[:fresh_need]
        row = list(prefix_pages) + fresh
        self.page_table[slot, :] = -1
        self.page_table[slot, :len(row)] = row
        for p in prefix_pages:
            self._ref[p] += 1
        for p in fresh:
            self._ref[p] = 1
        self._requests[slot] = request
        self._span[slot] = len(row)
        return slot

    def release(self, slot: int) -> Request:
        """Retire a slot: decref its pages (shared prefix pages survive
        while the cache or another adopter still holds them), clear its
        page-table row, return the request."""
        req = self._requests.pop(slot)
        for j in range(self._span.pop(slot)):
            self.decref(int(self.page_table[slot, j]))
        self.page_table[slot, :] = -1
        insort(self._free_slots, slot)
        return req

    def incref(self, page: int) -> None:
        self._ref[page] += 1

    def decref(self, page: int) -> None:
        if self._ref[page] < 1:
            raise RuntimeError(f"page {page} released more often than held")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            insort(self._free_pages, page)


class PrefixCache:
    """Content-keyed reuse of prompt-prefix KV pages (a copy of the JAX
    package's).

    Entries are keyed by **chain links**: page ``j``'s key is
    ``(parent_entry_id, tokens of page j)``, where the parent is page
    ``j-1``'s entry (id 0 = the empty root), so a key is O(page_size)
    and still names the whole preceding prefix. Ids are assigned in
    publish order and never reused (an evicted middle entry orphans its
    children, which age out through the same LRU eviction).

    The cache holds one page refcount per entry. ``match`` walks the
    longest cached chain for a new prompt (LRU-touching each hit),
    ``publish`` caches a finished prefill's full-prompt pages, and
    ``evict`` frees least-recently-matched entries whose page nobody
    else holds. The engine records hit statistics at admission
    (``record_admission``), after slot and page acquisition succeed, so
    ``hits`` counts pages actually adopted.

    Adoption is capped one token short of the whole prompt: the final
    prompt token must be recomputed (its logits seed the first sample)
    into a private page.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        # (parent_id, page_tokens) -> (entry_id, arena page)
        self._entries: "OrderedDict[Tuple[int, Tuple[int, ...]], " \
            "Tuple[int, int]]" = OrderedDict()
        self._next_id = 1    # 0 is the empty-prefix root
        self._pages_arr = np.empty((0,), np.int64)  # cached entry pages
        self._pages_dirty = False
        self.hits = 0        # pages adopted by admissions
        self.lookups = 0     # pages that were eligible for adoption
        self.publishes = 0   # pages added to the cache
        self.evictions = 0   # pages dropped under pressure

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest chain of cached pages covering a strict prefix of
        ``tokens``; every hit page is LRU-touched."""
        ps = self.pool.page_size
        usable = max(0, (len(tokens) - 1) // ps)
        pages: List[int] = []
        parent = 0
        for j in range(usable):
            key = (parent, tuple(tokens[j * ps:(j + 1) * ps]))
            entry = self._entries.get(key)
            if entry is None:
                break
            parent, page = entry
            pages.append(page)
            self._entries.move_to_end(key)
        return pages

    def record_admission(self, eligible: int, adopted: int) -> None:
        """Count one admission's prefix reuse: ``eligible`` pages could
        have come from cache, ``adopted`` actually did."""
        self.lookups += eligible
        self.hits += adopted

    def publish(self, prompt: Sequence[int], slot: int) -> int:
        """Cache every page of ``slot`` wholly covered by ``prompt``
        (their KV is fully written once its prefill completed). Returns
        the number of newly cached pages."""
        pool = self.pool
        ps = pool.page_size
        added = 0
        parent = 0
        for j in range(len(prompt) // ps):
            key = (parent, tuple(prompt[j * ps:(j + 1) * ps]))
            entry = self._entries.get(key)
            if entry is not None:
                parent = entry[0]
                continue
            page = int(pool.page_table[slot, j])
            entry_id = self._next_id
            self._next_id += 1
            self._entries[key] = (entry_id, page)
            pool.incref(page)
            parent = entry_id
            added += 1
        if added:
            self._pages_dirty = True
        self.publishes += added
        return added

    def evictable(self) -> int:
        """Pages the cache could free right now (refcount 1: only the
        cache still holds them), by one vectorized refcount read over
        the cached entry->page array."""
        if self._pages_dirty:
            self._pages_arr = np.fromiter(
                (p for _eid, p in self._entries.values()), np.int64,
                count=len(self._entries))
            self._pages_dirty = False
        if not len(self._pages_arr):
            return 0
        return int(np.count_nonzero(
            self.pool.refcounts(self._pages_arr) == 1))

    def evict(self, n: int, protect: Sequence[int] = ()) -> int:
        """Free up to ``n`` pages, least-recently-matched first, skipping
        entries still adopted by a live slot and ``protect``\\ ed pages
        (a chain the current admission is about to adopt)."""
        guard = set(protect)
        freed = 0
        for key, (_eid, page) in list(self._entries.items()):
            if freed >= n:
                break
            if page in guard or self.pool.refcount(page) != 1:
                continue
            del self._entries[key]
            self._pages_dirty = True
            self.pool.decref(page)
            freed += 1
            self.evictions += 1
        return freed

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def drop(self) -> None:
        """Release every cache-held page reference (engine shutdown)."""
        for _eid, page in self._entries.values():
            self.pool.decref(page)
        self._entries.clear()
        self._pages_dirty = True
