"""Paged KV cache: a shared page pool, per-slot page tables and paged decode
attention.

The PyTorch counterpart of `flasht5_tpu/inference/paged_kv.py`. A slot's
decoder K/V live in fixed-size pages of a pool shared by all slots, so
memory scales with the tokens in flight, not with slots x the worst-case
length.

    pages_k, pages_v: (num_pages, H, page_size, D)   f32/bf16, or int8 with
                      per-token scales (num_pages, H, page_size, 1)
    page_table:       (max_slots, max_pages_per_slot) page ids
    lengths:          (max_slots,) tokens written per slot

The fused record keeps K and V of a page together, as the JAX package's
fused layout does at packing factor 1: values (N, 2, H, P, D) and scales
(N, 2, H, P), plane 0 K and plane 1 V (`pack_kv_pages_fused`). The TPU's
token packing (f = 128 // D tokens per 128-lane row) exists only for its
DMA tiling and is not kept; a JAX pool in that layout is carried across with
`unpack_kv_pages`.

Every paged attention function here (`paged_decode_attention_arrays`,
`_ragged`, `_chunked`, `_chunked_packed`, `paged_decode_attention`) computes
the same function and reaches one CUDA kernel for CUDA tensors
(`ops.paged_attention`, `csrc/paged_decode_attention.cu`) and its plain
version for CPU tensors. The JAX package's work lists (the ragged list of
live pages, `build_chunked_worklist`) order a sequential TPU grid and are
not ported: on the card each CTA finds its own pages through the table.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.ops.paged_attention import (_NEG_INF, gather_pages,
                                                   paged_attention)
from flasht5_tpu_torch.ops.quant import quantize_kv


# ---------------------------------------------------------------------------
# Pool + allocator
# ---------------------------------------------------------------------------

class PageAllocator:
    """Host free-list allocator over a host page table (max_slots,
    max_pages_per_slot) int32: a slot takes pages from the free list as it
    grows and gives them all back when released. A released slot's row
    keeps its old page ids; readers bound it by the slot's length.

    With `shards` data ranks (the sharded paged engine, JAX
    `sharded_paged_engine.py:58-104`) each rank's slots take LOCAL page
    ids 0..num_pages-1 of that rank's own pool from its own free list;
    every rank keeps all the lists, so their decisions agree."""

    def __init__(self, num_pages: int, max_slots: int,
                 max_pages_per_slot: int, shards: int = 1):
        self.table = np.zeros((max_slots, max_pages_per_slot), np.int32)
        self.free_lists: List[List[int]] = [list(range(num_pages))
                                            for _ in range(shards)]
        self.owned: List[List[int]] = [[] for _ in range(max_slots)]
        self._slots_per_shard = max_slots // shards

    @property
    def free(self) -> List[int]:
        """The free list (of shard 0, the only one without sharding)."""
        return self.free_lists[0]

    @free.setter
    def free(self, pages: List[int]) -> None:
        self.free_lists[0] = pages

    def shard_of(self, slot: int) -> int:
        return slot // self._slots_per_shard

    def can_allocate(self, slot: int, tokens: int, page_size: int) -> bool:
        need = -(-tokens // page_size) - len(self.owned[slot])
        return need <= len(self.free_lists[self.shard_of(slot)])

    def alloc_page(self, slot: int) -> int:
        free = self.free_lists[self.shard_of(slot)]
        if not free:
            raise RuntimeError("KV page pool exhausted"
                               + (f" (shard {self.shard_of(slot)})"
                                  if len(self.free_lists) > 1 else ""))
        page = free.pop()
        self.table[slot, len(self.owned[slot])] = page
        self.owned[slot].append(page)
        return page

    def ensure_capacity(self, slot: int, tokens: int, page_size: int):
        while len(self.owned[slot]) * page_size < tokens:
            self.alloc_page(slot)

    def release(self, slot: int):
        self.free_lists[self.shard_of(slot)].extend(self.owned[slot])
        self.owned[slot] = []


class PagedKVPool:
    """Device page pool with a host-side free-list allocator. `append`
    writes the pool, the page table and the lengths in place."""

    def __init__(self, num_pages: int, num_heads: int, page_size: int,
                 head_dim: int, max_slots: int, max_pages_per_slot: int,
                 dtype=torch.float32, quantized: bool = False, device=None):
        dev = runtime.resolve_device(device)
        self.page_size = page_size
        self.quantized = quantized
        store = torch.int8 if quantized else dtype
        shape = (num_pages, num_heads, page_size, head_dim)
        self.pages_k = torch.zeros(shape, dtype=store, device=dev)
        self.pages_v = torch.zeros_like(self.pages_k)
        if quantized:
            self.scales_k = torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                        device=dev)
            self.scales_v = torch.zeros_like(self.scales_k)
        else:
            self.scales_k = self.scales_v = None
        self.allocator = PageAllocator(num_pages, max_slots,
                                       max_pages_per_slot)
        # the device copy of the allocator's table, row by row as it grows
        self.page_table = torch.zeros((max_slots, max_pages_per_slot),
                                      dtype=torch.int32, device=dev)
        self.lengths = torch.zeros((max_slots,), dtype=torch.int32,
                                   device=dev)

    # -- host-side allocation --
    def alloc_page(self, slot: int) -> int:
        page = self.allocator.alloc_page(slot)
        self._ship_row(slot)
        return page

    def ensure_capacity(self, slot: int, tokens: int):
        try:
            self.allocator.ensure_capacity(slot, tokens, self.page_size)
        finally:
            self._ship_row(slot)     # the pages taken before an exhaustion

    def release(self, slot: int):
        self.allocator.release(slot)
        self.lengths[slot] = 0

    def _ship_row(self, slot: int):
        self.page_table[slot] = torch.from_numpy(self.allocator.table[slot])

    # -- device-side append --
    def append(self, slot_ids: torch.Tensor, k_new: torch.Tensor,
               v_new: torch.Tensor):
        """Append one token's K/V (B, H, D) for each of the (distinct) slots
        `slot_ids` (B,), at their current lengths (ensure_capacity first)."""
        slot_ids = slot_ids.long()
        pos = self.lengths[slot_ids].long()
        page_ids = self.page_table[slot_ids, pos // self.page_size].long()
        offset = pos % self.page_size
        for vals, scales, new in ((self.pages_k, self.scales_k, k_new),
                                  (self.pages_v, self.scales_v, v_new)):
            if self.quantized:
                new, s = quantize_kv(new)
                scales[page_ids, :, offset] = s
            vals[page_ids, :, offset] = new.to(vals.dtype)
        self.lengths[slot_ids] += 1


# ---------------------------------------------------------------------------
# Reference
# ---------------------------------------------------------------------------

def paged_decode_attention_ref(q, pool: PagedKVPool, *, sm_scale=1.0,
                               bias=None):
    """Oracle: gather each slot's pages densely, dequantize, run masked
    attention. q: (max_slots, H, D); bias: (max_slots, H, maxp * P)."""
    k = gather_pages(pool.pages_k, pool.page_table).float()
    v = gather_pages(pool.pages_v, pool.page_table).float()
    if pool.quantized:
        k = k * gather_pages(pool.scales_k, pool.page_table)
        v = v * gather_pages(pool.scales_v, pool.page_table)
    s = torch.einsum("bhd,bhld->bhl", q.float(), k) * sm_scale
    if bias is not None:
        s = s + bias.float()
    pos = torch.arange(k.shape[2], device=q.device)
    s = torch.where(pos[None, None, :] < pool.lengths[:, None, None], s,
                    _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhl,bhld->bhd", p, v).to(q.dtype)


def gather_pool_dense(pages_kv, scales_kv, page_table, *, dequant=True):
    """Gather a fused page pool into slot-dense (B, H, maxp * P, D) K and V
    caches (the slot engine's layout). dequant=True returns f32 (kf, vf);
    dequant=False returns ((k_vals, k_scales), (v_vals, v_scales)) in the
    pool's dtype, scales (B, H, maxp * P, 1) or None."""
    planes = []
    for i in (0, 1):
        vals = gather_pages(pages_kv[:, i], page_table)
        scales = (None if scales_kv is None
                  else gather_pages(scales_kv[:, i], page_table)[..., None])
        planes.append((vals, scales))
    if not dequant:
        return tuple(planes)
    return tuple(v.float() if s is None else v.float() * s
                 for v, s in planes)


def dense_cache_attention(q, kf, vf, lengths, *, sm_scale=1.0, bias=None,
                          return_state=False):
    """Masked single-query attention over a dense f32 (B, H, maxL, D) cache;
    the (out[, m, l]) contract of `paged_decode_attention_chunked_packed`."""
    s = torch.einsum("bhd,bhnd->bhn", q.float(), kf) * sm_scale
    if bias is not None:
        s = s + bias.float()
    tok = torch.arange(kf.shape[2], device=q.device)
    mask = tok[None, None, :] < lengths[:, None, None]
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.where(m > _NEG_INF / 2, m, 0.0)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = (torch.einsum("bhn,bhnd->bhd", p, vf)
         / torch.clamp(l, min=1e-30)[..., None])
    out = o.to(q.dtype)
    if not return_state:
        return out
    return out, torch.where(l > 0, m_safe, _NEG_INF), l


def dense_small_pool_attention(q, pages_kv, scales_kv, page_table, lengths,
                               *, sm_scale: float = 1.0, bias=None,
                               return_state: bool = False):
    """Single-query attention over a fused page pool read with one gather
    instead of the paged kernel (JAX paged_kv.py:652, the paged engine's
    `dense_read_max` opt-in): `gather_pool_dense`, then
    `dense_cache_attention`; the same (out[, m, l]) contract as
    `paged_decode_attention_chunked_packed`. Plain PyTorch, as it is plain
    XLA in the JAX package."""
    kf, vf = gather_pool_dense(pages_kv, scales_kv, page_table)
    return dense_cache_attention(q, kf, vf, lengths, sm_scale=sm_scale,
                                 bias=bias, return_state=return_state)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def pack_kv_pages_fused(pages_k, pages_v, scales_k=None, scales_v=None):
    """Fuse standard-layout K and V pools (and their scales) into one record
    per page: values (N, 2, H, P, D), scales (N, 2, H, P) or None. This is
    the JAX package's fused layout at packing factor 1."""
    pages_kv = torch.stack([pages_k, pages_v], dim=1)
    scales_kv = (None if scales_k is None
                 else torch.stack([scales_k[..., 0], scales_v[..., 0]], dim=1))
    return pages_kv, scales_kv


def unpack_kv_pages(pages, scales=None, *, head_dim: int):
    """A pool in the TPU's token-packed layout (`pack_kv_pages` of the JAX
    package: (N, H, P // f, f * D) values, (N, f, H * P // f) scales, f
    tokens per row) back in the standard layout: (N, H, P, D) values and
    (N, H, P, 1) scales or None."""
    n, h, pp, fd = pages.shape
    f = fd // head_dim
    vals = pages.reshape(n, h, pp * f, head_dim)
    if scales is None:
        return vals, None
    # scales[p, j, h * pp + r] scales token r * f + j of head h
    s = scales.reshape(n, f, h, pp).permute(0, 2, 3, 1)
    return vals, s.reshape(n, h, pp * f, 1)


def _scale_plane(scales):
    """(N, H, P, 1) standard scales -> the kernel's (N, H, P) view."""
    return None if scales is None else scales[..., 0]


# ---------------------------------------------------------------------------
# Paged decode attention
# ---------------------------------------------------------------------------

def paged_decode_attention_arrays(q, pages_k, pages_v, scales_k, scales_v,
                                  page_table, lengths, *,
                                  sm_scale: float = 1.0,
                                  bias: Optional[torch.Tensor] = None):
    """Paged decode over a standard-layout pool. q: (max_slots, H, D);
    bias: (max_slots, H, max_pages * page_size) or None."""
    return paged_attention(q, pages_k, pages_v, _scale_plane(scales_k),
                           _scale_plane(scales_v), page_table, lengths,
                           sm_scale=sm_scale, bias=bias)


# The TPU's ragged form differs from the (slot, page) grid only in the order
# of its grid (a work list of live pages); on the card both are one kernel.
paged_decode_attention_ragged = paged_decode_attention_arrays


def paged_decode_attention_chunked_packed(q, pages_kv, scales_kv, page_table,
                                          lengths, *, sm_scale: float = 1.0,
                                          bias: Optional[torch.Tensor] = None,
                                          return_state: bool = False):
    """Paged decode over a fused pool (`pack_kv_pages_fused` layout).
    `return_state` also returns each (slot, head)'s softmax state (m, l),
    (B, H) f32, so a caller can LSE-merge this output with attention over
    tokens not yet in the pool."""
    return paged_attention(
        q, pages_kv[:, 0], pages_kv[:, 1],
        None if scales_kv is None else scales_kv[:, 0],
        None if scales_kv is None else scales_kv[:, 1],
        page_table, lengths, sm_scale=sm_scale, bias=bias,
        return_state=return_state)


def paged_decode_attention_chunked(q, pages_k, pages_v, scales_k, scales_v,
                                   page_table, lengths, *,
                                   sm_scale: float = 1.0,
                                   bias: Optional[torch.Tensor] = None):
    """Standard-layout convenience form of the fused one: fuses the pool
    (a copy of it) and runs `paged_decode_attention_chunked_packed`."""
    pages_kv, scales_kv = pack_kv_pages_fused(pages_k, pages_v, scales_k,
                                              scales_v)
    return paged_decode_attention_chunked_packed(
        q, pages_kv, scales_kv, page_table, lengths, sm_scale=sm_scale,
        bias=bias)


def paged_decode_attention(q, pool: PagedKVPool, *, sm_scale: float = 1.0,
                           bias: Optional[torch.Tensor] = None):
    """Paged decode attention over a PagedKVPool (host object API)."""
    return paged_decode_attention_arrays(
        q, pool.pages_k, pool.pages_v, pool.scales_k, pool.scales_v,
        pool.page_table, pool.lengths, sm_scale=sm_scale, bias=bias)
