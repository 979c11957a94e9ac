"""Paged single-query decode attention: the kernel's wrapper and its plain
version.

`paged_attention` runs the CUDA kernel `csrc/paged_decode_attention.cu`,
which replaces the three Pallas kernels of
`flasht5_tpu/inference/paged_kv.py` (`_paged_kernel`, `_ragged_kernel`,
`_chunked_kernel`; its source and `csrc/single_query.cuh` say what bounds
it and how), on the split that `paged_plan` chooses from the shapes. The
public functions of that module, in both page layouts, are in
`flasht5_tpu_torch/inference/paged_kv.py`; all of them come here.

Layout: q (B, H, D); k_pages, v_pages (N, H, P, D) with rows of D contiguous
and the same strides (the standard pair of pools, or the two planes of the
fused record (N, 2, H, P, D)); k_scales, v_scales (N, H, P) f32 for int8
pools, likewise; page_table (B, maxp) page ids; lengths (B,) tokens per
slot; bias (B, H, maxp * P) f32. Returns out (B, H, D) in q's dtype and,
with `return_state`, the softmax state m, l (B, H) f32 of each (slot, head):
m = -1e30 and l = 0 for a slot of length 0, whose out is 0.

Head dims other than the kernel's 32, 64 and 128 (any D up to 128) are
zero-padded to the next of those, q and both pools, as
`decode_attention.padded_head` does: exact, the int8 scales unchanged, at
the cost of a copy of the pools a call (no shipped configuration takes
it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.ops.decode_attention import padded_head

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# the kernel's split (csrc/single_query.cuh)
_MAX_WARPS = 4           # warps a CTA, one share of pages each
_MAX_SPLITS = 8          # CTAs of a cluster (the portable size)
_TARGET_CTAS = 128       # about one CTA for each of the H100's 132 SMs
_WAVE_WARPS = 132 * 12   # warps the H100 holds at once at the kernel's
                         # 160-odd registers a thread


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """(N, H, P, ...) pages -> (B, H, maxp * P, ...) in each slot's token
    order."""
    b, maxp = page_table.shape
    g = pages[page_table.long()]                  # (B, maxp, H, P, ...)
    h, p = g.shape[2], g.shape[3]
    return g.transpose(1, 2).reshape(b, h, maxp * p, *g.shape[4:])


def paged_attention_plain(q, k_pages, v_pages, k_scales, v_scales,
                          page_table, lengths, *, sm_scale=1.0, bias=None,
                          return_state=False):
    """The kernel's arithmetic in plain PyTorch, over the gathered pages:
    q, k, P and v rounded to bf16 unless the pool is int8 or q and the pool
    are both f32; the k scales multiply the scores and the v scales fold
    into P; fp32 sums; one softmax maximum per slot (the kernel's running
    maximum a warp, merged at the end, gives the same sums to rounding)."""
    bf16 = not (k_pages.dtype == torch.int8
                or (q.dtype == torch.float32
                    and k_pages.dtype == torch.float32))

    def rnd(t):
        t = t.float()
        return t.to(torch.bfloat16).float() if bf16 else t

    s = torch.einsum("bhd,bhld->bhl", rnd(q),
                     rnd(gather_pages(k_pages, page_table)))
    if k_scales is not None:
        s = s * gather_pages(k_scales, page_table)
    s = s * sm_scale
    if bias is not None:
        s = s + bias.float()
    pos = torch.arange(s.shape[-1], device=q.device)
    valid = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    if v_scales is not None:
        p = p * gather_pages(v_scales, page_table)
    pv = torch.einsum("bhl,bhld->bhd", rnd(p),
                      rnd(gather_pages(v_pages, page_table)))
    out = (pv / torch.where(l > 0.0, l, 1.0)[..., None]).to(q.dtype)
    if not return_state:
        return out
    return out, torch.where(l > 0.0, m, _NEG_INF), l


@functools.lru_cache(maxsize=None)
def paged_plan(b: int, h: int, maxp: int) -> Tuple[int, int, int]:
    """(splits, warps, pages) of the kernel for b slots of h heads and
    page tables of maxp pages: each (slot, head) runs on a cluster of
    `splits` CTAs of `warps` warps, and warp `warp` of cluster rank `rank`
    owns the table entries from (rank * warps + warp) * pages, `pages` of
    them (whole pages: a share that ended inside a page would cut its runs
    into more, smaller copies). `splits` is the least power of two (at most
    8) that gives about one CTA an SM, as far as each CTA keeps two pages
    or more; `warps` (at most 4) cuts a CTA's pages again, halved while the
    grid would not fit on the card at once. The serving shape (8 slots of
    8 heads, 5 pages) runs on 128 CTAs of 3 warps of one page; 64 slots of
    16 pages on 512 CTAs of 2 warps of 8 pages. From shapes alone (the
    lengths live on the card), once per shape."""
    splits = 1
    while (splits < _MAX_SPLITS and b * h * splits < _TARGET_CTAS
           and maxp >= 4 * splits):
        splits *= 2
    warps = min(_MAX_WARPS, -(-maxp // splits))
    while warps > 1 and b * h * splits * warps > _WAVE_WARPS:
        warps //= 2
    return splits, warps, -(-maxp // (splits * warps))


def paged_pieces(b: int, h: int, maxp: int) -> List[Tuple[int, int]]:
    """The table entries [begin, end) of each warp's share, in the order
    the kernel merges them (cluster rank, then warp); the last ones may be
    short or empty."""
    splits, warps, pages = paged_plan(b, h, maxp)
    return [(min(maxp, u * pages), min(maxp, (u + 1) * pages))
            for u in range(splits * warps)]


def _lib():
    lib = runtime.kernel_library("paged_decode_attention")
    fn = lib.ft5_paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _aligned(t: torch.Tensor, strides) -> bool:
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in strides)


def paged_attention(q, k_pages, v_pages, k_scales, v_scales, page_table,
                    lengths, *, sm_scale: float = 1.0, bias=None,
                    return_state: bool = False):
    """Paged decode attention; see the module docstring. CUDA tensors go to
    the kernel, CPU tensors to `paged_attention_plain`; anything the kernel
    does not take raises."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, k_scales, v_scales, page_table, lengths,
            sm_scale=sm_scale, bias=bias, return_state=return_state)
    b, h, d = q.shape
    quant = k_scales is not None
    if not q.is_cuda or any(t is not None and t.device != q.device
                            for t in (k_pages, v_pages, k_scales, v_scales,
                                      page_table, lengths, bias)):
        raise ValueError("paged_attention: all inputs on one CUDA device")
    if (q.dtype not in _Q_CODES or k_pages.dtype not in _KV_CODES
            or v_pages.dtype != k_pages.dtype
            or (k_pages.dtype == torch.int8) != quant
            or (v_scales is not None) != quant
            or (quant and (k_scales.dtype != torch.float32
                           or v_scales.dtype != torch.float32))):
        raise TypeError(f"paged_attention: q {q.dtype}, pages "
                        f"{k_pages.dtype}/{v_pages.dtype}; int8 pages need "
                        f"both f32 scales")
    n, _, psize, _ = k_pages.shape if k_pages.dim() == 4 else (0,) * 4
    maxp = page_table.shape[1] if page_table.dim() == 2 else 0
    ks_stride = k_scales.stride() if quant else (0, 0, 1)
    if (k_pages.dim() != 4 or k_pages.shape[1:] != (h, psize, d)
            or not 1 <= d <= _HEAD_DIMS[-1]
            or v_pages.shape != k_pages.shape
            or v_pages.stride() != k_pages.stride()
            or k_pages.stride()[2:] != (d, 1)
            or (quant and (k_scales.shape != (n, h, psize)
                           or v_scales.shape != k_scales.shape
                           or v_scales.stride() != ks_stride
                           or ks_stride[2] != 1))
            or page_table.shape != (b, maxp) or maxp == 0
            or lengths.shape != (b,)
            or (bias is not None and bias.shape != (b, h, maxp * psize))):
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} strides "
                         f"{k_pages.stride()}, table "
                         f"{tuple(page_table.shape)}")
    if not (_aligned(k_pages, k_pages.stride()[:3])
            and _aligned(v_pages, v_pages.stride()[:3])):
        raise ValueError("paged_attention: page rows must be 16-byte aligned")
    lib, fn = _lib()
    q, k_pages, v_pages = padded_head(d, q.contiguous(), k_pages, v_pages)
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    bias = None if bias is None else bias.float().contiguous()
    out = torch.empty_like(q)
    m = l = None
    if return_state:
        m = torch.empty((b, h), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    rc = fn(runtime.ptr(q), runtime.ptr(k_pages), runtime.ptr(v_pages),
            runtime.ptr(k_scales), runtime.ptr(v_scales), runtime.ptr(table),
            runtime.ptr(lens), runtime.ptr(bias), runtime.ptr(out),
            runtime.ptr(m), runtime.ptr(l), b, h, q.shape[-1], psize, maxp,
            k_pages.stride(0), k_pages.stride(1), ks_stride[0], ks_stride[1],
            float(sm_scale), _Q_CODES[q.dtype], _KV_CODES[k_pages.dtype],
            *paged_plan(b, h, maxp), runtime.stream_handle(q))
    runtime.check_launch(lib, rc, "paged_attention")
    paged_attention.launches += 1
    if out.shape[-1] != d:
        out = out[..., :d].contiguous()
    return (out, m, l) if return_state else out


paged_attention.launches = 0
