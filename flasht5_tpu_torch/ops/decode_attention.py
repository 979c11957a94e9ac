"""Fused single-query decode attention over (quantized) KV caches.

`decode_attention` runs the CUDA kernel `csrc/decode_attention.cu`, which
replaces the Pallas kernels `flasht5_tpu/ops/decode_attention.py::_kernel_flat`
and `::_kernel` (its source and `csrc/single_query.cuh` say what bounds it
and how), on the split that `decode_plan` chooses from the shapes.

Layout: q (B, H, D); k, v (B, H, L, D) in f32, bf16 or int8 with scales
(B, H, L, 1); lengths (B,) valid positions per slot; bias (B, H, L).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from flasht5_tpu_torch import runtime

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# the kernel's split (csrc/single_query.cuh)
_WARPS = 4               # warps a CTA, one share of positions each
_MAX_SPLITS = 8          # CTAs of a cluster (the portable size)
_TARGET_CTAS = 256       # about two CTAs for each of the H100's 132 SMs
_MIN_SPLIT = 64          # positions a CTA keeps at least once split


def decode_attention_ref(q, k, v, k_scales=None, v_scales=None, lengths=None,
                         bias=None, *, sm_scale=1.0):
    """Oracle of the JAX package: fp32 softmax attention of one query."""
    kf, vf = k.float(), v.float()
    if k_scales is not None:
        kf = kf * k_scales
    if v_scales is not None:
        vf = vf * v_scales
    s = torch.einsum("bhd,bhld->bhl", q.float(), kf) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if lengths is not None:
        pos = torch.arange(k.shape[2], device=q.device)
        s = torch.where(pos[None, None, :] < lengths[:, None, None], s,
                        _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhl,bhld->bhd", p, vf).to(q.dtype)


def decode_attention_plain(q, k, v, k_scales=None, v_scales=None,
                           lengths=None, bias=None, *, sm_scale=1.0):
    """The kernel's arithmetic in plain PyTorch. As on the TPU, q, k, P and
    v are rounded to bf16 unless q and the cache are both f32; the k scales
    multiply the scores and the v scales fold into P; sums are fp32; a slot
    with no valid position gives 0. One softmax maximum over the whole
    cache, which is what the 512-position chunks of the kernels give for
    caches of up to 512 positions."""
    bf16 = not (q.dtype == torch.float32 and k.dtype == torch.float32)

    def rnd(t):
        t = t.float()
        return t.to(torch.bfloat16).float() if bf16 else t

    s = torch.einsum("bhd,bhld->bhl", rnd(q), rnd(k))
    if k_scales is not None:
        s = s * k_scales[..., 0]
    s = s * sm_scale
    if bias is not None:
        s = s + bias.float()
    pos = torch.arange(k.shape[2], device=q.device)[None, None, :]
    if lengths is not None:
        valid = pos < lengths.to(q.device)[:, None, None]
    else:
        valid = torch.ones_like(s, dtype=torch.bool)
    s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scales is not None:
        p = p * v_scales[..., 0]
    pv = torch.einsum("bhl,bhld->bhd", rnd(p), rnd(v))
    return (pv / torch.where(l > 0.0, l, 1.0)).to(q.dtype)


@functools.lru_cache(maxsize=None)
def decode_plan(b: int, h: int, L: int) -> Tuple[int, int, int]:
    """(splits, warps, unit) of the kernel for a (b, h, L, D) cache: each
    (slot, head) runs on a cluster of `splits` CTAs of `warps` warps, and
    warp `warp` of cluster rank `rank` owns the positions from
    (rank * warps + warp) * unit, `unit` of them. `splits` is the least power
    of two (at most 8) that gives about two CTAs an SM, as far as each CTA
    keeps 64 positions or more: the cross cache (8, 8, 512) runs on 256
    CTAs of 4 warps of 32 positions, a 66-position self cache takes no
    split. From shapes alone (the lengths live on the card), once per
    shape."""
    splits = 1
    while (splits < _MAX_SPLITS and b * h * splits < _TARGET_CTAS
           and L >= 2 * splits * _MIN_SPLIT):
        splits *= 2
    return splits, _WARPS, -(-L // (splits * _WARPS))


def decode_pieces(b: int, h: int, L: int) -> List[Tuple[int, int]]:
    """The positions [begin, end) of each warp's share, in the order the
    kernel merges them (cluster rank, then warp); the last ones may be
    short or empty."""
    splits, warps, unit = decode_plan(b, h, L)
    return [(min(L, u * unit), min(L, (u + 1) * unit))
            for u in range(splits * warps)]


def _lib():
    lib = runtime.kernel_library("decode_attention")
    fn = lib.ft5_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def decode_attention(q, k, v, k_scales=None, v_scales=None, lengths=None,
                     bias=None, *, sm_scale: float = 1.0) -> torch.Tensor:
    """Fused decode attention; returns (B, H, D) in q.dtype. CUDA tensors go
    to the kernel, CPU tensors to `decode_attention_plain`; anything the
    kernel does not take raises."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, k_scales, v_scales, lengths,
                                      bias, sm_scale=sm_scale)
    b, h, d = q.shape
    L = k.shape[2]
    quant = k_scales is not None
    if not q.is_cuda or any(t is not None and t.device != q.device
                            for t in (k, v, k_scales, v_scales, lengths,
                                      bias)):
        raise ValueError("decode_attention: all inputs on one CUDA device")
    if (q.dtype not in _Q_CODES or k.dtype not in _KV_CODES
            or v.dtype != k.dtype or (k.dtype == torch.int8) != quant
            or (v_scales is not None) != quant):
        raise TypeError(f"decode_attention: q {q.dtype}, cache {k.dtype}/"
                        f"{v.dtype}; int8 caches need both scales")
    if (k.shape != (b, h, L, d) or v.shape != k.shape or d not in _HEAD_DIMS
            or (quant and (k_scales.shape != (b, h, L, 1)
                           or v_scales.shape != (b, h, L, 1)))
            or (lengths is not None and lengths.shape != (b,))
            or (bias is not None and bias.shape != (b, h, L))):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k.shape)}")
    lib, fn = _lib()
    q = q.contiguous()
    k, v = k.contiguous(), v.contiguous()
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: cache rows must be 16-byte "
                         "aligned")
    ks = vs = None
    if quant:
        ks = k_scales.float().contiguous()
        vs = v_scales.float().contiguous()
    lens = None if lengths is None else lengths.to(torch.int32).contiguous()
    bias = None if bias is None else bias.float().contiguous()
    out = torch.empty_like(q)
    rc = fn(runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(ks),
            runtime.ptr(vs), runtime.ptr(lens), runtime.ptr(bias),
            runtime.ptr(out), b, h, L, d, float(sm_scale), _Q_CODES[q.dtype],
            _KV_CODES[k.dtype], *decode_plan(b, h, L),
            runtime.stream_handle(q))
    runtime.check_launch(lib, rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
