"""Flash attention with the T5 relative-position bias from the bucket table
inside the kernel (forward only; the backward belongs to the training slice).

The CUDA kernel (`csrc/flash_attention_rpe.cu`) replaces the four Pallas
forward variants of `flasht5_tpu/ops/flash_attention_rpe.py::_fwd`; its
source says what bounds it and how. The wrapper hands it the (M + N - 1,)
int32 bucket of every offset, computed on the CPU (`positional.bucket_lut`),
so no `log` is evaluated on the GPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from flasht5_tpu_torch import positional, runtime

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_rpe_plain(q, k, v, rpe_weights, *, causal=False,
                              sm_scale=1.0, bidirectional=True,
                              num_buckets=32, max_distance=128):
    """The kernel's function in plain PyTorch: (o in q.dtype, fp32 lse).

    Mirrors the TPU kernel's rounding points: products of the input values
    summed in fp32, the bias added in fp32, softmax in fp32, P rounded to
    v's dtype before the PV product, O rounded once. Causal masking is
    bottom-right aligned; a row with no visible key gives 0 and lse -1e30.
    """
    m_len, n_len = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s + positional.t5_relative_bias(
        {"relative_attention_bias": rpe_weights.float()}, m_len, n_len,
        bidirectional=bidirectional, num_buckets=num_buckets,
        max_distance=max_distance)
    if causal:
        row = torch.arange(m_len, device=q.device)[:, None]
        col = torch.arange(n_len, device=q.device)[None, :]
        mask = col <= row + (n_len - m_len)
    else:
        mask = torch.ones((m_len, n_len), dtype=torch.bool, device=q.device)
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m > _NEG_INF / 2, m, 0.0)
    p = torch.where(mask, torch.exp(s - m_safe), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0.0, l, 1.0)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (pv / l_safe).to(q.dtype)
    lse = torch.where(l > 0.0, m_safe + torch.log(l_safe), _NEG_INF)
    return o, lse[..., 0]


def _lib():
    lib = runtime.kernel_library("flash_attention_rpe")
    fn = lib.ft5_flash_attention_rpe_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_rpe_fwd(q, k, v, rpe_weights, *, causal=False,
                            sm_scale=1.0, bidirectional=True, num_buckets=32,
                            max_distance=128):
    """(o, lse) of RPE attention. q (B,H,M,D); k, v (B,H,N,D);
    rpe_weights (num_buckets, H). CUDA tensors go to the kernel, CPU tensors
    to `flash_attention_rpe_plain`; anything else raises."""
    kw = dict(causal=causal, sm_scale=sm_scale, bidirectional=bidirectional,
              num_buckets=num_buckets, max_distance=max_distance)
    if q.device.type == "cpu":
        return flash_attention_rpe_plain(q, k, v, rpe_weights, **kw)
    b, h, m_len, d = q.shape
    n_len = k.shape[2]
    if not q.is_cuda or any(t.device != q.device
                            for t in (k, v, rpe_weights)):
        raise ValueError("flash_attention_rpe: all inputs on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_rpe: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; f32 or bf16, all equal")
    if (k.shape != (b, h, n_len, d) or v.shape != k.shape
            or d not in _HEAD_DIMS
            or rpe_weights.shape != (num_buckets, h)):
        raise ValueError(f"flash_attention_rpe: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, table "
                         f"{tuple(rpe_weights.shape)}")
    lib, fn = _lib()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    table = rpe_weights.float().contiguous()
    bucket = positional.bucket_lut(-(m_len - 1), n_len - 1,
                                   bidirectional=bidirectional,
                                   num_buckets=num_buckets,
                                   max_distance=max_distance, device=q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, m_len), dtype=torch.float32, device=q.device)
    rc = fn(runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(table),
            runtime.ptr(bucket), runtime.ptr(o), runtime.ptr(lse), b, h, m_len,
            n_len, d, num_buckets, float(sm_scale), int(causal),
            _DTYPE_CODES[q.dtype], runtime.stream_handle(q))
    runtime.check_launch(lib, rc, "flash_attention_rpe")
    flash_attention_rpe_fwd.launches += 1
    return o, lse


flash_attention_rpe_fwd.launches = 0


def flash_attention_rpe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rpe_weights: Optional[torch.Tensor], *,
                        causal: bool = False, sm_scale: float = 1.0,
                        bidirectional: bool = True, num_buckets: int = 32,
                        max_distance: int = 128) -> torch.Tensor:
    """Linear-memory RPE flash attention; returns o (B, H, M, D)."""
    if rpe_weights is None:
        raise NotImplementedError(
            "flash attention without a bucket table (ops/flash_attention.py) "
            "is not ported yet")
    return flash_attention_rpe_fwd(
        q, k, v, rpe_weights, causal=causal, sm_scale=sm_scale,
        bidirectional=bidirectional, num_buckets=num_buckets,
        max_distance=max_distance)[0]
