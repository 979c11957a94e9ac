"""Flash attention with an additive bias (B|1, H|1, M, N), and without one.

The counterpart of `flasht5_tpu/ops/flash_attention.py::flash_attention`.
With a bias, the materialized T5 bias of `attention_type="pallas"` (with
`use_masking`'s padding rows folded in), it runs on three Hopper kernels
(`csrc/flash_attention_bias.cu`), one wrapper each: the forward
(`_fwd_kernel` with has_bias, pallas_call :325), dK/dV with the per-batch
dbias (`_bwd_dkv_kernel`, :766) and dQ (`_bwd_dq_kernel`, :798); the source
says what bounds them. Without a bias (the decoder's cross-attention) it
runs the RPE kernels given no table (`ops/flash_attention_rpe.py`).

Differentiable in q, k, v and the bias. As in the JAX package the bias is
clamped at -1e29 first, so a row masked with `finfo.min` everywhere attends
uniformly rather than to nothing, and its gradient is 0 there. The backward
recomputes P from the forward's log-sum-exp, which for such a row absorbs
log(N) into -1e29: P comes out 1, not 1/N, in dq, dk and dv, exactly as in
the JAX kernels. The plain versions beside the kernels repeat that
arithmetic (`attention_plain`, `scores_grad_plain`), so that the CPU path
agrees with the JAX package rather than with autograd through `attn_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.ops.flash_attention_rpe import (_DTYPE_CODES, _check,
                                                       _check_scale, _fn,
                                                       _widths, attention,
                                                       attention_plain,
                                                       padded,
                                                       scores_grad_plain)

_BIAS_MIN = -1e29       # the clamp of the JAX package (:908-914)
_LIB = "flash_attention_bias"
_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_TAIL = [_INT] * 5 + [ctypes.c_float, _INT, _INT, _PTR]   # B H M N D ...
_FWD_ARGS = [_PTR] * 4 + [_I64] * 3 + [_PTR] * 2 + _TAIL
_DKV_ARGS = [_PTR] * 7 + [_I64] * 3 + [_PTR] * 3 + _TAIL
_DQ_ARGS = [_PTR] * 7 + [_I64] * 3 + [_PTR] + _TAIL


def _reduce(dbias: torch.Tensor, shape) -> torch.Tensor:
    """The per-batch (B, H, M, N) dS summed over the bias's size-1 axes."""
    axes = tuple(a for a in (0, 1) if shape[a] == 1 and dbias.shape[a] != 1)
    return dbias.sum(dim=axes, keepdim=True) if axes else dbias


def flash_attention_bias_plain(q, k, v, bias, *, causal=False, sm_scale=1.0):
    """The forward kernel's function in plain PyTorch: (o, fp32 lse)."""
    return attention_plain(q, k, v, bias.float(), causal=causal,
                           sm_scale=sm_scale)


def flash_attention_bias_dkv_plain(q, k, v, bias, lse, delta, do, *,
                                   causal=False, sm_scale=1.0):
    """The dK/dV kernel's function in plain PyTorch: (dk, dv in the input
    dtype, fp32 dbias in the bias's shape). dV = P^T dO with P rounded to
    the input type, dK = dS^T q * scale with dS rounded to it."""
    dt = q.dtype
    p, ds = scores_grad_plain(q, k, v, bias.float(), lse, delta, do,
                              causal=causal, sm_scale=sm_scale)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(dt).float().transpose(-1, -2),
                      q.float()) * sm_scale
    return dk.to(dt), dv.to(dt), _reduce(ds, bias.shape)


def flash_attention_bias_dq_plain(q, k, v, bias, lse, delta, do, *,
                                  causal=False, sm_scale=1.0):
    """The dQ kernel's function in plain PyTorch: dS k * scale, dS rounded
    to the input type, in the input dtype."""
    _, ds = scores_grad_plain(q, k, v, bias.float(), lse, delta, do,
                              causal=causal, sm_scale=sm_scale)
    dq = torch.matmul(ds.to(q.dtype).float(), k.float()) * sm_scale
    return dq.to(q.dtype)


def _bias_args(name, q, k, bias):
    """(fp32 bias, its batch, head and row strides) for the kernels; a
    broadcast axis, of size 1 or stride 0, gets stride 0."""
    b, h, m_len = q.shape[:3]
    n_len = k.shape[2]
    if (bias.dim() != 4 or bias.shape[0] not in (1, b)
            or bias.shape[1] not in (1, h)
            or bias.shape[2:] != (m_len, n_len)):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} for q "
                         f"{tuple(q.shape)} and k {tuple(k.shape)}; "
                         f"(B|1, H|1, M, N)")
    if bias.device != q.device:
        raise ValueError(f"{name}: all inputs on one CUDA device")
    bias = bias.float()
    if bias.stride(3) != 1:
        bias = bias.contiguous()
    strides = [0 if bias.shape[a] == 1 else bias.stride(a) for a in (0, 1)]
    return bias, strides + [bias.stride(2)]


def _common(name, q, k, v, sm_scale, *more):
    """q, k, v (and `more`) zero-padded to the kernels' head dim, with
    (B, H, M, N, padded D)."""
    _check_scale(name, q, sm_scale)
    q, k, v, *more = padded(q, k, v, *more, widths=_widths(q.dtype))
    b, h, m_len, d = q.shape
    return q, k, v, more, (b, h, m_len, k.shape[2], d)


def _check_grad_inputs(name, q, lse, delta, do):
    b, h, m_len = q.shape[:3]
    if do.shape != q.shape or lse.shape != (b, h, m_len) or \
            delta.shape != (b, h, m_len):
        raise ValueError(f"{name}: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)}")
    return (do.to(q.dtype).contiguous(), lse.float().contiguous(),
            delta.float().contiguous())


def flash_attention_bias_fwd(q, k, v, bias, *, causal=False, sm_scale=1.0):
    """(o, lse) of attention with an additive bias. q (B,H,M,D); k, v
    (B,H,N,D); bias (B|1,H|1,M,N). CUDA tensors go to the kernel, CPU
    tensors to `flash_attention_bias_plain`; anything else raises."""
    if q.device.type == "cpu":
        return flash_attention_bias_plain(q, k, v, bias, causal=causal,
                                          sm_scale=sm_scale)
    name = "flash_attention_bias"
    _check(name, q, k, v, None, 0)
    bias, (sb, sh, sm) = _bias_args(name, q, k, bias)
    lib, fn = _fn(_LIB, "ft5_flash_attention_bias_fwd", _FWD_ARGS)
    d_in = q.shape[-1]
    q, k, v, _, (b, h, m_len, n_len, d) = _common(name, q, k, v,
                                                  sm_scale)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, m_len), dtype=torch.float32, device=q.device)
    rc = fn(runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(bias),
            sb, sh, sm, runtime.ptr(o), runtime.ptr(lse), b, h, m_len, n_len,
            d, float(sm_scale), int(causal), _DTYPE_CODES[q.dtype],
            runtime.stream_handle(q))
    runtime.check_launch(lib, rc, name)
    flash_attention_bias_fwd.launches += 1
    return o[..., :d_in], lse


flash_attention_bias_fwd.launches = 0


def flash_attention_bias_dkv(q, k, v, bias, lse, delta, do, *, causal=False,
                             sm_scale=1.0):
    """(dk, dv, dbias) of attention with a bias: dbias fp32 in the bias's
    shape, the kernel's per-batch (B, H, M, N) dS summed over the bias's
    size-1 axes. `lse` is the forward's, `delta` = rowsum(do * o) in fp32.
    CUDA tensors go to the kernel, CPU tensors to
    `flash_attention_bias_dkv_plain`; anything else raises."""
    if q.device.type == "cpu":
        return flash_attention_bias_dkv_plain(q, k, v, bias, lse, delta, do,
                                              causal=causal, sm_scale=sm_scale)
    name = "flash_attention_bias_dkv"
    _check(name, q, k, v, None, 0, lse, delta, do)
    do, lse, delta = _check_grad_inputs(name, q, lse, delta, do)
    shape = bias.shape
    bias, (sb, sh, sm) = _bias_args(name, q, k, bias)
    lib, fn = _fn(_LIB, "ft5_flash_attention_bias_dkv", _DKV_ARGS)
    d_in = q.shape[-1]
    q, k, v, (do,), (b, h, m_len, n_len, d) = _common(name, q, k, v,
                                                      sm_scale, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty((b, h, m_len, n_len), dtype=torch.float32,
                        device=q.device)
    rc = fn(runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(do),
            runtime.ptr(lse), runtime.ptr(delta), runtime.ptr(bias), sb, sh,
            sm, runtime.ptr(dk), runtime.ptr(dv), runtime.ptr(dbias), b, h,
            m_len, n_len, d, float(sm_scale), int(causal),
            _DTYPE_CODES[q.dtype], runtime.stream_handle(q))
    runtime.check_launch(lib, rc, name)
    flash_attention_bias_dkv.launches += 1
    return dk[..., :d_in], dv[..., :d_in], _reduce(dbias, shape)


flash_attention_bias_dkv.launches = 0


def flash_attention_bias_dq(q, k, v, bias, lse, delta, do, *, causal=False,
                            sm_scale=1.0):
    """dq of attention with a bias. CUDA tensors go to the kernel, CPU
    tensors to `flash_attention_bias_dq_plain`; anything else raises."""
    if q.device.type == "cpu":
        return flash_attention_bias_dq_plain(q, k, v, bias, lse, delta, do,
                                             causal=causal, sm_scale=sm_scale)
    name = "flash_attention_bias_dq"
    _check(name, q, k, v, None, 0, lse, delta, do)
    do, lse, delta = _check_grad_inputs(name, q, lse, delta, do)
    bias, (sb, sh, sm) = _bias_args(name, q, k, bias)
    lib, fn = _fn(_LIB, "ft5_flash_attention_bias_dq", _DQ_ARGS)
    d_in = q.shape[-1]
    q, k, v, (do,), (b, h, m_len, n_len, d) = _common(name, q, k, v,
                                                      sm_scale, do)
    dq = torch.empty_like(q)
    rc = fn(runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(do),
            runtime.ptr(lse), runtime.ptr(delta), runtime.ptr(bias), sb, sh,
            sm, runtime.ptr(dq), b, h, m_len, n_len, d, float(sm_scale),
            int(causal), _DTYPE_CODES[q.dtype], runtime.stream_handle(q))
    runtime.check_launch(lib, rc, name)
    flash_attention_bias_dq.launches += 1
    return dq[..., :d_in]


flash_attention_bias_dq.launches = 0


class _BiasAttentionFn(torch.autograd.Function):
    """Saves (q, k, v, bias, o, lse) as the JAX package's `_fab_fwd`."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale):
        o, lse = flash_attention_bias_fwd(q, k, v, bias, causal=causal,
                                          sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.kw = dict(causal=causal, sm_scale=sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        # computed outside the kernels, as the JAX package does (:597)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        dk, dv, dbias = flash_attention_bias_dkv(q, k, v, bias, lse, delta,
                                                 do, **ctx.kw)
        dq = flash_attention_bias_dq(q, k, v, bias, lse, delta, do, **ctx.kw)
        return dq, dk, dv, dbias.to(bias.dtype), None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    causal: bool = False,
                    sm_scale: float = 1.0) -> torch.Tensor:
    """Flash attention, differentiable in q, k, v and the bias. q (B,H,M,D);
    k, v (B,H,N,D); bias (B|1,H|1,M,N), or None; causal masking is
    bottom-right aligned."""
    if bias is None:
        return attention(q, k, v, None, causal=causal, sm_scale=sm_scale)
    if bias.dim() != 4:
        raise ValueError(f"bias must be 4-D (B|1, H|1, M, N), got "
                         f"{tuple(bias.shape)}")
    bias = torch.clamp_min(bias, _BIAS_MIN)
    return _BiasAttentionFn.apply(q, k, v, bias, causal, sm_scale)
