"""Flash attention with the T5 relative-position bias from the bucket table
inside the kernel, forward and backward.

The forward CUDA kernel (`csrc/flash_attention_rpe.cu`) replaces the four
Pallas forward variants of `flasht5_tpu/ops/flash_attention_rpe.py::_fwd`;
the backward (`csrc/flash_attention_bwd.cu`) replaces its five backward
sites (`_bwd`) and gives the table's gradient. Their sources say what bounds
them and how. The wrapper hands the kernels the (M + N - 1,) int32 bucket of
every offset, computed on the CPU (`positional.bucket_lut`), so no `log` is
evaluated on the GPU.

Both kernels also run without a table, adding no bias: that is plain flash
attention (`ops/flash_attention.py`), which `flash_attention_rpe(...,
rpe_weights=None)` falls through to, as in the JAX package.

The bf16 kernels (TMA + wgmma, `csrc/wgmma_attention.cuh`) are built for
head dims 64 and 128, the f32 ones (and the bias tensor's bf16 kernels) for
32, 64 and 128. The wrappers (these and the bias kernels') take any d up to
128 and zero-pad q, k, v (and dO) to the next of those widths: the padded
features add 0 to every score and give 0 in every output column, and
`sm_scale` is passed, not derived from d, so the sliced results are exact.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from flasht5_tpu_torch import positional, runtime

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_WGMMA_HEAD_DIMS = (64, 128)   # the bf16 kernels' (TMA boxes of 64 columns)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# keys per CTA of the backward's dK/dV kernel (one row of dW's partials)
_KEY_TILE = {torch.float32: 64, torch.bfloat16: 128}
_MAX_BUCKETS = 256
_BF16_ULP = 2.0 ** -7        # one bf16 ulp, relative to the value


def _bias(rpe_weights, m_len, n_len, bidirectional, num_buckets,
          max_distance):
    if rpe_weights is None:
        return 0.0
    return positional.t5_relative_bias(
        {"relative_attention_bias": rpe_weights.float()}, m_len, n_len,
        bidirectional=bidirectional, num_buckets=num_buckets,
        max_distance=max_distance)


def _visible(m_len, n_len, causal, device):
    """(M, N) mask of visible keys; causal is bottom-right aligned."""
    if not causal:
        return torch.ones((m_len, n_len), dtype=torch.bool, device=device)
    row = torch.arange(m_len, device=device)[:, None]
    col = torch.arange(n_len, device=device)[None, :]
    return col <= row + (n_len - m_len)


def attention_plain(q, k, v, bias, *, causal=False, sm_scale=1.0):
    """The forward kernels' function in plain PyTorch: (o in q.dtype, fp32
    lse). `bias` is an fp32 tensor broadcastable to (B, H, M, N), or 0.0.

    Mirrors the TPU kernels' rounding points: products of the input values
    summed in fp32, the bias added in fp32, softmax in fp32, P rounded to
    v's dtype before the PV product, O rounded once. Causal masking is
    bottom-right aligned; a row with no visible key gives 0 and lse -1e30.
    """
    m_len, n_len = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s + bias
    mask = _visible(m_len, n_len, causal, q.device)
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


def flash_attention_rpe_plain(q, k, v, rpe_weights, *, causal=False,
                              sm_scale=1.0, bidirectional=True,
                              num_buckets=32, max_distance=128):
    """The forward kernel's function in plain PyTorch (`attention_plain`
    with the bias gathered from the table): (o in q.dtype, fp32 lse).
    `rpe_weights=None` adds no bias."""
    bias = _bias(rpe_weights, q.shape[2], k.shape[2], bidirectional,
                 num_buckets, max_distance)
    return attention_plain(q, k, v, bias, causal=causal, sm_scale=sm_scale)


def flash_attention_bwd_plain(q, k, v, rpe_weights, lse, delta, do, *,
                              causal=False, sm_scale=1.0, bidirectional=True,
                              num_buckets=32, max_distance=128):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv in the
    input dtype, fp32 dW of shape (num_buckets, H) or None without a table).

    Recomputes P = exp(s * scale + bias - lse); dP = dO v^T; dS = P (dP -
    delta); dV = P^T dO with P rounded to the input type; dK = dS^T q * scale
    and dQ = dS k * scale with dS rounded to it; dW by `scatter_add` of dS
    over the bucket of each offset. Rows with lse = -1e30 contribute nothing.
    """
    dt = q.dtype
    p, ds = _scores_grad_plain(q, k, v, rpe_weights, lse, delta, do, causal,
                               sm_scale, bidirectional, num_buckets,
                               max_distance)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do.float())
    ds_r = ds.to(dt).float()
    dk = torch.matmul(ds_r.transpose(-1, -2), q.float()) * sm_scale
    dq = torch.matmul(ds_r, k.float()) * sm_scale
    dw = None
    if rpe_weights is not None:
        dw = _bucket_sums(ds, bidirectional, num_buckets, max_distance)
    return dq.to(dt), dk.to(dt), dv.to(dt), dw


def flash_attention_dw_abs_plain(q, k, v, rpe_weights, lse, delta, do, *,
                                 causal=False, sm_scale=1.0,
                                 bidirectional=True, num_buckets=32,
                                 max_distance=128):
    """The sum of |dS| over each bucket's scores, (num_buckets, H) fp32: the
    scale of dW's rounding error. dW sums terms of both signs that nearly
    cancel (each row of dS sums to 0), so summing them in another order
    moves it in proportion to this sum, not to dW itself."""
    _, ds = _scores_grad_plain(q, k, v, rpe_weights, lse, delta, do, causal,
                               sm_scale, bidirectional, num_buckets,
                               max_distance)
    return _bucket_sums(ds.abs(), bidirectional, num_buckets, max_distance)


def flash_attention_grad_abs_plain(q, k, v, rpe_weights, lse, delta, do, *,
                                   causal=False, sm_scale=1.0,
                                   bidirectional=True, num_buckets=32,
                                   max_distance=128):
    """`grad_abs_plain` with the bias gathered from the table (or none)."""
    bias = _bias(rpe_weights, q.shape[2], k.shape[2], bidirectional,
                 num_buckets, max_distance)
    return grad_abs_plain(q, k, v, bias, lse, delta, do, causal=causal,
                          sm_scale=sm_scale)


def grad_abs_plain(q, k, v, bias, lse, delta, do, *, causal=False,
                   sm_scale=1.0):
    """The magnitudes that the backward's bf16 roundings act on, fp32, one
    tensor shaped like each of dq, dk and dv: (|dS'| |k| scale, |dS'|^T |q|
    scale, P'^T |dO|), summed over the keys (dq) or the query rows (dk, dv).

    A kernel and this plain version round the same products to bf16 at the
    same points: P before dV = P^T dO, dS before dK = dS^T q and dQ = dS k.
    Two roundings of nearly equal f32 values may land one bf16 ulp apart
    (2^-7 of the value), so each term of an output's sum may move by one
    ulp of its magnitude, and the output by one ulp of the sum of those
    magnitudes (what this returns), on top of the rounding of the output
    itself. P' and dS' add to |P| and |dS| what f32 scores and dP summed in
    another order can move them by: at most D f32 ulps (2^-24) of the sum
    of |products| (|q||k|^T, |dO||v|^T), taken with a margin of 2 as D
    2^-16 P (|q||k|^T scale + ...) once the ulp of 2^-7 multiplies them."""
    p, ds = scores_grad_plain(q, k, v, bias, lse, delta, do, causal=causal,
                              sm_scale=sm_scale)
    d = q.shape[-1]
    qa, ka, va, doa = (t.float().abs() for t in (q, k, v, do))
    ds_in = (p * torch.matmul(doa, va.transpose(-1, -2))
             + ds.abs() * torch.matmul(qa, ka.transpose(-1, -2))
             * sm_scale)
    p_in = p * torch.matmul(qa, ka.transpose(-1, -2)) * sm_scale
    ds_a = ds.abs() + d * 2.0 ** -16 * ds_in
    p_a = p + d * 2.0 ** -16 * p_in
    return (torch.matmul(ds_a, ka) * sm_scale,
            torch.matmul(ds_a.transpose(-1, -2), qa) * sm_scale,
            torch.matmul(p_a.transpose(-1, -2), doa))


def grad_limits(sums, want, n_keys, n_rows):
    """The entry-by-entry limits of a bf16 backward's dq, dk and dv against
    this module's plain version (the leading ones of them that `want`
    holds), derived from the rounding points: `sums` are
    `grad_abs_plain`'s, and an entry may move by one bf16 ulp (2^-7) of
    its sum, by the f32 sum of n_keys (dq) or n_rows (dk, dv) terms in
    another order (n f32 ulps of the sum), and by one ulp of itself for its
    own rounding."""
    return [_BF16_ULP * w.float().abs() + (_BF16_ULP + n * 2.0 ** -24) * a
            for w, a, n in zip(want, sums, (n_keys, n_rows, n_rows))]


def _scores_grad_plain(q, k, v, rpe_weights, lse, delta, do, causal,
                       sm_scale, bidirectional, num_buckets, max_distance):
    bias = _bias(rpe_weights, q.shape[2], k.shape[2], bidirectional,
                 num_buckets, max_distance)
    return scores_grad_plain(q, k, v, bias, lse, delta, do, causal=causal,
                             sm_scale=sm_scale)


def scores_grad_plain(q, k, v, bias, lse, delta, do, *, causal=False,
                      sm_scale=1.0):
    """P and dS = P (dO v^T - delta) in fp32, (B, H, M, N) each, with P
    recomputed from the forward's lse as the backward kernels do. `bias` is
    an fp32 tensor broadcastable to (B, H, M, N), or 0.0."""
    m_len, n_len = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s + bias
    lse4 = lse[..., None]
    ok = _visible(m_len, n_len, causal, q.device) & (lse4 > _NEG_INF / 2)
    p = torch.where(ok, torch.exp(s - torch.where(ok, lse4, 0.0)), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def _bucket_sums(t, bidirectional, num_buckets, max_distance):
    """(B, H, M, N) summed over the batch and over each bucket's (row, col)
    offsets by `scatter_add`: (num_buckets, H) fp32."""
    m_len, n_len = t.shape[2], t.shape[3]
    lut = positional.bucket_lut(
        -(m_len - 1), n_len - 1, bidirectional=bidirectional,
        num_buckets=num_buckets, max_distance=max_distance, device=t.device)
    rel = (torch.arange(n_len, device=t.device)[None, :]
           - torch.arange(m_len, device=t.device)[:, None])
    idx = lut[rel + (m_len - 1)].long().reshape(-1)     # (M * N,)
    per_head = t.sum(dim=0).reshape(t.shape[1], -1)     # (H, M * N)
    out = torch.zeros((t.shape[1], num_buckets), dtype=torch.float32,
                      device=t.device)
    out.scatter_add_(1, idx[None].expand_as(per_head), per_head)
    return out.t()


def _check(name, q, k, v, rpe_weights, num_buckets, *more):
    b, h, m_len, d = q.shape
    n_len = k.shape[2]
    tensors = [k, v, *more] + ([] if rpe_weights is None else [rpe_weights])
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        f"f32 or bf16, all equal")
    if not q.is_cuda or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs on one CUDA device")
    if (k.shape != (b, h, n_len, d) or v.shape != k.shape
            or not 1 <= d <= _HEAD_DIMS[-1]
            or (rpe_weights is not None
                and rpe_weights.shape != (num_buckets, h))):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, table "
            f"{None if rpe_weights is None else tuple(rpe_weights.shape)}")


def _check_scale(name, q, sm_scale):
    """The bf16 kernels take the rows' maxima over the unscaled products,
    so they need a positive scale."""
    if q.dtype == torch.bfloat16 and not sm_scale > 0:
        raise ValueError(f"{name}: the bf16 kernels take sm_scale > 0, not "
                         f"{sm_scale}")


def padded(*ts, widths=_HEAD_DIMS):
    """The tensors, contiguous, their last dim zero-padded to the kernels'
    next head dim of `widths` (32, 64 or 128 by default)."""
    d = ts[0].shape[-1]
    width = next(w for w in widths if d <= w)
    if width == d:
        return [t.contiguous() for t in ts]
    return [F.pad(t, (0, width - d)) for t in ts]


def _widths(dtype):
    """The head dims of the kernels that take `dtype`."""
    return _WGMMA_HEAD_DIMS if dtype == torch.bfloat16 else _HEAD_DIMS


def _table_args(q, rpe_weights, m_len, n_len, bidirectional, num_buckets,
                max_distance):
    """(table f32, bucket int32, num_buckets) for the kernels, or nulls."""
    if rpe_weights is None:
        return None, None, 0
    table = rpe_weights.float().contiguous()
    bucket = positional.bucket_lut(-(m_len - 1), n_len - 1,
                                   bidirectional=bidirectional,
                                   num_buckets=num_buckets,
                                   max_distance=max_distance, device=q.device)
    return table, bucket, num_buckets


def _fn(lib_name, fn_name, argtypes):
    lib = runtime.kernel_library(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


_FWD_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def flash_attention_rpe_fwd(q, k, v, rpe_weights, *, causal=False,
                            sm_scale=1.0, bidirectional=True, num_buckets=32,
                            max_distance=128):
    """(o, lse) of RPE attention. q (B,H,M,D); k, v (B,H,N,D);
    rpe_weights (num_buckets, H), or None for no bias. CUDA tensors go to
    the kernel, CPU tensors to `flash_attention_rpe_plain`; anything else
    raises."""
    kw = dict(causal=causal, sm_scale=sm_scale, bidirectional=bidirectional,
              num_buckets=num_buckets, max_distance=max_distance)
    if q.device.type == "cpu":
        return flash_attention_rpe_plain(q, k, v, rpe_weights, **kw)
    _check("flash_attention_rpe", q, k, v, rpe_weights, num_buckets)
    _check_scale("flash_attention_rpe", q, sm_scale)
    b, h, m_len, d = q.shape
    n_len = k.shape[2]
    lib, fn = _fn("flash_attention_rpe", "ft5_flash_attention_rpe_fwd",
                  _FWD_ARGS)
    q, k, v = padded(q, k, v, widths=_widths(q.dtype))
    dp = q.shape[-1]
    table, bucket, nb = _table_args(q, rpe_weights, m_len, n_len,
                                    bidirectional, num_buckets, max_distance)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, m_len), dtype=torch.float32, device=q.device)
    rc = fn(runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(table),
            runtime.ptr(bucket), runtime.ptr(o), runtime.ptr(lse), b, h, m_len,
            n_len, dp, nb, float(sm_scale), int(causal),
            _DTYPE_CODES[q.dtype], runtime.stream_handle(q))
    runtime.check_launch(lib, rc, "flash_attention_rpe")
    flash_attention_rpe_fwd.launches += 1
    return o[..., :d], lse


flash_attention_rpe_fwd.launches = 0


def flash_attention_bwd(q, k, v, rpe_weights, lse, delta, do, *,
                        causal=False, sm_scale=1.0, bidirectional=True,
                        num_buckets=32, max_distance=128):
    """Gradients (dq, dk, dv, dW) of attention with or without the bucket
    table; dW is fp32 (num_buckets, H), or None without a table. `lse` is
    the forward's, `delta` = rowsum(do * o) in fp32. CUDA tensors go to the
    two backward kernels (one launch of this wrapper), CPU tensors to
    `flash_attention_bwd_plain`; anything else raises."""
    kw = dict(causal=causal, sm_scale=sm_scale, bidirectional=bidirectional,
              num_buckets=num_buckets, max_distance=max_distance)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, rpe_weights, lse, delta, do,
                                         **kw)
    _check("flash_attention_bwd", q, k, v, rpe_weights, num_buckets, lse,
           delta, do)
    _check_scale("flash_attention_bwd", q, sm_scale)
    b, h, m_len, d = q.shape
    n_len = k.shape[2]
    if do.shape != q.shape or lse.shape != (b, h, m_len) or \
            delta.shape != (b, h, m_len):
        raise ValueError(f"flash_attention_bwd: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)}")
    if rpe_weights is not None and not 1 <= num_buckets <= _MAX_BUCKETS:
        raise ValueError(f"flash_attention_bwd: {num_buckets} buckets")
    lib, fn = _fn("flash_attention_bwd", "ft5_flash_attention_bwd",
                  _BWD_ARGS)
    q, k, v, do = padded(q, k, v, do.to(q.dtype), widths=_widths(q.dtype))
    dp = q.shape[-1]
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    table, bucket, nb = _table_args(q, rpe_weights, m_len, n_len,
                                    bidirectional, num_buckets, max_distance)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dw_part = None
    if table is not None:
        dw_part = torch.empty((b, h, -(-n_len // _KEY_TILE[q.dtype]), nb),
                              dtype=torch.float32, device=q.device)
    rc = fn(runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(do),
            runtime.ptr(lse), runtime.ptr(delta), runtime.ptr(table),
            runtime.ptr(bucket), runtime.ptr(dq), runtime.ptr(dk),
            runtime.ptr(dv), runtime.ptr(dw_part), b, h, m_len, n_len, dp, nb,
            float(sm_scale), int(causal), _DTYPE_CODES[q.dtype],
            runtime.stream_handle(q))
    runtime.check_launch(lib, rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    # the partial rows, one per (batch, head, key tile), summed in order
    dw = None if dw_part is None else dw_part.sum(dim=(0, 2)).t()
    return dq[..., :d], dk[..., :d], dv[..., :d], dw


flash_attention_bwd.launches = 0


def wgmma_mn_check(a, b):
    """a @ b on wgmma with b an MN-major operand: a (64, 64) and b (64, N)
    bf16 on the card, N 64 or 128; (c with A from shared memory, c with A
    from registers), (64, N) f32 each. It checks the descriptor that the
    bf16 kernels read V, K, Q and dO through, against `a.float() @
    b.float()`; no path calls it."""
    if not (a.is_cuda and b.is_cuda and a.dtype == b.dtype == torch.bfloat16
            and a.shape == (64, 64) and b.shape[0] == 64
            and b.shape[1] in _WGMMA_HEAD_DIMS):
        raise ValueError(f"wgmma_mn_check: a {tuple(a.shape)} {a.dtype}, b "
                         f"{tuple(b.shape)} {b.dtype}")
    lib, fn = _fn("flash_attention_rpe", "ft5_wgmma_mn_check",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])
    a, b = a.contiguous(), b.contiguous()
    c_ss = torch.empty((64, b.shape[1]), dtype=torch.float32, device=a.device)
    c_rs = torch.empty_like(c_ss)
    rc = fn(runtime.ptr(a), runtime.ptr(b), runtime.ptr(c_ss),
            runtime.ptr(c_rs), b.shape[1], runtime.stream_handle(a))
    runtime.check_launch(lib, rc, "wgmma_mn_check")
    return c_ss, c_rs


class _FlashAttentionFn(torch.autograd.Function):
    """Saves (q, k, v, table, o, lse) as the JAX package's `_far_fwd`."""

    @staticmethod
    def forward(ctx, q, k, v, rpe_weights, kw):
        o, lse = flash_attention_rpe_fwd(q, k, v, rpe_weights, **kw)
        ctx.save_for_backward(q, k, v, rpe_weights, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, rpe_weights, o, lse = ctx.saved_tensors
        # computed outside the kernels, as the JAX package does (:1102)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        dq, dk, dv, dw = flash_attention_bwd(q, k, v, rpe_weights, lse, delta,
                                             do, **ctx.kw)
        if dw is not None:
            dw = dw.to(rpe_weights.dtype)
        return dq, dk, dv, dw, None


def attention(q, k, v, rpe_weights, **kw) -> torch.Tensor:
    """Differentiable flash attention through the two kernels, with the
    bucket table (or none)."""
    return _FlashAttentionFn.apply(q, k, v, rpe_weights, kw)


def flash_attention_rpe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rpe_weights: Optional[torch.Tensor], *,
                        causal: bool = False, sm_scale: float = 1.0,
                        bidirectional: bool = True, num_buckets: int = 32,
                        max_distance: int = 128) -> torch.Tensor:
    """Linear-memory RPE flash attention, differentiable in q, k, v and the
    table; returns o (B, H, M, D). With rpe_weights=None (the decoder's
    cross-attention) this is plain flash attention, as in the JAX package."""
    if rpe_weights is None:
        # what ops/flash_attention.py's flash_attention(q, k, v, None) runs
        return attention(q, k, v, None, causal=causal, sm_scale=sm_scale)
    return attention(q, k, v, rpe_weights, causal=causal, sm_scale=sm_scale,
                     bidirectional=bidirectional, num_buckets=num_buckets,
                     max_distance=max_distance)
