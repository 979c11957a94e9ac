"""T5-style RMS norm: plain PyTorch versions and the fused forward in Triton.

Replaces the Pallas forward `flasht5_tpu/ops/rmsnorm.py::_fwd_kernel`
(launched by `_pallas_fwd`). The backward (`_bwd_kernel`) belongs to the
training slice and is not ported yet.

Bound on the H100: bytes. Per row of d values the kernel reads x once and
writes y once (plus one fp32 rstd), against about 4 operations per element,
far below the card's ratio of operations to bytes. The design does the one
thing that matters for such a kernel: a single pass over x, kept in
registers between the reduction and the scaling, with several rows per
program so that each program moves a few KB.
"""

from __future__ import annotations

import functools

import torch

_FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16)


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """fp32-accumulated RMS norm, output cast to w.dtype when w is low
    precision (the JAX package's `rms_norm_ref`)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if w.dtype != torch.float32:
        return w * y.to(w.dtype)
    return (w * y).to(x.dtype)


def rms_norm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """The kernel's arithmetic in plain PyTorch: (y in x.dtype, fp32 rstd
    of shape x.shape[:-1]). Unlike `rms_norm_ref`, the weight multiplies in
    fp32 and only y is rounded (as the TPU kernel does)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1)
    rstd = torch.rsqrt(var + eps)
    y = x32 * rstd[..., None] * w.float()
    return y.to(x.dtype), rstd


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def fwd(x_ptr, w_ptr, y_ptr, rstd_ptr, n_rows, d, eps,
            ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK_D)
        rmask = rows < n_rows
        cmask = cols < d
        mask = rmask[:, None] & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * d + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=1) / d
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        y = x * rstd[:, None] * w[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)
        tl.store(rstd_ptr + rows, rstd, mask=rmask)

    return triton, fwd


def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """Fused RMS norm over the last axis: (y, rstd). x (..., d), w (d,).

    A CUDA tensor goes to the Triton kernel, a CPU tensor to
    `rms_norm_plain`; anything the kernel does not take raises."""
    d = x.shape[-1]
    if x.device.type == "cpu":
        return rms_norm_plain(x, w, eps)
    if not x.is_cuda or w.device != x.device:
        raise ValueError(f"rms_norm: x on {x.device}, w on {w.device}")
    if x.dtype not in _FLOAT_TYPES or w.dtype not in _FLOAT_TYPES:
        raise TypeError(f"rms_norm: unsupported dtypes {x.dtype}, {w.dtype}")
    if w.shape != (d,):
        raise ValueError(f"rms_norm: w {tuple(w.shape)} for d={d}")
    triton, kernel = _triton_kernel()
    x2 = x.reshape(-1, d).contiguous()
    w = w.contiguous()
    n_rows = x2.shape[0]
    y = torch.empty_like(x2)
    rstd = torch.empty((n_rows,), dtype=torch.float32, device=x.device)
    block_d = triton.next_power_of_2(d)
    rows = max(1, min(16, 4096 // block_d))
    kernel[(triton.cdiv(n_rows, rows),)](
        x2, w, y, rstd, n_rows, d, eps, ROWS=rows, BLOCK_D=block_d,
        num_warps=4)
    rms_norm_fwd.launches += 1
    return y.reshape(x.shape), rstd.reshape(x.shape[:-1])


rms_norm_fwd.launches = 0


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Fused RMS norm over the last axis (forward only)."""
    return rms_norm_fwd(x, w, eps)[0]
