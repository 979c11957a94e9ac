"""T5-style RMS norm: plain PyTorch versions and the fused kernels in Triton.

Replaces the Pallas kernels of `flasht5_tpu/ops/rmsnorm.py`: the forward
`_fwd_kernel` (launched by `_pallas_fwd`) and the backward `_bwd_kernel`
(launched by `_pallas_bwd`). `rms_norm` is differentiable in x and w through
`_RMSNormFn`, whose backward is the second kernel.

Bound on the H100: bytes. The forward reads x once and writes y once (plus
one fp32 rstd per row); the backward reads x, dy and rstd once and writes
dx once. Both do a handful of operations per element, far below the card's
ratio of operations to bytes. The design does the one thing that matters for
such a kernel: a single pass over the rows, each row kept in registers
between its reduction and its elementwise step, several rows per program.

The weight gradient is a sum over all rows. The TPU kernel accumulated it
across a sequential grid, which blocks running in parallel cannot do: here
each backward program writes one fp32 partial row for the rows it owns, and
the partials are summed afterwards in a fixed order (as the reference's own
Triton backward does), so dW is deterministic.
"""

from __future__ import annotations

import functools

import torch

_FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16)
_BWD_PROGRAMS = 264          # two programs per SM of an H100


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


def rms_norm_bwd_plain(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                       dy: torch.Tensor):
    """The backward kernel's arithmetic: (dx in dy.dtype, fp32 dW).

    x̂ = x·rstd is recomputed; dx = (w·dy − x̂·mean(w·dy·x̂))·rstd in fp32;
    dW = Σ_rows dy·x̂ in fp32 (the TPU kernel's `_bwd_kernel`)."""
    d = x.shape[-1]
    x32 = x.reshape(-1, d).float()
    dy32 = dy.reshape(-1, d).float()
    r = rstd.reshape(-1, 1)
    xhat = x32 * r
    wdy = dy32 * w.float()
    c = torch.mean(wdy * xhat, dim=-1, keepdim=True)
    dx = (wdy - xhat * c) * r
    dw = torch.sum(dy32 * xhat, dim=0)
    return dx.to(dy.dtype).reshape(dy.shape), dw


@functools.lru_cache(maxsize=None)
def _triton_kernels():
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

    @triton.jit
    def bwd(x_ptr, w_ptr, rstd_ptr, dy_ptr, dx_ptr, dw_part_ptr, n_rows, d,
            rows_per_prog, ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        # program p owns rows [p * rows_per_prog, (p + 1) * rows_per_prog)
        # and writes row p of the (programs, d) fp32 dW partials
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        acc = tl.zeros((BLOCK_D,), dtype=tl.float32)
        start = pid * rows_per_prog
        end = tl.minimum(start + rows_per_prog, n_rows)
        for r0 in range(start, end, ROWS):
            rows = r0 + tl.arange(0, ROWS)
            rmask = rows < end
            mask = rmask[:, None] & cmask[None, :]
            offs = rows[:, None].to(tl.int64) * d + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            rstd = tl.load(rstd_ptr + rows, mask=rmask, other=0.0)
            xhat = x * rstd[:, None]
            wdy = dy * w[None, :]
            c = tl.sum(wdy * xhat, axis=1) / d
            dx = (wdy - xhat * c[:, None]) * rstd[:, None]
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
            acc += tl.sum(dy * xhat, axis=0)
        tl.store(dw_part_ptr + pid.to(tl.int64) * d + cols, acc, mask=cmask)

    return triton, fwd, bwd


def _check(name: str, x: torch.Tensor, w: torch.Tensor, *more) -> None:
    d = x.shape[-1]
    if x.dtype not in _FLOAT_TYPES or w.dtype not in _FLOAT_TYPES:
        raise TypeError(f"{name}: unsupported dtypes {x.dtype}, {w.dtype}")
    if not x.is_cuda or any(t.device != x.device for t in (w, *more)):
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")
    if w.shape != (d,):
        raise ValueError(f"{name}: w {tuple(w.shape)} for d={d}")


def _rows_per_program(d_block: int) -> int:
    return max(1, min(16, 4096 // d_block))


def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """Fused RMS norm over the last axis: (y, rstd). x (..., d), w (d,).

    A CUDA tensor goes to the Triton kernel, a CPU tensor to
    `rms_norm_plain`; anything the kernel does not take raises."""
    d = x.shape[-1]
    if x.device.type == "cpu":
        return rms_norm_plain(x, w, eps)
    _check("rms_norm", x, w)
    triton, kernel, _ = _triton_kernels()
    x2 = x.reshape(-1, d).contiguous()
    w = w.contiguous()
    n_rows = x2.shape[0]
    y = torch.empty_like(x2)
    rstd = torch.empty((n_rows,), dtype=torch.float32, device=x.device)
    block_d = triton.next_power_of_2(d)
    rows = _rows_per_program(block_d)
    kernel[(triton.cdiv(n_rows, rows),)](
        x2, w, y, rstd, n_rows, d, eps, ROWS=rows, BLOCK_D=block_d,
        num_warps=4)
    rms_norm_fwd.launches += 1
    return y.reshape(x.shape), rstd.reshape(x.shape[:-1])


rms_norm_fwd.launches = 0


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                 dy: torch.Tensor):
    """Gradient of the fused RMS norm: (dx in dy.dtype, fp32 dW).

    A CUDA tensor goes to the Triton kernel (dx and one dW partial row per
    program, the partials then summed in order), a CPU tensor to
    `rms_norm_bwd_plain`; anything the kernel does not take raises."""
    d = x.shape[-1]
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, w, rstd, dy)
    _check("rms_norm_bwd", x, w, rstd, dy)
    if dy.shape != x.shape or dy.dtype not in _FLOAT_TYPES:
        raise ValueError(f"rms_norm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"for x {tuple(x.shape)}")
    triton, _, kernel = _triton_kernels()
    x2 = x.reshape(-1, d).contiguous()
    dy2 = dy.reshape(-1, d).contiguous()
    r = rstd.reshape(-1).float().contiguous()
    n_rows = x2.shape[0]
    block_d = triton.next_power_of_2(d)
    rows = _rows_per_program(block_d)
    per_prog = rows * max(1, triton.cdiv(triton.cdiv(n_rows, rows),
                                         _BWD_PROGRAMS))
    programs = max(1, triton.cdiv(n_rows, per_prog))
    dx = torch.empty_like(dy2)
    partials = torch.empty((programs, d), dtype=torch.float32,
                           device=x.device)
    kernel[(programs,)](x2, w.contiguous(), r, dy2, dx, partials, n_rows, d,
                        per_prog, ROWS=rows, BLOCK_D=block_d, num_warps=4)
    rms_norm_bwd.launches += 1
    return dx.reshape(dy.shape), partials.sum(dim=0)


rms_norm_bwd.launches = 0


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        y, rstd = rms_norm_fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, rstd, dy)
        return dx, dw.to(w.dtype), None


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Fused RMS norm over the last axis, differentiable in x and w."""
    return _RMSNormFn.apply(x, w, eps)
