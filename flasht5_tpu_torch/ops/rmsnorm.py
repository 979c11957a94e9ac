"""T5-style RMS norm: plain PyTorch versions and the fused kernels in CUDA.

Replaces the Pallas kernels of `flasht5_tpu/ops/rmsnorm.py`: the forward
`_fwd_kernel` (launched by `_pallas_fwd`) and the backward `_bwd_kernel`
(launched by `_pallas_bwd`), both with `csrc/rmsnorm.cu`. `rms_norm` is
differentiable in x and w through `_RMSNormFn`, whose backward is the second
kernel.

The weight is taken as stored and widened to fp32, and w's gradient comes
back in w's dtype, as in the JAX op. The model's `_layer_norm` casts w to
x.dtype first (the JAX model's `w.astype(x.dtype)`); it passes `cast_w=True`
instead, and the kernels round w to x.dtype as they load it and dW to
x.dtype as they store it (that cast's gradient), so the cast of the fp32
parameter costs no launch.

Bound on the H100: bytes. The forward reads x once and writes y once (plus
one fp32 rstd per row); the backward reads x, dy and rstd once and writes
dx once. The design (the source says more): one warp a row (a CTA a row for
wide rows), the row's 16-byte vectors in registers, row sums by warp
shuffles; the forward a CTA for every four rows, the backward a persistent
grid sized from the SM count in which each warp has its next row's loads in
flight.

The weight gradient is a sum over all rows. The TPU kernel accumulated it
across a sequential grid; here each lane keeps its columns' sums in
registers over all its rows, and the CTAs' partials meet in the same launch
through clusters and an arrival ticket, every sum in a fixed order: dW is
deterministic and needs no second launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flasht5_tpu_torch import runtime

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FLOAT_TYPES = tuple(_CODES)
_MAX_CLUSTER = 8         # the backward's tickets, one per cluster rank


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


def _w32(x: torch.Tensor, w: torch.Tensor, cast_w: bool) -> torch.Tensor:
    """w in fp32, rounded through x.dtype first where `cast_w`."""
    return (w.to(x.dtype) if cast_w else w).float()


def rms_norm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
                   cast_w: bool = False):
    """The kernel's arithmetic in plain PyTorch: (y in x.dtype, fp32 rstd
    of shape x.shape[:-1]). w is widened to fp32 (rounded to x.dtype first
    where `cast_w`); unlike `rms_norm_ref`, the weight multiplies in fp32 and
    only y is rounded (as the TPU kernel does)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1)
    rstd = torch.rsqrt(var + eps)
    y = x32 * rstd[..., None] * _w32(x, w, cast_w)
    return y.to(x.dtype), rstd


def rms_norm_bwd_plain(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                       dy: torch.Tensor, *, cast_w: bool = False):
    """The backward kernel's arithmetic: (dx in dy.dtype, fp32 dW).

    w is widened to fp32 (rounded to x.dtype first where `cast_w`);
    x̂ = x·rstd is recomputed; dx = (w·dy − x̂·mean(w·dy·x̂))·rstd in fp32;
    dW = Σ_rows dy·x̂ in fp32 (the TPU kernel's `_bwd_kernel`), rounded to
    x.dtype where `cast_w` (the cast's gradient)."""
    d = x.shape[-1]
    x32 = x.reshape(-1, d).float()
    dy32 = dy.reshape(-1, d).float()
    r = rstd.reshape(-1, 1)
    xhat = x32 * r
    wdy = dy32 * _w32(x, w, cast_w)
    c = torch.mean(wdy * xhat, dim=-1, keepdim=True)
    dx = (wdy - xhat * c) * r
    dw = torch.sum(dy32 * xhat, dim=0)
    if cast_w:
        dw = dw.to(x.dtype).float()
    return dx.to(dy.dtype).reshape(dy.shape), dw


def _lib():
    lib = runtime.kernel_library("rmsnorm")
    if lib.ft5_rms_norm_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ft5_rms_norm_plan.argtypes = [i, ll, i, i, i, i, p]
        lib.ft5_rms_norm_fwd.argtypes = ([p] * 4 + [ll, i, ctypes.c_float]
                                         + [i] * 5 + [p])
        lib.ft5_rms_norm_bwd.argtypes = [p] * 8 + [ll] + [i] * 8 + [p]
        for fn in (lib.ft5_rms_norm_plan, lib.ft5_rms_norm_fwd,
                   lib.ft5_rms_norm_bwd):
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def plan(backward: bool, rows: int, d: int, x_dtype: torch.dtype,
         y_dtype: torch.dtype, vec: bool, device: int):
    """(cpl, warps, grid, cluster) of the kernel for x (rows, d): the warp
    form's 16-byte chunks a lane (1, 2 or 4; 0 for the CTA form, one CTA a
    row), a CTA's warps, the CTAs (the forward's warp form: one for every
    CTA's worth of rows; else at most what the card holds at once) and, for
    the backward (`y_dtype` is dy's), the CTAs a cluster. From the shapes and
    the card alone, once per shape."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = lib.ft5_rms_norm_plan(int(backward), rows, d, _CODES[x_dtype],
                                   _CODES[y_dtype], int(vec), out)
    runtime.check_launch(lib, rc, "rms_norm plan")
    return tuple(out)


_TICKETS = {}


def _tickets(device: torch.device, stream: int) -> torch.Tensor:
    """The backward's arrival tickets for this device and stream: zeroed
    once, and left at zero by each launch's last CTAs."""
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros((_MAX_CLUSTER,), dtype=torch.int32,
                                    device=device)
    return _TICKETS[key]


def _check(name: str, x: torch.Tensor, w: torch.Tensor, *more) -> None:
    d = x.shape[-1] if x.dim() else 0
    if x.dtype not in _FLOAT_TYPES or w.dtype not in _FLOAT_TYPES:
        raise TypeError(f"{name}: unsupported dtypes {x.dtype}, {w.dtype}")
    if not x.is_cuda or any(t.device != x.device for t in (w, *more)):
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")
    if d < 1 or w.shape != (d,):
        raise ValueError(f"{name}: w {tuple(w.shape)} for x "
                         f"{tuple(x.shape)}")


def _vectors(d: int, *ts: torch.Tensor) -> bool:
    """Whether rows are whole 16-byte vectors of the first tensor's type and
    each tensor is aligned to 16 bytes and to its vectors of as many
    elements."""
    v = 16 // ts[0].element_size()
    return d % v == 0 and all(
        t.data_ptr() % max(16, v * t.element_size()) == 0 for t in ts)


def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
                 cast_w: bool = False):
    """Fused RMS norm over the last axis: (y, rstd). x (..., d), w (d,) in
    any of f32, bf16, f16 (rounded to x.dtype as it is loaded where
    `cast_w`).

    A CUDA tensor goes to the kernel, a CPU tensor to `rms_norm_plain`;
    anything the kernel does not take raises."""
    d = x.shape[-1]
    if x.device.type == "cpu":
        return rms_norm_plain(x, w, eps, cast_w=cast_w)
    _check("rms_norm", x, w)
    x2 = x.reshape(-1, d).contiguous()
    w = w.contiguous()
    rows = x2.shape[0]
    y = torch.empty_like(x2)
    rstd = torch.empty((rows,), dtype=torch.float32, device=x.device)
    vec = _vectors(d, x2, w)
    grid = plan(False, rows, d, x.dtype, x.dtype, vec, x.device.index)[2]
    lib = _lib()
    rc = lib.ft5_rms_norm_fwd(
        runtime.ptr(x2), runtime.ptr(w), runtime.ptr(y), runtime.ptr(rstd),
        rows, d, float(eps), _CODES[x.dtype], _CODES[w.dtype], int(cast_w),
        int(vec), grid, runtime.stream_handle(x))
    runtime.check_launch(lib, rc, "rms_norm")
    rms_norm_fwd.launches += 1
    return y.reshape(x.shape), rstd.reshape(x.shape[:-1])


rms_norm_fwd.launches = 0


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                 dy: torch.Tensor, *, cast_w: bool = False):
    """Gradient of the fused RMS norm: (dx in dy.dtype, fp32 dW). Where
    `cast_w`, w is rounded to x.dtype as it is loaded and dW's values to
    x.dtype as they are stored, the gradient of `rms_norm_fwd`'s cast.

    A CUDA tensor goes to the kernel (dx and dW in one launch), a CPU
    tensor to `rms_norm_bwd_plain`; anything the kernel does not take
    raises."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, w, rstd, dy, cast_w=cast_w)
    _check("rms_norm_bwd", x, w, rstd, dy)
    if dy.shape != x.shape or dy.dtype not in _FLOAT_TYPES:
        raise ValueError(f"rms_norm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"for x {tuple(x.shape)}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    dy2 = dy.reshape(-1, d).contiguous()
    r = rstd.reshape(-1).float().contiguous()
    w = w.contiguous()
    rows = x2.shape[0]
    if r.numel() != rows:
        raise ValueError(f"rms_norm_bwd: rstd {tuple(rstd.shape)} for x "
                         f"{tuple(x.shape)}")
    dx = torch.empty_like(dy2)
    vec = _vectors(d, x2, w, dy2, dx)
    _, _, grid, cluster = plan(True, rows, d, x.dtype, dy.dtype, vec,
                               x.device.index)
    dw = torch.empty((d,), dtype=torch.float32, device=x.device)
    part = torch.empty(((grid + grid // cluster) * d,), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib()
    rc = lib.ft5_rms_norm_bwd(
        runtime.ptr(x2), runtime.ptr(w), runtime.ptr(r), runtime.ptr(dy2),
        runtime.ptr(dx), runtime.ptr(dw), runtime.ptr(part),
        runtime.ptr(_tickets(x.device, stream)), rows, d, _CODES[x.dtype],
        _CODES[w.dtype], _CODES[dy.dtype], int(vec), grid, cluster,
        int(cast_w), ctypes.c_void_p(stream))
    runtime.check_launch(lib, rc, "rms_norm_bwd")
    rms_norm_bwd.launches += 1
    return dx.reshape(dy.shape), dw


rms_norm_bwd.launches = 0


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps, cast_w):
        y, rstd = rms_norm_fwd(x, w, eps, cast_w=cast_w)
        ctx.save_for_backward(x, w, rstd)
        ctx.cast_w = cast_w
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, rstd, dy, cast_w=ctx.cast_w)
        return dx, dw.to(w.dtype), None, None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
             cast_w: bool = False) -> torch.Tensor:
    """Fused RMS norm over the last axis, differentiable in x and w: the JAX
    op `flasht5_tpu.ops.rmsnorm.rms_norm`, w taken as stored and its
    gradient in w's dtype. With `cast_w` the result is that of
    `rms_norm(x, w.to(x.dtype))` and w's gradient that cast's, with no
    launch for the cast (the model's `_layer_norm`)."""
    return _RMSNormFn.apply(x, w, eps, cast_w)
