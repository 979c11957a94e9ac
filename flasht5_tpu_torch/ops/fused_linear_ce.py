"""Fused lm_head matmul + cross-entropy: the logits never reach device memory.

Replaces the Pallas kernels of `flasht5_tpu/ops/fused_linear_ce.py`:
`_fwd_kernel` (launched at its :253) and `_bwd_kernel` (:320). The CUDA
kernels are in `csrc/fused_linear_ce.cu`, which says what bounds them and
how they are laid out; beside each is its plain PyTorch version, which
computes the same function with the logits materialized.

- forward kernel: logits = x @ w (w rounded to x's dtype, f32 sums, times
  `logit_scale`), reduced on the fly to each row's log-sum-exp and, with
  label smoothing, the row sum of the logits;
- backward kernels: each recomputes its logits tile, forms dlogits from
  the probabilities, the one-hot label, the smoothing and z-loss terms,
  rounds them to x's dtype and contracts them at once: dx = dl @ w^T
  (x's dtype) and dW = x^T dl (f32 sums, stored in w's dtype).

As in the JAX package, the label-logit gather (a column of w per row) and
the loss assembly on (rows,) vectors stay plain PyTorch around the forward
kernel. `fused_linear_cross_entropy` is the differentiable op; its
backward runs the backward kernels only.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.ops.cross_entropy import cross_entropy_bwd_plain

_IGNORE = -100
_X_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions of the kernels
# ---------------------------------------------------------------------------

def _logits(x: torch.Tensor, w: torch.Tensor, logit_scale: float):
    """f32 logits of x @ w with w rounded to x's dtype, as the kernels form
    them (each product exact in f32, f32 sums)."""
    logits = x.float() @ w.to(x.dtype).float()
    return logits * logit_scale if logit_scale != 1.0 else logits


def fused_linear_ce_fwd_plain(x: torch.Tensor, w: torch.Tensor, *,
                              logit_scale: float = 1.0,
                              label_smoothing: float = 0.0
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(f32 lse, f32 row sum of the scaled logits or None without
    smoothing) per row of x: the forward kernel's function. The running
    maximum is floored at -1e30, as in the TPU kernel."""
    logits = _logits(x, w, logit_scale)
    m = torch.clamp(logits.amax(dim=-1), min=-1e30)
    lse = torch.log(torch.exp(logits - m[:, None]).sum(dim=-1)) + m
    return lse, (logits.sum(dim=-1) if label_smoothing > 0.0 else None)


def fused_linear_ce_bwd_plain(x, w, labels, lse, dloss, dz, *,
                              lse_square_scale=0.0, label_smoothing=0.0,
                              logit_scale=1.0, ignore_index=_IGNORE,
                              total_classes=None):
    """(dx in x's dtype, dw in w's dtype): the backward kernels' function.
    dlogits are rounded to x's dtype before both contractions (the TPU
    kernel's :159); dW is summed in f32 and then cast to w's dtype.
    Ignored rows contribute nothing."""
    dl = cross_entropy_bwd_plain(
        _logits(x, w, 1.0), labels, lse.float(), dloss, dz,
        lse_square_scale=lse_square_scale, label_smoothing=label_smoothing,
        logit_scale=logit_scale, ignore_index=ignore_index,
        total_classes=total_classes).to(x.dtype).float()
    wc = w.to(x.dtype).float()
    return (dl @ wc.t()).to(x.dtype), (x.float().t() @ dl).to(w.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _lib():
    lib = runtime.kernel_library("fused_linear_ce")
    if lib.ft5_flce_fwd.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ft5_flce_splits.argtypes = [i] * 4
        lib.ft5_flce_splits.restype = i
        lib.ft5_flce_fwd.argtypes = [vp] * 5 + [i] * 6 + [f, i, vp]
        lib.ft5_flce_merge.argtypes = [vp] * 5 + [i] * 3 + [vp]
        lib.ft5_flce_bwd.argtypes = ([vp] * 9 + [i] * 9 + [f] * 3 + [vp])
        for fn in (lib.ft5_flce_fwd, lib.ft5_flce_merge, lib.ft5_flce_bwd):
            fn.restype = i
    return lib


def _check(name: str, x: torch.Tensor, w: torch.Tensor, *rows_tensors):
    if x.dtype not in _X_CODES or w.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"{name}: x {x.dtype}, w {w.dtype}; x f32 or bf16, "
                        f"w in x's dtype or f32")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} @ w {tuple(w.shape)}")
    if x.shape[1] == 0:
        raise ValueError(f"{name}: d = 0")
    if not x.is_cuda or any(t.device != x.device
                            for t in (w,) + rows_tensors):
        raise ValueError(f"{name}: all inputs on one CUDA device")
    if any(t.shape != x.shape[:1] for t in rows_tensors):
        raise ValueError(f"{name}: per-row inputs "
                         f"{[tuple(t.shape) for t in rows_tensors]} for "
                         f"{x.shape[0]} rows")


def _type_codes(x, w):
    return _X_CODES[x.dtype], int(w.dtype != x.dtype)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and 16-byte aligned (the kernels load its rows in
    16-byte vectors)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def fwd_partials(x: torch.Tensor, w: torch.Tensor, *, logit_scale=1.0,
                 label_smoothing=0.0) -> torch.Tensor:
    """The forward kernel's first pass: (3, splits, rows) f32 partial
    (max, sum of exp, sum of logits) of each row over each vocab split."""
    lib = _lib()
    x, w = _aligned(x), w.contiguous()
    rows, d = x.shape
    v = w.shape[1]
    splits = lib.ft5_flce_splits(rows, d, v, 0)
    part = torch.empty((3, splits, rows), dtype=torch.float32,
                       device=x.device)
    xc, wc = _type_codes(x, w)
    rc = lib.ft5_flce_fwd(runtime.ptr(x), runtime.ptr(w),
                          runtime.ptr(part[0]), runtime.ptr(part[1]),
                          runtime.ptr(part[2]), rows, d, v, splits, xc, wc,
                          float(logit_scale), int(label_smoothing > 0.0),
                          runtime.stream_handle(x))
    runtime.check_launch(lib, rc, "fused_linear_ce_fwd")
    return part


def merge_partials(part: torch.Tensor, splits: int):
    """The forward kernel's second pass: (lse, row sum of the logits) from
    the first `splits` vocab splits of `part`."""
    lib = _lib()
    rows = part.shape[2]
    lse = torch.empty((rows,), dtype=torch.float32, device=part.device)
    total = torch.empty_like(lse)
    rc = lib.ft5_flce_merge(runtime.ptr(part[0]), runtime.ptr(part[1]),
                            runtime.ptr(part[2]), runtime.ptr(lse),
                            runtime.ptr(total), rows, part.shape[1], splits,
                            runtime.stream_handle(part))
    runtime.check_launch(lib, rc, "fused_linear_ce_fwd (merge)")
    return lse, total


def fused_linear_ce_fwd(x: torch.Tensor, w: torch.Tensor, *,
                        logit_scale: float = 1.0,
                        label_smoothing: float = 0.0):
    """(f32 lse, f32 row sum of the scaled logits or None) per row of
    x @ w. CUDA tensors go to the kernels (a split-vocab pass and its
    merge), CPU tensors to `fused_linear_ce_fwd_plain`; anything else
    raises."""
    if x.device.type == "cpu":
        return fused_linear_ce_fwd_plain(x, w, logit_scale=logit_scale,
                                         label_smoothing=label_smoothing)
    _check("fused_linear_ce_fwd", x, w)
    part = fwd_partials(x, w, logit_scale=logit_scale,
                        label_smoothing=label_smoothing)
    lse, total = merge_partials(part, part.shape[1])
    fused_linear_ce_fwd.launches += 1
    return lse, (total if label_smoothing > 0.0 else None)


fused_linear_ce_fwd.launches = 0


def fused_linear_ce_bwd(x, w, labels, lse, dloss, dz, *,
                        lse_square_scale=0.0, label_smoothing=0.0,
                        logit_scale=1.0, ignore_index=_IGNORE,
                        total_classes=None):
    """(dx in x's dtype, dw in w's dtype). CUDA tensors go to the dx and
    dW kernels (the dx kernel's vocab splits summed by a third, in a fixed
    order: no atomics, the same bits on every run), CPU tensors to
    `fused_linear_ce_bwd_plain`; anything else raises."""
    kw = dict(lse_square_scale=lse_square_scale,
              label_smoothing=label_smoothing, logit_scale=logit_scale,
              ignore_index=ignore_index, total_classes=total_classes)
    if x.device.type == "cpu":
        return fused_linear_ce_bwd_plain(x, w, labels, lse, dloss, dz, **kw)
    _check("fused_linear_ce_bwd", x, w, labels, lse, dloss, dz)
    lib = _lib()
    x, w = _aligned(x), w.contiguous()
    rows, d = x.shape
    v = w.shape[1]
    splits = lib.ft5_flce_splits(rows, d, v, 1)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    dx_part = torch.empty((splits, rows, d), dtype=torch.float32,
                          device=x.device)
    # the per-row inputs in the kernel's types, held in locals until the
    # launch: a raw pointer does not keep a temporary's memory alive
    labels32 = labels.to(torch.int32).contiguous()
    lse32, dloss32, dz32 = (t.float().contiguous() for t in (lse, dloss, dz))
    xc, wc = _type_codes(x, w)
    rc = lib.ft5_flce_bwd(
        runtime.ptr(x), runtime.ptr(w), runtime.ptr(labels32),
        runtime.ptr(lse32), runtime.ptr(dloss32), runtime.ptr(dz32),
        runtime.ptr(dx_part), runtime.ptr(dx), runtime.ptr(dw),
        rows, d, v, splits,
        int(total_classes or v), int(ignore_index),
        int(label_smoothing > 0.0), xc, wc, float(logit_scale),
        float(lse_square_scale), float(label_smoothing),
        runtime.stream_handle(x))
    runtime.check_launch(lib, rc, "fused_linear_ce_bwd")
    fused_linear_ce_bwd.launches += 1
    return dx, dw


fused_linear_ce_bwd.launches = 0


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

class _FusedLinearCEFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, lse_square_scale, label_smoothing,
                logit_scale, ignore_index, total_classes):
        v = w.shape[1]
        lse, total = fused_linear_ce_fwd(x, w, logit_scale=logit_scale,
                                         label_smoothing=label_smoothing)
        # the label logit from a column of w per row, not from the logits
        # (the JAX package's :272-277)
        safe = labels.long().clamp(0, v - 1)
        wl = w[:, safe].to(x.dtype).float()                 # (d, rows)
        label_logit = (x.float() * wl.t()).sum(dim=-1) * logit_scale
        if label_smoothing > 0.0:
            loss = (lse - label_smoothing * total / (total_classes or v)
                    - (1.0 - label_smoothing) * label_logit)
        else:
            loss = lse - label_logit
        z = lse_square_scale * lse * lse
        loss = loss + z
        ignored = labels == ignore_index
        ctx.save_for_backward(x, w, labels, lse)
        ctx.kw = dict(lse_square_scale=lse_square_scale,
                      label_smoothing=label_smoothing,
                      logit_scale=logit_scale, ignore_index=ignore_index,
                      total_classes=total_classes)
        return torch.where(ignored, 0.0, loss), torch.where(ignored, 0.0, z)

    @staticmethod
    def backward(ctx, dloss, dz):
        x, w, labels, lse = ctx.saved_tensors
        dloss = torch.zeros_like(lse) if dloss is None else dloss
        dz = torch.zeros_like(lse) if dz is None else dz
        dx, dw = fused_linear_ce_bwd(x, w, labels, lse, dloss, dz, **ctx.kw)
        return dx, dw, None, None, None, None, None, None


def fused_linear_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                               labels: torch.Tensor,
                               lse_square_scale: float = 0.0,
                               label_smoothing: float = 0.0,
                               logit_scale: float = 1.0,
                               ignore_index: int = _IGNORE,
                               total_classes: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row f32 (loss, z_loss) of softmax cross-entropy over the logits
    x @ w. x: (rows, d) activations; w: (d, V) lm_head weight (rounded to
    x's dtype for the products); labels: (rows,) int. Reduce outside.
    Gradients flow to x and w; the logits are never materialized."""
    return _FusedLinearCEFn.apply(x, w, labels, lse_square_scale,
                                  label_smoothing, logit_scale, ignore_index,
                                  total_classes)
