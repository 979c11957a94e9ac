"""Fused lm_head matmul + cross-entropy: the logits never reach device memory.

Replaces the Pallas kernels of `flasht5_tpu/ops/fused_linear_ce.py`:
`_fwd_kernel` (launched at its :253) and `_bwd_kernel` (:320). The CUDA
kernels are in `csrc/fused_linear_ce.cu`, which says what bounds them and
how they are laid out; beside each is its plain PyTorch version, which
computes the same function with the logits materialized.

- forward kernel: logits = x @ w (w rounded to x's dtype, f32 sums, times
  `logit_scale`), reduced on the fly to each row's log-sum-exp and, with
  label smoothing, the row sum of the logits; for bf16 activations w is
  first rounded and transposed into a scratch of at most `WORKSPACE_BYTES`,
  a vocabulary slab at a time (`fwd_plan`), or, for few rows and an f32 w,
  rounded in shared memory as its tiles load;
- backward kernels: dlogits from the probabilities, the one-hot label, the
  smoothing and z-loss terms, rounded to x's dtype, then dx = dl @ w^T
  (x's dtype) and dW = x^T dl (f32 sums, stored in w's dtype). For bf16
  activations the logits are computed once per (row, vocab) tile: chunks
  of rows by slabs of the vocabulary, each slab's bf16 dlogits in a
  workspace of at most `WORKSPACE_BYTES` (`bwd_plan`), contracted by two
  hand-written GEMMs; f32 activations take the CUDA-core kernels, which
  recompute the logits in the dx and dW kernels.

As in the JAX package, the label-logit gather (a column of w per row) and
the loss assembly on (rows,) vectors stay plain PyTorch around the forward
kernel. `fused_linear_cross_entropy` is the differentiable op; its
backward runs the backward kernels only.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.ops.cross_entropy import cross_entropy_bwd_plain

_IGNORE = -100
_X_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 backward's scratch (`bwd_plan`: dx's f32 sums and split
# partials for a chunk of rows, a vocabulary slab's dlogits and rounded
# weight) stays within this many bytes for any rows and vocabulary, and any
# d up to ~90,000. 60 MiB: under 64 MB either way that is read.
WORKSPACE_BYTES = 60 * 2 ** 20
_TILE = 128          # rows and columns of a GEMM tile (fused_linear_ce.cu)
_MAX_SPLITS = 16


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
        lib.ft5_flce_fwd.argtypes = [vp] * 6 + [i] * 8 + [f, i, vp]
        lib.ft5_flce_merge.argtypes = [vp] * 5 + [i] * 3 + [vp]
        lib.ft5_flce_bwd.argtypes = ([vp] * 9 + [i] * 9 + [f] * 3 + [vp])
        lib.ft5_flce_bwd_mma.argtypes = ([vp] * 13 + [i] * 10 + [f] * 3
                                         + [vp])
        for fn in (lib.ft5_flce_fwd, lib.ft5_flce_merge, lib.ft5_flce_bwd,
                   lib.ft5_flce_bwd_mma):
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


def fwd_plan(rows: int, d: int, v: int, sms: int = 132,
             convert: bool = False) -> Tuple[int, int, int]:
    """(vocabulary columns per slab, vocab tiles of 128 per split, splits in
    all) of the bf16 forward on TMA + wgmma.

    Each slab's w^T in bf16 (slab x d) fits WORKSPACE_BYTES (one slab up to
    d 960 at V 32768), the slabs evened out to multiples of 128; with
    `convert` (the form that rounds an f32 lm_head in shared memory) one
    slab is the whole vocabulary and there is no scratch. A CTA takes 128
    rows and one split of a slab's tiles; the splits give about one CTA for
    each of the card's `sms` SMs (each CTA holds ~200 KB of shared memory),
    and no split is empty. The splits of slab s follow those of slabs
    0..s-1 in the partials."""
    if convert:
        slab = -(-v // _TILE) * _TILE
    else:
        slab = max(_TILE, WORKSPACE_BYTES // (2 * d) // _TILE * _TILE)
        n_slabs = -(-v // slab)
        slab = -(-(-(-v // n_slabs)) // _TILE) * _TILE
    tiles = -(-min(slab, v) // _TILE)
    row_blocks = max(1, -(-rows // _TILE))
    per = -(-tiles // max(1, min(tiles, sms // row_blocks)))
    splits = sum(-(-(-(-min(slab, v - v0) // _TILE)) // per)
                 for v0 in range(0, v, slab))
    return slab, per, splits


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fwd_tma(x: torch.Tensor) -> bool:
    """Whether the bf16 forward's TMA tiles can describe x (made contiguous
    and 16-byte aligned by `_aligned`): its rows must be 16-byte multiples."""
    return x.dtype == torch.bfloat16 and x.shape[1] % 8 == 0


# Up to this many rows the bf16 forward rounds an f32 lm_head in shared
# memory, each row block's CTAs reading its f32 tiles (from the L2 after
# the first); more rows round it once into the scratch, whose bf16 tiles
# cost half the bytes to read again. On an H100 80GB HBM3 (`chip_smoke.py
# --probe`, d 512 and 768) the shared-memory form is the faster at 256 and
# 512 rows, the scratch form from 768 rows on.
CONVERT_ROWS = 512


def _fwd_convert(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the forward rounds w in shared memory: an f32 w whose rows
    TMA can describe, at most CONVERT_ROWS rows."""
    return (w.dtype == torch.float32 and w.shape[1] % 4 == 0
            and w.data_ptr() % 16 == 0 and x.shape[0] <= CONVERT_ROWS)


def fwd_partials(x: torch.Tensor, w: torch.Tensor, *, logit_scale=1.0,
                 label_smoothing=0.0) -> torch.Tensor:
    """The forward kernel's first pass: (3, splits, rows) f32 partial
    (max, sum of exp, sum of logits) of each row over each vocab split."""
    lib = _lib()
    x, w = _aligned(x), w.contiguous()
    rows, d = x.shape
    v = w.shape[1]
    wt, slab, per = None, 0, 0
    if _fwd_tma(x):
        convert = _fwd_convert(x, w)
        slab, per, splits = fwd_plan(rows, d, v, _sms(x.device), convert)
        if not convert:
            wt = torch.empty((min(slab, v), d), dtype=torch.bfloat16,
                             device=x.device)
    else:
        splits = lib.ft5_flce_splits(rows, d, v, 0)
    part = torch.empty((3, splits, rows), dtype=torch.float32,
                       device=x.device)
    xc, wc = _type_codes(x, w)
    rc = lib.ft5_flce_fwd(runtime.ptr(x), runtime.ptr(w), runtime.ptr(wt),
                          runtime.ptr(part[0]), runtime.ptr(part[1]),
                          runtime.ptr(part[2]), rows, d, v, splits, slab,
                          per, xc, wc, float(logit_scale),
                          int(label_smoothing > 0.0),
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


def max_chunk_rows(d: int) -> int:
    """The most rows a chunk of the bf16 backward takes at width d: dx's
    f32 sums and one split's f32 partials (8 bytes a row and column of d)
    within three fifths of WORKSPACE_BYTES, the rest left to a vocabulary
    slab's dlogits and rounded weight (a multiple of 128, at least 128)."""
    return max(_TILE, WORKSPACE_BYTES * 3 // 5 // (8 * d) // _TILE * _TILE)


def bwd_plan(rows: int, d: int, v: int, cast: bool = True,
             sms: int = 132) -> Tuple[int, int, int]:
    """(rows per chunk, vocabulary columns per slab, K splits of the dx
    GEMM) of the bf16 backward, all within WORKSPACE_BYTES.

    The rows go in as few chunks of at most `max_chunk_rows(d)` as they
    need, evened out to multiples of 128. A chunk's workspace is dx's f32
    sums and the dx GEMM's f32 partials (splits + 1 of (chunk x d)), and
    per slab its bf16 dlogits (chunk x slab) and, with `cast` (an f32
    lm_head, or a bf16 one whose rows are not 16-byte aligned), the slab's
    weight rounded to bf16 (d x slab). The splits give the dx GEMM, whose
    (chunk x d) output may have fewer 128 x 128 tiles than the card's `sms`
    SMs, about two CTAs an SM; the slab takes the rest, evened out over the
    vocabulary to a multiple of 128."""
    n_chunks = max(1, -(-rows // max_chunk_rows(d)))
    chunk = max(_TILE, -(-(-(-rows // n_chunks)) // _TILE) * _TILE)
    live = max(1, min(chunk, rows))
    tiles = -(-live // _TILE) * -(-d // _TILE)
    splits = 1 if tiles >= sms else min(_MAX_SPLITS, -(-2 * sms // tiles))
    per_col = 2 * live + (2 * d if cast else 0)

    def fixed(s):
        return live * d * 4 * (s + 1)

    while splits > 1 and fixed(splits) + _TILE * per_col > WORKSPACE_BYTES:
        splits -= 1
    slab = max(_TILE, (WORKSPACE_BYTES - fixed(splits)) // per_col
               // _TILE * _TILE)
    n_slabs = -(-v // slab)
    slab = -(-(-(-v // n_slabs)) // _TILE) * _TILE
    return chunk, slab, splits


def _bwd_scratch(rows: int, d: int, w: torch.Tensor, sms: int):
    """The bf16 backward's plan and scratch: ((chunk, slab, splits),
    {name: (shape, dtype) or None}) for dlogits `dl`, the rounded weight
    `wb`, the dx partials `part` and f32 sums `dx_acc`, and `dw_acc`, dW's
    f32 sums between row chunks for a bf16 lm_head (the only one outside
    WORKSPACE_BYTES: it is as large as an f32 dW)."""
    v = w.shape[1]
    # a bf16 lm_head with 16-byte rows is read in place
    cast = not (w.dtype == torch.bfloat16 and v % 8 == 0
                and w.data_ptr() % 16 == 0)
    chunk, slab, splits = bwd_plan(rows, d, v, cast, sms)
    live = min(chunk, rows)
    f32, bf16 = torch.float32, torch.bfloat16
    return (chunk, slab, splits), dict(
        dl=((live, slab), bf16), wb=((d, slab), bf16) if cast else None,
        part=((splits, live, d), f32),
        dx_acc=((live, d), f32) if v > slab else None,
        dw_acc=((d, v), f32) if w.dtype != f32 and rows > chunk else None)


def bwd_workspace_bytes(x: torch.Tensor, w: torch.Tensor) -> int:
    """Bytes of scratch the bf16 backward allocates for x @ w, on x's
    card (within WORKSPACE_BYTES but for a bf16 lm_head's dW sums)."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _, scratch = _bwd_scratch(x.shape[0], x.shape[1], w, sms)
    return sum(math.prod(shape) * torch.empty((), dtype=dt).element_size()
               for shape, dt in filter(None, scratch.values()))


def _bwd_mma(x, w, labels32, lse32, dloss32, dz32, kw, lib):
    """The bf16 backward: per chunk of rows and slab of the vocabulary, the
    slab's weight in bf16, its dlogits, then the dW and dx GEMMs
    (fused_linear_ce.cu)."""
    rows, d = x.shape
    v = w.shape[1]
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(w)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    (chunk, slab, splits), scratch = _bwd_scratch(rows, d, w, sms)
    t = {name: None if spec is None else
         torch.empty(spec[0], dtype=spec[1], device=x.device)
         for name, spec in scratch.items()}
    dw = torch.empty_like(w)
    rc = lib.ft5_flce_bwd_mma(
        runtime.ptr(x), runtime.ptr(w), runtime.ptr(labels32),
        runtime.ptr(lse32), runtime.ptr(dloss32), runtime.ptr(dz32),
        runtime.ptr(t["dl"]), runtime.ptr(t["wb"]), runtime.ptr(t["part"]),
        runtime.ptr(t["dx_acc"]), runtime.ptr(t["dw_acc"]), runtime.ptr(dx),
        runtime.ptr(dw), rows, d, v, chunk, slab, splits,
        int(kw["total_classes"] or v), int(kw["ignore_index"]),
        int(kw["label_smoothing"] > 0.0), int(w.dtype == torch.float32),
        float(kw["logit_scale"]), float(kw["lse_square_scale"]),
        float(kw["label_smoothing"]), runtime.stream_handle(x))
    runtime.check_launch(lib, rc, "fused_linear_ce_bwd")
    return dx, dw


def fused_linear_ce_bwd(x, w, labels, lse, dloss, dz, *,
                        lse_square_scale=0.0, label_smoothing=0.0,
                        logit_scale=1.0, ignore_index=_IGNORE,
                        total_classes=None):
    """(dx in x's dtype, dw in w's dtype). CUDA tensors go to the kernels:
    for bf16 activations the dlogits pass and the dx and dW GEMMs over
    chunks of rows (`bwd_plan`), for f32 the dx and dW kernels (the dx
    kernel's vocab splits summed by a third); no atomics, the same bits on
    every run. CPU tensors go to `fused_linear_ce_bwd_plain`; anything else
    raises."""
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
    # the per-row inputs in the kernel's types, held in locals until the
    # launch: a raw pointer does not keep a temporary's memory alive
    labels32 = labels.to(torch.int32).contiguous()
    lse32, dloss32, dz32 = (t.float().contiguous() for t in (lse, dloss, dz))
    if x.dtype == torch.bfloat16:
        dx, dw = _bwd_mma(x, w, labels32, lse32, dloss32, dz32, kw, lib)
        fused_linear_ce_bwd.launches += 1
        return dx, dw
    splits = lib.ft5_flce_splits(rows, d, v, 1)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    dx_part = torch.empty((splits, rows, d), dtype=torch.float32,
                          device=x.device)
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
