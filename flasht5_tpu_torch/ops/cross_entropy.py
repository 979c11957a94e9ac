"""Fused cross-entropy with z-loss and label smoothing: the plain oracle, the
forward and backward kernels in Triton with their plain versions, and the
differentiable op.

Replaces the Pallas kernels of `flasht5_tpu/ops/cross_entropy.py`: the
vocab-tiled pair `_fwd_kernel_tiled` / `_bwd_kernel_tiled` (the default) and
the whole-row pair `_fwd_kernel` / `_bwd_kernel`, which compute the same
function. As in the JAX package's tiled path, the forward kernel is a pure
streaming log-sum-exp (plus the row sum of the logits when smoothing is on);
the label-logit gather and the loss assembly on (rows,) vectors stay plain
PyTorch. The backward kernel is one elementwise pass over (rows, V).

Bound on the H100: bytes. At the FAT5-small train step (2048 rows, vocab
32768, bf16 logits) the forward reads the 134 MB of logits once and the
backward reads them and writes dlogits once, against a few operations per
element. Each forward program streams a block of rows through the
vocabulary in tiles, keeping the running maximum and sum of exponentials of
each row in registers; the vocabulary need not be a multiple of the tile.

The vocab-split form (the JAX op's `total_classes`, `class_start_idx` and
`split`, a shard of the vocabulary in each call) runs through the same two
kernels: labels are shifted by `class_start_idx`, a label owned by another
shard keeps only the smoothing part, smoothing is spread over
`total_classes`, and `split=True` leaves the lse term and the z-loss out of
the shard's partial loss (the caller adds the global lse). As in the JAX
package, the backward reads the shard's own lse whatever `split` says.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

_IGNORE = -100
_FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16)
_FWD_ROWS, _FWD_BLOCK_V = 4, 1024
_BWD_ROWS, _BWD_BLOCK_V = 4, 1024


def cross_entropy_loss_ref(logits: torch.Tensor, labels: torch.Tensor, *,
                           lse_square_scale: float = 0.0,
                           label_smoothing: float = 0.0,
                           logit_scale: float = 1.0,
                           ignore_index: int = _IGNORE
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (loss, z_loss) in fp32. logits: (rows, V); labels: (rows,)."""
    logits = logits.float() * logit_scale
    v = logits.shape[1]
    lse = torch.logsumexp(logits, dim=-1)
    safe_labels = torch.where(labels == ignore_index, 0, labels)
    label_logit = torch.gather(logits, 1, safe_labels[:, None].long())[:, 0]
    if label_smoothing > 0.0:
        loss = (lse - label_smoothing * torch.sum(logits, dim=-1) / v
                - (1.0 - label_smoothing) * label_logit)
    else:
        loss = lse - label_logit
    z_loss = lse_square_scale * lse * lse
    loss = loss + z_loss
    ignored = labels == ignore_index
    return (torch.where(ignored, 0.0, loss),
            torch.where(ignored, 0.0, z_loss))


# ---------------------------------------------------------------------------
# plain versions of the kernels
# ---------------------------------------------------------------------------

def cross_entropy_fwd_plain(logits: torch.Tensor, *, logit_scale: float = 1.0,
                            label_smoothing: float = 0.0):
    """(fp32 lse, fp32 row sum of the scaled logits or None without
    smoothing) per row: the forward kernel's function."""
    x = logits.float()
    if logit_scale != 1.0:
        x = x * logit_scale
    lse = torch.logsumexp(x, dim=-1)
    return lse, (x.sum(dim=-1) if label_smoothing > 0.0 else None)


def cross_entropy_bwd_plain(logits, labels, lse, dloss, dz, *,
                            lse_square_scale=0.0, label_smoothing=0.0,
                            logit_scale=1.0, ignore_index=_IGNORE,
                            total_classes=None, class_start_idx=0):
    """dlogits in the logits' dtype: the backward kernel's function,
    dloss (p - (1 - ls) onehot - ls / V) + (dloss + dz) 2 s lse p, scaled
    by `logit_scale`; ignored rows are zero. V is `total_classes`, by
    default the logits' width; the one-hot sits at column label -
    `class_start_idx` (nowhere for a label of another shard)."""
    x = logits.float() * logit_scale
    v = x.shape[1]
    ignored = labels == ignore_index
    dloss = torch.where(ignored, 0.0, dloss.float())
    dz = torch.where(ignored, 0.0, dz.float())
    probs = torch.exp(x - lse[:, None])
    onehot = (torch.arange(v, device=x.device)[None, :]
              == labels.long()[:, None] - class_start_idx)
    if label_smoothing > 0.0:
        ce_grad = (probs - label_smoothing / (total_classes or v)
                   - torch.where(onehot, 1.0 - label_smoothing, 0.0))
    else:
        ce_grad = probs - torch.where(onehot, 1.0, 0.0)
    z_grad = (2.0 * lse_square_scale * lse)[:, None] * probs
    grad = dloss[:, None] * ce_grad + (dloss + dz)[:, None] * z_grad
    return (grad * logit_scale).to(logits.dtype)


# ---------------------------------------------------------------------------
# Triton kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _triton_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def ce_fwd_kernel(logits_ptr, lse_ptr, sum_ptr, n_rows, n_cols, logit_scale,
            ROWS: tl.constexpr, BLOCK_V: tl.constexpr, SMOOTH: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        rmask = rows < n_rows
        base = rows[:, None].to(tl.int64) * n_cols
        m = tl.full((ROWS,), -1e30, tl.float32)
        se = tl.zeros((ROWS,), tl.float32)
        sl = tl.zeros((ROWS,), tl.float32)
        for v0 in range(0, n_cols, BLOCK_V):
            cols = v0 + tl.arange(0, BLOCK_V)
            mask = rmask[:, None] & (cols < n_cols)[None, :]
            x = tl.load(logits_ptr + base + cols[None, :], mask=mask,
                        other=0.0).to(tl.float32) * logit_scale
            xm = tl.where(mask, x, -float("inf"))
            m_new = tl.maximum(m, tl.max(xm, axis=1))
            p = tl.exp(xm - m_new[:, None])
            se = se * tl.exp(m - m_new) + tl.sum(p, axis=1)
            m = m_new
            if SMOOTH:
                sl += tl.sum(tl.where(mask, x, 0.0), axis=1)
        tl.store(lse_ptr + rows, tl.log(se) + m, mask=rmask)
        if SMOOTH:
            tl.store(sum_ptr + rows, sl, mask=rmask)

    @triton.jit
    def ce_bwd_kernel(logits_ptr, labels_ptr, lse_ptr, dloss_ptr, dz_ptr, dlogits_ptr,
            n_rows, n_cols, logit_scale, lse_square_scale, smoothing,
            ignore_index, class_start_idx, total_classes,
            ROWS: tl.constexpr, BLOCK_V: tl.constexpr, SMOOTH: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
        rmask = rows < n_rows
        mask = rmask[:, None] & (cols < n_cols)[None, :]
        offs = rows[:, None].to(tl.int64) * n_cols + cols[None, :]
        x = tl.load(logits_ptr + offs, mask=mask,
                    other=0.0).to(tl.float32) * logit_scale
        labels = tl.load(labels_ptr + rows, mask=rmask, other=ignore_index)
        lse = tl.load(lse_ptr + rows, mask=rmask, other=0.0)
        ignored = labels == ignore_index
        dloss = tl.where(ignored, 0.0,
                         tl.load(dloss_ptr + rows, mask=rmask, other=0.0))
        dz = tl.where(ignored, 0.0,
                      tl.load(dz_ptr + rows, mask=rmask, other=0.0))
        probs = tl.exp(x - lse[:, None])
        onehot = cols[None, :] == (labels - class_start_idx)[:, None]
        if SMOOTH:
            ce_grad = (probs - smoothing / total_classes
                       - tl.where(onehot, 1.0 - smoothing, 0.0))
        else:
            ce_grad = probs - tl.where(onehot, 1.0, 0.0)
        z_grad = (2.0 * lse_square_scale * lse)[:, None] * probs
        grad = dloss[:, None] * ce_grad + (dloss + dz)[:, None] * z_grad
        grad = grad * logit_scale
        tl.store(dlogits_ptr + offs, grad.to(dlogits_ptr.dtype.element_ty),
                 mask=mask)

    return triton, ce_fwd_kernel, ce_bwd_kernel


def _check(name: str, logits: torch.Tensor, *rows_tensors) -> None:
    if logits.dtype not in _FLOAT_TYPES or logits.dim() != 2:
        raise TypeError(f"{name}: logits {logits.dtype} "
                        f"{tuple(logits.shape)}; a float (rows, V) matrix")
    if not logits.is_cuda or any(t.device != logits.device
                                 for t in rows_tensors):
        raise ValueError(f"{name}: all inputs on one CUDA device")
    if any(t.shape != logits.shape[:1] for t in rows_tensors):
        raise ValueError(f"{name}: per-row inputs "
                         f"{[tuple(t.shape) for t in rows_tensors]} for "
                         f"{logits.shape[0]} rows")


def cross_entropy_fwd(logits: torch.Tensor, *, logit_scale: float = 1.0,
                      label_smoothing: float = 0.0):
    """(fp32 lse, fp32 row sum of the scaled logits or None) per row.
    A CUDA tensor goes to the Triton kernel, a CPU tensor to
    `cross_entropy_fwd_plain`; anything else raises."""
    if logits.device.type == "cpu":
        return cross_entropy_fwd_plain(logits, logit_scale=logit_scale,
                                       label_smoothing=label_smoothing)
    _check("cross_entropy_fwd", logits)
    triton, kernel, _ = _triton_kernels()
    logits = logits.contiguous()
    rows, v = logits.shape
    smooth = label_smoothing > 0.0
    lse = torch.empty((rows,), dtype=torch.float32, device=logits.device)
    total = torch.empty_like(lse) if smooth else lse
    kernel[(triton.cdiv(rows, _FWD_ROWS),)](
        logits, lse, total, rows, v, float(logit_scale), ROWS=_FWD_ROWS,
        BLOCK_V=_FWD_BLOCK_V, SMOOTH=smooth, num_warps=8)
    cross_entropy_fwd.launches += 1
    return lse, (total if smooth else None)


cross_entropy_fwd.launches = 0


def cross_entropy_bwd(logits, labels, lse, dloss, dz, *,
                      lse_square_scale=0.0, label_smoothing=0.0,
                      logit_scale=1.0, ignore_index=_IGNORE,
                      total_classes=None, class_start_idx=0):
    """dlogits in the logits' dtype. A CUDA tensor goes to the Triton
    kernel, a CPU tensor to `cross_entropy_bwd_plain`; anything else
    raises."""
    kw = dict(lse_square_scale=lse_square_scale,
              label_smoothing=label_smoothing, logit_scale=logit_scale,
              ignore_index=ignore_index, total_classes=total_classes,
              class_start_idx=class_start_idx)
    if logits.device.type == "cpu":
        return cross_entropy_bwd_plain(logits, labels, lse, dloss, dz, **kw)
    _check("cross_entropy_bwd", logits, labels, lse, dloss, dz)
    triton, _, kernel = _triton_kernels()
    logits = logits.contiguous()
    rows, v = logits.shape
    dlogits = torch.empty_like(logits)
    kernel[(triton.cdiv(rows, _BWD_ROWS), triton.cdiv(v, _BWD_BLOCK_V))](
        logits, labels.to(torch.int32).contiguous(),
        lse.float().contiguous(), dloss.float().contiguous(),
        dz.float().contiguous(), dlogits, rows, v, float(logit_scale),
        float(lse_square_scale), float(label_smoothing), int(ignore_index),
        int(class_start_idx), float(total_classes or v), ROWS=_BWD_ROWS,
        BLOCK_V=_BWD_BLOCK_V, SMOOTH=label_smoothing > 0.0,
        num_warps=4)
    cross_entropy_bwd.launches += 1
    return dlogits


cross_entropy_bwd.launches = 0


def cross_entropy_assemble(logits, labels, lse, total, *,
                           lse_square_scale=0.0, label_smoothing=0.0,
                           logit_scale=1.0, ignore_index=_IGNORE,
                           total_classes=None, class_start_idx=0,
                           split=False):
    """Per-row (loss, z) from the forward kernel's lse (and row sum), as
    the JAX package's `_ce_fwd_tiled` assembles them outside its kernel;
    the CPU path and the card's share it."""
    v = logits.shape[1]
    tc = total_classes or v
    local = labels.long() - class_start_idx
    in_shard = (local >= 0) & (local < v)
    safe = local.clamp(0, v - 1)
    label_logit = torch.gather(logits, 1, safe[:, None])[:, 0].float() \
        * logit_scale
    lse_term = torch.zeros_like(lse) if split else lse
    if label_smoothing > 0.0:
        loss_in = (lse_term - label_smoothing * total / tc
                   - (1.0 - label_smoothing) * label_logit)
        loss_out = label_smoothing * (lse_term - total / tc)
        loss = torch.where(in_shard, loss_in, loss_out)
    else:
        loss = torch.where(in_shard, lse_term - label_logit, 0.0)
    if split:
        z = torch.zeros_like(lse)
    else:
        z = lse_square_scale * lse * lse
        loss = loss + z
    ignored = labels == ignore_index
    return torch.where(ignored, 0.0, loss), torch.where(ignored, 0.0, z)


class _CrossEntropyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, kw, split):
        lse, total = cross_entropy_fwd(
            logits, logit_scale=kw["logit_scale"],
            label_smoothing=kw["label_smoothing"])
        loss, z = cross_entropy_assemble(logits, labels, lse, total,
                                         split=split, **kw)
        ctx.save_for_backward(logits, labels, lse)
        ctx.kw = kw
        return loss, z

    @staticmethod
    def backward(ctx, dloss, dz):
        logits, labels, lse = ctx.saved_tensors
        dloss = torch.zeros_like(lse) if dloss is None else dloss
        dz = torch.zeros_like(lse) if dz is None else dz
        dlogits = cross_entropy_bwd(logits, labels, lse, dloss, dz, **ctx.kw)
        return dlogits, None, None, None


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       lse_square_scale: float = 0.0,
                       label_smoothing: float = 0.0,
                       logit_scale: float = 1.0,
                       ignore_index: int = _IGNORE,
                       total_classes: Optional[int] = None,
                       class_start_idx: int = 0,
                       split: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused per-row (loss, z_loss), differentiable in the logits; reduce
    outside (the model reproduces the reference's mean over all rows).
    With a vocab shard (`class_start_idx`, `total_classes`, `split`) the
    JAX op's per-shard partial loss."""
    kw = dict(lse_square_scale=lse_square_scale,
              label_smoothing=label_smoothing, logit_scale=logit_scale,
              ignore_index=ignore_index, total_classes=total_classes,
              class_start_idx=class_start_idx)
    return _CrossEntropyFn.apply(logits, labels, kw, split)
