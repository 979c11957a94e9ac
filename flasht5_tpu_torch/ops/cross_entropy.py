"""Fused cross-entropy with z-loss and label smoothing: the plain oracle, the
forward and backward kernels in Triton with their plain versions, and the
differentiable op.

Replaces the Pallas kernels of `flasht5_tpu/ops/cross_entropy.py`: the
vocab-tiled pair `_fwd_kernel_tiled` / `_bwd_kernel_tiled` (the default) and
the whole-row pair `_fwd_kernel` / `_bwd_kernel`, which compute the same
function. The forward kernel streams a block of rows through the
vocabulary in tiles, keeping each row's running maximum, sum of
exponentials and (under smoothing) sum of logits in registers, and in its
epilogue reads each row's label logit with one scalar load and writes the
row's loss and z-loss: the label gather and the loss assembly that the JAX
package does outside its kernel, on (rows,) vectors, happen there, so the
loss is one launch. The backward kernel is one elementwise pass over
(rows, V).

Bound on the H100: bytes. At the FAT5-small train step (2048 rows, vocab
32768, bf16 logits) the forward reads the 134 MB of logits once and the
backward reads them and writes dlogits once, against a few operations per
element; the vocabulary need not be a multiple of the tile.

The vocab-split form (the JAX op's `total_classes`, `class_start_idx` and
`split`, a shard of the vocabulary in each call) runs through the same two
kernels: labels are shifted by `class_start_idx`, a label owned by another
shard keeps only the smoothing part, smoothing is spread over
`total_classes`, and `split=True` leaves the lse term and the z-loss out of
the shard's partial loss. The forward writes one f32 (3, rows) buffer,
each row's (loss, lse, z-loss), with `split` (partial loss, the shard's
lse, 0); `cross_entropy_combine` (a second, small kernel) turns the first
two rows of every shard's buffer, stacked, into the loss in the same
layout: the global lse by log-sum-exp over the shards, the partials
summed, the global lse and its z-loss added (`parallel/vocab_parallel.py`
gathers them over the tensor group with one collective). As in the JAX package, the
backward of the one-shard op reads the shard's own lse whatever `split`
says.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

_IGNORE = -100
_FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16)
# the forward's row tile, vocabulary tile, warps and pipeline stages a
# program, chosen by `chip_smoke.py --ce-probe` at the split shard (2048,
# 8192) and the unsplit (2048, 32768) logits (PERF.md)
_FWD_ROWS, _FWD_BLOCK_V, _FWD_WARPS, _FWD_STAGES = 1, 4096, 4, 3
_COMBINE_BLOCK = 1024
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

def cross_entropy_fwd_plain(logits: torch.Tensor, labels: torch.Tensor, *,
                            lse_square_scale: float = 0.0,
                            label_smoothing: float = 0.0,
                            logit_scale: float = 1.0,
                            ignore_index: int = _IGNORE,
                            total_classes: Optional[int] = None,
                            class_start_idx: int = 0, split: bool = False):
    """The forward kernel's function: f32 (3, rows), each row's (loss,
    lse, z-loss), or with `split` the shard's (partial loss, lse, 0). The
    lse of the scaled logits, then `cross_entropy_assemble`."""
    x = logits.float()
    if logit_scale != 1.0:
        x = x * logit_scale
    lse = torch.logsumexp(x, dim=-1)
    total = x.sum(dim=-1) if label_smoothing > 0.0 else None
    loss, z = cross_entropy_assemble(
        logits, labels, lse, total, lse_square_scale=lse_square_scale,
        label_smoothing=label_smoothing, logit_scale=logit_scale,
        ignore_index=ignore_index, total_classes=total_classes,
        class_start_idx=class_start_idx, split=split)
    return torch.stack([loss, lse, z])


def cross_entropy_combine_plain(parts: torch.Tensor, labels: torch.Tensor, *,
                                lse_square_scale: float = 0.0,
                                ignore_index: int = _IGNORE):
    """The combine kernel's function: parts (shards, 2, rows), the first two
    rows of each shard's split forward (partial loss, lse) -> f32 (3,
    rows): each row's (loss, global lse, z-loss), loss and z-loss 0 on
    ignored rows."""
    lse = torch.logsumexp(parts[:, 1], dim=0)
    z = lse_square_scale * lse * lse
    loss = parts[:, 0].sum(dim=0) + lse + z
    ignored = labels == ignore_index
    return torch.stack([torch.where(ignored, 0.0, loss), lse,
                        torch.where(ignored, 0.0, z)])


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
    def ce_fwd_kernel(logits_ptr, labels_ptr, out_ptr, n_rows, n_cols,
            logit_scale, lse_square_scale, smoothing, ignore_index,
            class_start_idx, total_classes,
            ROWS: tl.constexpr, BLOCK_V: tl.constexpr, SMOOTH: tl.constexpr,
            SPLIT: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        rmask = rows < n_rows
        row0 = rows.to(tl.int64) * n_cols
        base = row0[:, None]
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
        lse = tl.log(se) + m
        # the epilogue: the label's logit (one load, where the label lies in
        # this shard), then the row's loss
        labels = tl.load(labels_ptr + rows, mask=rmask, other=ignore_index)
        local = labels - class_start_idx
        in_shard = (local >= 0) & (local < n_cols)
        ll = tl.load(logits_ptr + row0 + local, mask=rmask & in_shard,
                     other=0.0).to(tl.float32) * logit_scale
        if SPLIT:
            lse_term = tl.zeros((ROWS,), tl.float32)
        else:
            lse_term = lse
        if SMOOTH:
            loss = tl.where(in_shard,
                            lse_term - smoothing * sl / total_classes
                            - (1.0 - smoothing) * ll,
                            smoothing * (lse_term - sl / total_classes))
        else:
            loss = tl.where(in_shard, lse_term - ll, 0.0)
        ignored = labels == ignore_index
        if SPLIT:
            z = tl.zeros((ROWS,), tl.float32)
        else:
            z = tl.where(ignored, 0.0, lse_square_scale * lse * lse)
        tl.store(out_ptr + rows, tl.where(ignored, 0.0, loss + z),
                 mask=rmask)
        tl.store(out_ptr + n_rows + rows, lse, mask=rmask)
        tl.store(out_ptr + 2 * n_rows + rows, z, mask=rmask)

    @triton.jit
    def ce_combine_kernel(parts_ptr, labels_ptr, out_ptr, n_rows, n_parts,
            lse_square_scale, ignore_index, BLOCK: tl.constexpr):
        rows = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        rmask = rows < n_rows
        m = tl.full((BLOCK,), -1e30, tl.float32)
        for r in range(0, n_parts):
            m = tl.maximum(m, tl.load(parts_ptr + (2 * r + 1) * n_rows + rows,
                                      mask=rmask, other=0.0))
        se = tl.zeros((BLOCK,), tl.float32)
        part = tl.zeros((BLOCK,), tl.float32)
        for r in range(0, n_parts):
            at = parts_ptr + 2 * r * n_rows + rows
            part += tl.load(at, mask=rmask, other=0.0)
            se += tl.exp(tl.load(at + n_rows, mask=rmask, other=0.0) - m)
        lse = m + tl.log(se)
        z = lse_square_scale * lse * lse
        labels = tl.load(labels_ptr + rows, mask=rmask, other=ignore_index)
        ignored = labels == ignore_index
        tl.store(out_ptr + rows, tl.where(ignored, 0.0, part + lse + z),
                 mask=rmask)
        tl.store(out_ptr + n_rows + rows, lse, mask=rmask)
        tl.store(out_ptr + 2 * n_rows + rows, tl.where(ignored, 0.0, z),
                 mask=rmask)

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

    return triton, ce_fwd_kernel, ce_bwd_kernel, ce_combine_kernel


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


def cross_entropy_fwd(logits: torch.Tensor, labels: torch.Tensor, *,
                      lse_square_scale: float = 0.0,
                      label_smoothing: float = 0.0,
                      logit_scale: float = 1.0, ignore_index: int = _IGNORE,
                      total_classes: Optional[int] = None,
                      class_start_idx: int = 0, split: bool = False):
    """f32 (3, rows): each row's (loss, lse, z-loss), or with `split` the
    shard's (partial loss, lse, 0). A CUDA tensor goes to the Triton
    kernel, a CPU tensor to `cross_entropy_fwd_plain`; anything else
    raises."""
    kw = dict(lse_square_scale=lse_square_scale,
              label_smoothing=label_smoothing, logit_scale=logit_scale,
              ignore_index=ignore_index, total_classes=total_classes,
              class_start_idx=class_start_idx, split=split)
    if logits.device.type == "cpu":
        return cross_entropy_fwd_plain(logits, labels, **kw)
    _check("cross_entropy_fwd", logits, labels)
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"cross_entropy_fwd: labels {labels.dtype}")
    triton, kernel, _, _ = _triton_kernels()
    logits = logits.contiguous()
    labels = labels.contiguous()
    rows, v = logits.shape
    out = torch.empty((3, rows), dtype=torch.float32, device=logits.device)
    kernel[(triton.cdiv(rows, _FWD_ROWS),)](
        logits, labels, out, rows, v, float(logit_scale),
        float(lse_square_scale), float(label_smoothing), int(ignore_index),
        int(class_start_idx), float(total_classes or v), ROWS=_FWD_ROWS,
        BLOCK_V=_FWD_BLOCK_V, SMOOTH=label_smoothing > 0.0, SPLIT=split,
        num_warps=_FWD_WARPS, num_stages=_FWD_STAGES)
    cross_entropy_fwd.launches += 1
    return out


cross_entropy_fwd.launches = 0


def cross_entropy_combine(parts: torch.Tensor, labels: torch.Tensor, *,
                          lse_square_scale: float = 0.0,
                          ignore_index: int = _IGNORE):
    """f32 (3, rows), each row's (loss, global lse, z-loss), from the
    first two rows (partial loss, lse) of every shard's split forward,
    stacked as parts (shards, 2, rows). A CUDA tensor goes to the Triton
    kernel, a CPU tensor to `cross_entropy_combine_plain`; anything else
    raises."""
    if parts.device.type == "cpu":
        return cross_entropy_combine_plain(parts, labels,
                                           lse_square_scale=lse_square_scale,
                                           ignore_index=ignore_index)
    if (parts.dtype != torch.float32 or parts.dim() != 3
            or parts.shape[1] != 2 or labels.shape != parts.shape[2:]
            or labels.dtype not in (torch.int32, torch.int64)):
        raise TypeError(f"cross_entropy_combine: parts {parts.dtype} "
                        f"{tuple(parts.shape)}, labels {labels.dtype} "
                        f"{tuple(labels.shape)}; f32 (shards, 2, rows) and "
                        f"integer (rows,)")
    if not parts.is_cuda or labels.device != parts.device:
        raise ValueError("cross_entropy_combine: all inputs on one CUDA "
                         "device")
    triton, _, _, kernel = _triton_kernels()
    parts = parts.contiguous()
    n, _, rows = parts.shape
    out = torch.empty((3, rows), dtype=torch.float32, device=parts.device)
    kernel[(triton.cdiv(rows, _COMBINE_BLOCK),)](
        parts, labels.contiguous(), out, rows, n, float(lse_square_scale),
        int(ignore_index), BLOCK=_COMBINE_BLOCK, num_warps=4)
    cross_entropy_combine.launches += 1
    return out


cross_entropy_combine.launches = 0


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
    triton, _, kernel, _ = _triton_kernels()
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
    """Per-row (loss, z) from the lse (and the row sum of the scaled
    logits), as the JAX package's `_ce_fwd_tiled` assembles them outside
    its kernel: the plain version of the forward kernel's epilogue."""
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
        out = cross_entropy_fwd(logits, labels, split=split, **kw)
        ctx.save_for_backward(logits, labels, out[1])
        ctx.kw = kw
        return out[0], out[2]

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
