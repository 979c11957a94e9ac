"""Cross-entropy over a vocabulary split across the tensor group, on the
CE kernels' vocab-split form, and next-token selection over such logits.

The counterpart of `flasht5_tpu/parallel/vocab_parallel.py`. Each tensor
rank holds the logits of its contiguous slice of the vocabulary (rows,
V/t). `vocab_parallel_loss` is one autograd function:

- forward: the CE forward kernel's split form (`ops/cross_entropy.py::
  cross_entropy_fwd(..., split=True)`) gives each shard's (partial loss,
  lse) per row, label and smoothing terms included; one all-gather brings
  every shard's pair of rows to every rank, and the combine kernel
  (`cross_entropy_combine`) gives the global lse (a log-sum-exp over the
  shards), the summed partials plus the global lse and its z-loss, and
  the ignore mask;
- backward: the CE backward kernel on the shard, with the GLOBAL lse,
  `class_start_idx` and `total_classes`, so that each shard's dlogits are
  its columns of the unsplit gradient. The shard's own lse would give a
  loss that looks right and a gradient that does not sum to the right
  total.

The reductions are the model's: with `use_fused_crossentropy` the mean
over all rows (reference modeling:68), else over the non-ignored rows; a
caller may pass the denominator (the trainers pass the count over every
data rank).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from flasht5_tpu_torch.ops.cross_entropy import (cross_entropy_bwd,
                                                 cross_entropy_combine,
                                                 cross_entropy_fwd)

_IGNORE = -100


class _VocabParallelLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, group, z, smoothing, denominator):
        t = dist.get_world_size(group)
        v_local = logits.shape[1]
        total_classes = v_local * t
        start = dist.get_rank(group) * v_local
        pair = cross_entropy_fwd(
            logits, labels, label_smoothing=smoothing,
            total_classes=total_classes, class_start_idx=start,
            split=True)[:2]
        parts = pair.new_empty((t * 2, pair.shape[1]))
        dist.all_gather_into_tensor(parts, pair, group=group)
        loss, lse, _ = cross_entropy_combine(parts.view(t, 2, -1), labels,
                                             lse_square_scale=z)
        ctx.save_for_backward(logits, labels, lse, denominator)
        ctx.kw = dict(lse_square_scale=z, label_smoothing=smoothing,
                      total_classes=total_classes, class_start_idx=start)
        return loss.sum() / denominator

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse, denominator = ctx.saved_tensors
        dloss = (g / denominator).expand_as(lse).contiguous()
        return (split_backward(logits, labels, lse, dloss, **ctx.kw),
                None, None, None, None, None)


def split_backward(logits, labels, lse, dloss, *, lse_square_scale,
                   label_smoothing, total_classes, class_start_idx):
    """A shard's dlogits: the CE backward kernel on the shard's logits
    with the GLOBAL lse (rows,) and the per-row dloss, the one-hot at
    label - class_start_idx and the smoothing over total_classes."""
    return cross_entropy_bwd(logits, labels, lse, dloss,
                             torch.zeros_like(lse),
                             lse_square_scale=lse_square_scale,
                             label_smoothing=label_smoothing,
                             total_classes=total_classes,
                             class_start_idx=class_start_idx)


def vocab_parallel_loss(config, local_logits: torch.Tensor,
                        labels: torch.Tensor, group,
                        denominator: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """CE + z-loss of vocab-split logits (..., V/t) against global label
    ids (..., ; -100 ignored), the same scalar on every rank of `group`."""
    logits = local_logits.reshape(-1, local_logits.shape[-1])
    flat = labels.reshape(-1)
    if denominator is None:
        from flasht5_tpu_torch.models.t5 import loss_denominator
        denominator = torch.clamp(loss_denominator(config, flat), min=1.0)
    denominator = torch.as_tensor(denominator, dtype=torch.float32,
                                  device=logits.device)
    return _VocabParallelLoss.apply(logits, flat, group, config.z_loss or 0.0,
                                    config.label_smoothing, denominator)


def vocab_parallel_next_token(local_logits: torch.Tensor, group, *,
                              generator: Optional[torch.Generator] = None,
                              temperature: float = 0.0, top_k: int = 0,
                              top_p: float = 1.0) -> torch.Tensor:
    """Next token ids (B,) from vocab-split logits (B, V/t), the same on
    every rank of `group` (JAX vocab_parallel.py:72-99).

    Greedy (temperature <= 0) gathers each shard's (max, argmax) pair
    only; the lowest shard wins a tie, as the unsplit argmax takes the
    lowest index. Sampling gathers the whole row and draws from
    `generator`, which must stand at the same state on every rank."""
    t = dist.get_world_size(group)
    v_local = local_logits.shape[-1]
    if temperature > 0.0:
        from flasht5_tpu_torch.inference.sampling import sample_token
        parts = [torch.empty_like(local_logits) for _ in range(t)]
        dist.all_gather(parts, local_logits.contiguous(), group=group)
        return sample_token(torch.cat(parts, dim=-1), generator=generator,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p)
    lmax, larg = torch.max(local_logits.float(), dim=-1)
    larg = larg + dist.get_rank(group) * v_local
    maxes = [torch.empty_like(lmax) for _ in range(t)]
    args = [torch.empty_like(larg) for _ in range(t)]
    dist.all_gather(maxes, lmax.contiguous(), group=group)
    dist.all_gather(args, larg.contiguous(), group=group)
    best = torch.argmax(torch.stack(maxes), dim=0)
    return torch.gather(torch.stack(args), 0, best[None, :])[0]
