"""The tensor- and data-parallel training step, with its collectives
placed by hand.

The counterpart of `flasht5_tpu/parallel/tp_step.py` (:35-157). Each rank
holds its tensor shard of the parameters (`sharding.shard_params`) and its
"data" slice of the batch, and runs the model with `tp_axis="tensor"`:
Megatron's functions in the model bring the whole leaves' gradients out
whole on every tensor rank (`collective_matmul.py`), and the loss is
`vocab_parallel_loss` on the CE kernels' split form.

The batch's loss is the one-card loss of the global batch: each rank
divides its sum by the count over every data rank (all rows with
`use_fused_crossentropy`, else the non-ignored ones), and the gradients
are summed over "data". Where the ranks' counts agree (always with
`use_fused_crossentropy`) this is the JAX step's mean over "data" of the
ranks' means; where they differ it is the JAX `Trainer`'s loss, which
GSPMD computes over the global batch. `allreduce_dtype` casts the
gradients for the all-reduce only (JAX `_sync_grad`, :43-61).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.optim import AdamWScale, no_decay_mask
from flasht5_tpu_torch.parallel.mesh import use_mesh
from flasht5_tpu_torch.parallel.sharding import (param_pspecs, shard_params,
                                                tree_map)


def flat_specs(specs) -> list:
    """A spec tree's leaves (split dimensions, stat_batch_dims) in
    `t5.tree_leaves_with_path` order."""
    return [s for _, s in t5.tree_leaves_with_path(specs)]


def tp_stat_axes(params, mesh) -> list:
    """AdamWScale's `stat_axes` per leaf (path order): the tensor group for
    a split leaf, None for a whole one, so that the rms is the unsplit
    leaf's (JAX :35-41)."""
    group = mesh.get_group("tensor")
    return [group if s is not None else None
            for s in flat_specs(param_pspecs(params))]


def optimizer_groups(named, weight_decay: float, stat_axes=None,
                     stat_batch_dims=None) -> list:
    """AdamWScale's parameter groups for [(path, leaf)]: the decayed and
    the undecayed leaves (`no_decay_mask`), each split further by its
    `stat_axes` and `stat_batch_dims` (lists in the same order)."""
    n = len(named)
    axes = stat_axes or [None] * n
    dims = stat_batch_dims or [0] * n
    groups = {}
    for (path, p), decay, ax, bd in zip(named,
                                        no_decay_mask(k for k, _ in named),
                                        axes, dims):
        key = (not decay, ax is not None, bd)
        g = groups.setdefault(key, {"params": [], "stat_axes": ax,
                                    "stat_batch_dims": bd,
                                    "weight_decay": (weight_decay if decay
                                                     else 0.0)})
        g["params"].append(p)
    return [groups[k] for k in sorted(groups)]


def global_denominator(config: FlashT5Config, labels: torch.Tensor,
                       data_group) -> torch.Tensor:
    """The loss's count over every data rank (at least 1)."""
    n = t5.loss_denominator(config, labels.reshape(-1)).reshape(1)
    dist.all_reduce(n, group=data_group)
    return torch.clamp(n[0], min=1.0)


def all_reduce_grads(grads, group, comm_dtype=None) -> None:
    """Sum each gradient over `group` in place, one flat buffer a dtype;
    `comm_dtype` casts only for the collective."""
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for dtype, gs in by_dtype.items():
        flat = torch.cat([g.reshape(-1).to(comm_dtype or dtype) for g in gs])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in gs:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n


def global_grad_norm(grads, split, group) -> torch.Tensor:
    """The unsplit tree's gradient norm: the sums of squares of the split
    leaves (`split[i]` true) added over `group` (None: no leaf is split),
    the whole leaves (the same on every rank of it) counted once."""
    def sum_sq(gs):
        if not gs:
            return torch.zeros((), device=grads[0].device)
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(gs))) ** 2

    if not any(split):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            grads)))
    split_sq = sum_sq([g for g, s in zip(grads, split) if s])
    if group is not None:
        dist.all_reduce(split_sq, group=group)
    return torch.sqrt(split_sq + sum_sq([g for g, s in zip(grads, split)
                                          if not s]))


def ensure_grads(leaves) -> list:
    """Each leaf's gradient, zeros where the loss does not reach it."""
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in leaves]


def loss_and_grads(config: FlashT5Config, mesh, params, batch: Dict,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Forward and backward of this rank's rows under `mesh`, the loss
    divided by the global count; leaves the local gradients in each
    leaf's `.grad` and returns the global loss (0-d, detached)."""
    data = mesh.get_group("data")
    den = global_denominator(config, batch["labels"], data)
    with use_mesh(mesh):
        loss = t5.forward(config, params, input_ids=batch["input_ids"],
                          attention_mask=batch.get("attention_mask"),
                          labels=batch["labels"], generator=generator,
                          deterministic=generator is None,
                          loss_denominator=den)["loss"]
        loss.backward()
    total = loss.detach().clone()
    dist.all_reduce(total, group=data)
    return total


def grads_and_norm(run_loss: Callable[[], torch.Tensor], leaves, split,
                   mesh, comm_dtype=None):
    """The gradient path of every layout, shared by the step functions and
    the `Trainer`: `run_loss()` runs this rank's forward and backward and
    returns the global loss; each gradient is then summed over the ranks
    that hold the same leaf (a pipeline's whole leaves over "pipe", every
    leaf over "data"), and the norm is the unsplit tree's (`split[i]`:
    leaf i is cut over "tensor", or over "pipe" in a pipeline's mesh).
    Returns (loss, grads, norm)."""
    loss = run_loss()
    grads = ensure_grads(leaves)
    axis = "pipe" if "pipe" in mesh.mesh_dim_names else "tensor"
    if axis == "pipe":
        all_reduce_grads([g for g, s in zip(grads, split) if not s],
                         mesh.get_group("pipe"), comm_dtype)
    all_reduce_grads(grads, mesh.get_group("data"), comm_dtype)
    return loss, grads, global_grad_norm(grads, split, mesh.get_group(axis))


def make_tp_train_step(config: FlashT5Config, mesh, optimizer,
                       allreduce_dtype=None) -> Callable:
    """step(params, batch, generator=None) -> {"loss", "grad_norm"}:
    forward and backward on this rank's shard of `params` (the leaves
    `optimizer` updates) and rows of the batch, the gradients summed over
    "data", the AdamWScale update. The norm is the unsplit tree's."""
    tp_config = config.replace(tp_axis="tensor")
    comm = runtime.torch_dtype(allreduce_dtype) if allreduce_dtype else None

    def step(params, batch, generator=None):
        optimizer.zero_grad(set_to_none=True)
        split = [s is not None for s in flat_specs(param_pspecs(params))]
        loss, _, norm = grads_and_norm(
            lambda: loss_and_grads(tp_config, mesh, params, batch, generator),
            [p for _, p in t5.tree_leaves_with_path(params)], split, mesh,
            comm)
        optimizer.step()
        return {"loss": loss, "grad_norm": norm}

    return step


def tp_train_state(config: FlashT5Config, mesh, seed: int = 0,
                   learning_rate: float = 1e-3, weight_decay: float = 0.0,
                   params=None, device=None):
    """(this rank's shard of the parameters, its AdamWScale with
    `tp_stat_axes`) for `make_tp_train_step`: the whole tree drawn from
    `seed` (or `params`) on `device`, then cut."""
    device = runtime.resolve_device(device)
    full = (tree_map(lambda x: x.detach().to(device, copy=True), params)
            if params is not None
            else t5.init_params(config, seed=seed, device=device))
    local = shard_params(full, mesh)
    named = t5.tree_leaves_with_path(local)
    for _, p in named:
        p.requires_grad_(True)
    opt = AdamWScale(optimizer_groups(named, weight_decay,
                                      stat_axes=tp_stat_axes(local, mesh)),
                     lr=learning_rate)
    return local, opt
