"""The data-parallel training step, and one sharded step end to end.

The counterpart of `flasht5_tpu/parallel/train_step.py`. The JAX step is
GSPMD's: parameters laid out by the sharding rules, the batch split over
"data", and XLA's collectives. Here `make_train_step` is the data-parallel
step (whole parameters on every rank, the gradients summed over "data" of
losses divided by the global count, as `tp_step.py` sets out), and
`sharded_train_step` draws the parameters, cuts them for the mesh and runs
one tensor- and data-parallel step (JAX :47-76).
"""

from __future__ import annotations

from typing import Callable

import torch

from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.parallel import tp_step
from flasht5_tpu_torch.parallel.sharding import batch_slice


def make_train_step(config: FlashT5Config, mesh, optimizer) -> Callable:
    """step(params, batch, generator=None) -> {"loss", "grad_norm"}: the
    whole model on this rank's rows, the gradients summed over "data",
    the optimizer's update.

    Kept beside `make_tp_train_step`, whose gradient path it shares: it
    runs the model without `tp_axis`, so the one-card loss (the unsplit
    CE kernels, or the fused lm_head+CE where the config asks for it),
    where the tensor-parallel step at degree 1 runs the vocab-parallel
    loss on the split ones."""
    config = config.replace(tp_axis=None)

    def step(params, batch, generator=None):
        leaves = [p for _, p in t5.tree_leaves_with_path(params)]
        optimizer.zero_grad(set_to_none=True)
        loss, _, norm = tp_step.grads_and_norm(
            lambda: tp_step.loss_and_grads(config, mesh, params, batch,
                                           generator),
            leaves, [False] * len(leaves), mesh)
        optimizer.step()
        return {"loss": loss, "grad_norm": norm}

    return step


def sharded_train_step(config: FlashT5Config, mesh, input_ids, labels,
                       learning_rate: float = 1e-3, device=None,
                       seed: int = 0) -> torch.Tensor:
    """Draw the parameters from `seed`, cut this rank's shard, and run ONE
    tensor- and data-parallel step of AdamWScale (weight decay 0.01, the
    no-decay grouping) on this rank's rows of the global batch; returns
    the global loss."""
    params, opt = tp_step.tp_train_state(
        config, mesh, seed=seed, learning_rate=learning_rate,
        weight_decay=0.01, device=device)
    dev = params["shared"]["embedding"].device
    rows = batch_slice(mesh, len(input_ids))
    batch = {"input_ids": torch.as_tensor(input_ids[rows], device=dev),
             "labels": torch.as_tensor(labels[rows], device=dev)}
    step = tp_step.make_tp_train_step(config, mesh, opt)
    return step(params, batch)["loss"]
