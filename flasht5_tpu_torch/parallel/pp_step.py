"""The pipeline-parallel training step over a ("pipe", "data") mesh.

The counterpart of `flasht5_tpu/parallel/pp_step.py` (:44-304). The
parameters take JAX's pipeline layout (`to_pp_params`): the blocks of each
stack stacked along a leading layer axis (block 0's positional parameters
split out as the stack's "pe"), which the "pipe" dimension splits, so each
stage holds num_layers / S consecutive blocks of each stack; everything
else (embedding, final norms, "pe", lm_head) is whole on every stage.

A step (`pp_loss_and_grads`) cuts this rank's rows into microbatches and:

1. runs the encoder through the stages (`pipeline.py`), the T5 bias (or
   `pallas_rpe`'s bucket table) made once a microbatch outside the
   blocks from the whole "pe" (JAX :151-167);
2. broadcasts the encoder's final states from the last stage to every
   stage, where the decoder's cross-attention reads them;
3. runs the decoder through the stages and the loss on the last one;
4. backpropagates the decoder, sums the gradients of the encoder states
   over every decoder stage onto the last stage, and backpropagates the
   encoder from there.

The gradients of the whole leaves are summed over "pipe" (JAX `sync_grad`
:263-267) and every gradient over "data", the loss divided by the global
count as in `tp_step.py`. As in JAX, dropout > 0 and a layer count the
stage count does not divide are refused (:227-233); the attention masks
are not taken (the step's batch is input_ids and labels).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch
import torch.distributed as dist

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.optim import AdamWScale
from flasht5_tpu_torch.parallel import tp_step
from flasht5_tpu_torch.parallel.pipeline import (Stage, pipeline_backward,
                                                 pipeline_forward)
from flasht5_tpu_torch.parallel.sharding import shard_tree, tree_map


def _strip_pe(block):
    block = dict(block)
    sa_layer = dict(block["self_attention_layer"])
    sa = dict(sa_layer["self_attention"])
    pe = sa.pop("pe_encoding", None)
    sa_layer["self_attention"] = sa
    block["self_attention_layer"] = sa_layer
    return block, pe


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return None if first is None else torch.stack(trees)


def _unstack(tree, n):
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return [None] * n if tree is None else list(tree.unbind(0))


def _n_layers(stacked) -> int:
    leaves = [x for _, x in t5.tree_leaves_with_path(stacked)
              if x is not None]
    return leaves[0].shape[0]


def to_pp_params(params):
    """The pipeline layout of a `t5.init_params` tree: each stack's blocks
    stacked along a leading layer axis, block 0's positional parameters
    split out as the stack's "pe"."""

    def conv(stack):
        b0, pe = _strip_pe(stack["block"][0])
        out = {"stacked": _stack_trees([b0] + list(stack["block"][1:])),
               "final_layer_norm": stack["final_layer_norm"]}
        if pe is not None:
            out["pe"] = pe
        return out

    out = {"shared": params["shared"], "encoder": conv(params["encoder"]),
           "decoder": conv(params["decoder"])}
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"]
    return out


def from_pp_params(pp_params):
    """The inverse of `to_pp_params` (views of the stacked leaves)."""

    def conv(stack):
        blocks = _unstack(stack["stacked"], _n_layers(stack["stacked"]))
        if "pe" in stack:
            b0 = blocks[0]
            b0["self_attention_layer"] = dict(b0["self_attention_layer"])
            sa = dict(b0["self_attention_layer"]["self_attention"])
            sa["pe_encoding"] = stack["pe"]
            b0["self_attention_layer"]["self_attention"] = sa
        return {"block": blocks,
                "final_layer_norm": stack["final_layer_norm"]}

    out = {"shared": pp_params["shared"],
           "encoder": conv(pp_params["encoder"]),
           "decoder": conv(pp_params["decoder"])}
    if "lm_head" in pp_params:
        out["lm_head"] = pp_params["lm_head"]
    return out


def _map_pp(fn_stacked, fn_whole, pp_params):
    def stack(s):
        out = {"stacked": tree_map(fn_stacked, s["stacked"]),
               "final_layer_norm": tree_map(fn_whole, s["final_layer_norm"])}
        if "pe" in s:
            out["pe"] = tree_map(fn_whole, s["pe"])
        return out

    out = {"shared": tree_map(fn_whole, pp_params["shared"]),
           "encoder": stack(pp_params["encoder"]),
           "decoder": stack(pp_params["decoder"])}
    if "lm_head" in pp_params:
        out["lm_head"] = tree_map(fn_whole, pp_params["lm_head"])
    return out


def pp_param_pspecs(pp_params):
    """The split dimension of each leaf over "pipe": 0 (the layer axis)
    for the stacked leaves, None for the whole ones."""
    return _map_pp(lambda x: 0, lambda x: None, pp_params)


def pp_stat_batch_dims(pp_params):
    """AdamWScale's `stat_batch_dims` per leaf: 1 for the stacked leaves
    (an rms per layer, the unstacked optimizer's), 0 for the others."""
    return _map_pp(lambda x: 1, lambda x: 0, pp_params)


def check_pp_config(config: FlashT5Config, stages: int) -> None:
    if config.dropout_rate > 0.0:
        raise ValueError("the pipeline-parallel step supports "
                         "dropout_rate=0 only")
    if (config.num_layers % stages
            or (config.num_decoder_layers or config.num_layers) % stages):
        raise ValueError(f"num_layers must divide into {stages} stages")


def _positions(config, stack, q_len, k_len, bidirectional, device):
    """(position_bias, rpe_table) of a stack's blocks, from its whole
    "pe" (block 0's positional encoding)."""
    pe = stack.get("pe")
    if config.attention_type == "pallas_rpe":
        return None, (None if pe is None else pe["relative_attention_bias"])
    if config.position_encoding_type == "RoPE":
        return None, None
    return t5._position_bias(config, pe, q_len, k_len,
                             bidirectional=bidirectional, device=device), None


def _run_blocks(config, stack, x, *, is_decoder, enc=None):
    bias, table = _positions(config, stack, x.shape[1], x.shape[1],
                             not is_decoder, x.device)
    blocks = _unstack(stack["stacked"], _n_layers(stack["stacked"]))
    for bp in blocks:
        block = functools.partial(
            t5._block_apply, config, bp, is_decoder=is_decoder,
            has_pe=False, encoder_hidden_states=enc, rpe_table=table)
        if config.remat and torch.is_grad_enabled():
            x, _ = t5._rematerialized(block, None, x, bias)
        else:
            x, _ = block(x, position_bias=bias)
    return x


def pp_loss_and_grads(config: FlashT5Config, mesh, params, input_ids,
                      labels, n_microbatches: int,
                      denominator: torch.Tensor) -> torch.Tensor:
    """Forward and backward of this rank's rows through the pipeline,
    each microbatch's loss sum divided by `denominator`; leaves the
    gradients (before any reduction) in `.grad` and returns the loss on
    every stage (0-d, detached)."""
    stage = Stage(mesh.get_group("pipe"))
    dtype = runtime.torch_dtype(config.dtype)
    emb = params["shared"]["embedding"]
    b = input_ids.shape[0]
    if b % n_microbatches:
        raise ValueError(f"{b} rows do not split into {n_microbatches} "
                         f"microbatches")
    ids = input_ids.chunk(n_microbatches)
    lab = labels.chunk(n_microbatches)
    dec_in = t5.shift_right(config, labels).chunk(n_microbatches)
    mb, d = b // n_microbatches, config.d_model

    def embed(tokens):
        return emb[tokens.long()].to(dtype)

    # ---- encoder ----
    enc_stack = params["encoder"]
    like = torch.empty((mb, ids[0].shape[1], d), dtype=dtype,
                       device=emb.device)
    outs, enc_rec = pipeline_forward(
        stage, lambda i, x: _run_blocks(config, enc_stack, x,
                                        is_decoder=False),
        n_microbatches, [embed(t) for t in ids] if stage.first else None,
        like)
    enc_out = None
    states = torch.empty((n_microbatches,) + like.shape, dtype=dtype,
                         device=emb.device)
    if stage.last:
        w = enc_stack["final_layer_norm"]["weight"]
        enc_out = [t5._layer_norm(config, w, y) for y in outs]
        states.copy_(torch.stack([e.detach() for e in enc_out]))
    dist.broadcast(states, src=stage.last_rank, group=stage.group)
    enc_in = [states[i].clone().requires_grad_(True)
              for i in range(n_microbatches)]

    # ---- decoder ----
    dec_stack = params["decoder"]
    like = torch.empty((mb, dec_in[0].shape[1], d), dtype=dtype,
                       device=emb.device)
    outs, dec_rec = pipeline_forward(
        stage, lambda i, h: _run_blocks(config, dec_stack, h,
                                        is_decoder=True, enc=enc_in[i]),
        n_microbatches, [embed(t) for t in dec_in] if stage.first else None,
        like)
    losses = None
    if stage.last:
        w = dec_stack["final_layer_norm"]["weight"]
        head = emb.t() if config.tie_word_embeddings else params["lm_head"]
        losses = [t5.compute_loss(config,
                                  t5._matmul(t5._layer_norm(config, w, y),
                                             head),
                                  lab[i], denominator)
                  for i, y in enumerate(outs)]

    # ---- backward: the decoder, the encoder states' sum, the encoder ----
    pipeline_backward(stage, dec_rec, roots=losses)
    enc_grad = torch.stack([
        x.grad if x.grad is not None else torch.zeros_like(x)
        for x in enc_in])
    dist.reduce(enc_grad, dst=stage.last_rank, group=stage.group)
    pipeline_backward(stage, enc_rec, roots=enc_out,
                      grads=list(enc_grad) if stage.last else None)

    loss = (torch.stack([l.detach() for l in losses]).sum() if stage.last
            else torch.zeros((), device=emb.device))
    dist.broadcast(loss, src=stage.last_rank, group=stage.group)
    return loss


def pp_batch_loss(config, mesh, params, batch: Dict,
                  n_microbatches: int) -> torch.Tensor:
    """`pp_loss_and_grads` on this rank's rows with the count over every
    data rank; returns the global loss."""
    data = mesh.get_group("data")
    den = tp_step.global_denominator(config, batch["labels"], data)
    loss = pp_loss_and_grads(config, mesh, params, batch["input_ids"],
                             batch["labels"], n_microbatches, den)
    dist.all_reduce(loss, group=data)
    return loss


def make_pp_train_step(config: FlashT5Config, mesh, optimizer,
                       n_microbatches: int = 4) -> Callable:
    """step(pp_params, batch) -> {"loss", "grad_norm"} over a (pipe,
    data) mesh: `pp_params` this stage's shard of the pipeline layout
    (the leaves `optimizer` updates), `batch` this rank's rows."""
    check_pp_config(config, mesh.size(0))

    def step(params, batch, generator=None):
        del generator      # dropout 0: nothing draws
        optimizer.zero_grad(set_to_none=True)
        split = [s is not None
                 for s in tp_step.flat_specs(pp_param_pspecs(params))]
        loss, _, norm = tp_step.grads_and_norm(
            lambda: pp_batch_loss(config, mesh, params, batch,
                                  n_microbatches),
            [p for _, p in t5.tree_leaves_with_path(params)], split, mesh)
        optimizer.step()
        return {"loss": loss, "grad_norm": norm}

    return step


def shard_pp_params(params, mesh):
    """This stage's shard of the pipeline layout of a whole tree."""
    pp = to_pp_params(params)
    return shard_tree(pp, pp_param_pspecs(pp), mesh, "pipe")


def pp_train_state(config: FlashT5Config, mesh, seed: int = 0,
                   learning_rate: float = 1e-3, weight_decay: float = 0.0,
                   params=None, device=None):
    """(this stage's pipeline-layout shard, its AdamWScale with
    `pp_stat_batch_dims`) for `make_pp_train_step`."""
    device = runtime.resolve_device(device)
    full = (tree_map(lambda x: x.detach().to(device, copy=True), params)
            if params is not None
            else t5.init_params(config, seed=seed, device=device))
    local = shard_pp_params(full, mesh)
    named = t5.tree_leaves_with_path(local)
    for _, p in named:
        p.requires_grad_(True)
    dims = tp_step.flat_specs(pp_stat_batch_dims(local))
    opt = AdamWScale(tp_step.optimizer_groups(named, weight_decay,
                                              stat_batch_dims=dims),
                     lr=learning_rate)
    return local, opt
