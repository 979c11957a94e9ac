"""Pretraining/finetuning trainer, on one GPU or across ranks.

The counterpart of `flasht5_tpu/train/trainer.py`: the same `TrainerConfig`
fields, the same step (forward with the loss, backward, optional clipping by
the global gradient norm, the AdamWScale update with the no-decay grouping),
the same token count and logged fields, masked-accuracy evaluation, the
callback hooks, and checkpoints with resume: every `save_steps` steps (and
on KeyboardInterrupt) `output_dir/step_<n>/checkpoint.pt` in `torch.save`
format, where the JAX package writes Orbax, with `config.json` and a
`train_log.jsonl` beside them. The step runs eagerly on the card through the
port's kernels; autograd replaces `jax.value_and_grad`.

`gradient_accumulation_steps` = k > 1 is `optax.MultiSteps` around the
clip + AdamWScale chain, as in the JAX package: each batch is a micro-batch
whose gradient joins a running mean (`acc + (g - acc) / (n + 1)`), and
every k-th one clips that mean and updates the parameters, so the schedule
counts updates. The step count, the token count, the logs (each
micro-batch's loss and the norm of its own gradient), `max_steps`, the
evaluations and the checkpoints count micro-batches, as the JAX `Trainer`
does; a checkpoint keeps the running mean and its count.

Across ranks (one process a card, the default process group joined
first, `parallel.distributed.initialize_multihost`), `data_parallel`,
`tensor_parallel` and `pipeline_parallel` lay the ranks out as a (data,
tensor) mesh, or a (pipe, data) one; the pipeline excludes tensor
parallelism, as in the JAX `Trainer`. Any degree above 1 (or a set
`tp_axis`) without a process group raises. The trainer keeps the JAX
`Trainer`'s global semantics, which under GSPMD are the one-card math:

- each rank takes its "data" slice of the global batch it is given;
- the loss is the one-card loss of the global batch (the sum over every
  data rank divided by the global count, `parallel/tp_step.py`);
- the clip takes the unsplit tree's gradient norm, and AdamWScale the
  unsplit leaves' rms (`tp_stat_axes`; per layer on the pipeline's
  stacked leaves, `pp_stat_batch_dims`);
- dropout draws from a generator seeded from the seed and the rank's data
  index: the same masks on every tensor rank, others across "data";
- the log, the callbacks and the checkpoint files are rank 0's;
- `evaluate` gives the one-card loss and accuracy;
- a checkpoint is the one-card `checkpoint.pt` (the whole tree and
  optimizer state, gathered), and a restore cuts it for this trainer's
  layout, so that a run resumes under any layout.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.optim import (AdamWScale, cosine_schedule,
                                     no_decay_mask, wsd_schedule)
from flasht5_tpu_torch.parallel import pp_step, tp_step
from flasht5_tpu_torch.parallel.mesh import make_mesh, make_pp_mesh, use_mesh
from flasht5_tpu_torch.parallel.sharding import (batch_slice, gather_tree,
                                                 param_pspecs, shard_tree)
from flasht5_tpu_torch.quantize import _map_with_path
from flasht5_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainerConfig:
    learning_rate: float = 1e-3
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-6
    weight_decay: float = 0.0
    max_steps: int = 1000
    gradient_accumulation_steps: int = 1
    warmup_steps: int = 0
    warmup_ratio: float = 0.0
    lr_scheduler: str = "cosine"          # "cosine" | "wsd" | "constant"
    gradient_clip_norm: Optional[float] = None
    logging_steps: int = 50
    eval_steps: int = 0                   # 0 = no eval
    save_steps: int = 0                   # 0 = no checkpoints
    output_dir: str = "checkpoints"
    seed: int = 0
    data_parallel: int = 1
    tensor_parallel: int = 1
    pipeline_parallel: int = 1
    pp_microbatches: int = 4
    kahan_sum: bool = False
    # optimizer state dtype (reference use_state_dtype, adamw_scaled.py:102)
    state_dtype: Optional[str] = None


def masked_accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    """Argmax accuracy over label > 0 positions (reference:
    train_flash_t5.py:80-92)."""
    preds = logits.argmax(-1)
    mask = labels > 0
    if mask.sum() == 0:
        return 0.0
    return float((preds[mask] == labels[mask]).mean())


CHECKPOINT_FILE = "checkpoint.pt"
_END = object()          # the end of a batch iterator


def _fetched(train_iter: Iterable[Dict]):
    """`train_iter`'s batches, each fetch a span `train.batch`."""
    batches = iter(train_iter)
    while True:
        with span("train.batch"):
            batch = next(batches, _END)
        if batch is _END:
            return
        yield batch


class Trainer:
    """`Trainer(config, tcfg).train(batches)`: batches are dicts of numpy
    arrays (`input_ids`, `labels`, optionally `attention_mask`). Runs on
    `device` (default `cuda`; raises without a GPU unless device='cpu')."""

    def __init__(self, config: FlashT5Config, tcfg: TrainerConfig,
                 params: Optional[Any] = None,
                 callbacks: Optional[list] = None, device=None):
        self.parallel = dist.is_available() and dist.is_initialized()
        degrees = (tcfg.data_parallel, tcfg.tensor_parallel,
                   tcfg.pipeline_parallel)
        if not self.parallel and (max(degrees) > 1
                                  or config.tp_axis is not None):
            raise RuntimeError(
                "data, tensor and pipeline parallelism (and tp_axis) need "
                "the default process group: run one process a card under "
                "torch.distributed.run and call parallel.distributed."
                "initialize_multihost() first")
        self.pp = tcfg.pipeline_parallel > 1
        self.mesh = None
        if self.parallel:
            if self.pp:
                if tcfg.tensor_parallel > 1 or config.tp_axis is not None:
                    raise ValueError("pipeline_parallel excludes "
                                     "tensor_parallel")
                pp_step.check_pp_config(config, tcfg.pipeline_parallel)
                self.mesh = make_pp_mesh(tcfg.pipeline_parallel,
                                         tcfg.data_parallel)
            else:
                if config.tp_axis not in (None, "tensor"):
                    raise ValueError(f"tp_axis {config.tp_axis!r}: the "
                                     f"trainer's mesh names it 'tensor'")
                if tcfg.tensor_parallel > 1:
                    config = config.replace(tp_axis="tensor")
                self.mesh = make_mesh(tcfg.data_parallel,
                                      tcfg.tensor_parallel)
        self.rank0 = not self.parallel or dist.get_rank() == 0
        self.config = config
        self.tcfg = tcfg
        self.callbacks = list(callbacks or [])
        self.device = runtime.resolve_device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"Trainer runs on cuda (or cpu for the plain "
                             f"versions of the kernels), not {self.device}")

        if tcfg.lr_scheduler == "cosine":
            self.schedule = cosine_schedule(tcfg.learning_rate,
                                            tcfg.max_steps, tcfg.warmup_steps,
                                            tcfg.warmup_ratio)
        elif tcfg.lr_scheduler == "wsd":
            self.schedule = wsd_schedule(tcfg.learning_rate, tcfg.max_steps,
                                         tcfg.warmup_steps, tcfg.warmup_ratio)
        else:
            self.schedule = tcfg.learning_rate

        if params is None:
            full = t5.init_params(config, seed=tcfg.seed, device=self.device)
        else:
            # a copy: the step updates the parameters in place
            full = _tree_map(
                lambda t: t.detach().to(self.device, copy=True), params)
        self._full_paths = [path for path, _ in
                            t5.tree_leaves_with_path(full)]
        # this rank's part of the tree: its tensor shard, its pipeline
        # stage's shard of the pipeline layout, or all of it
        self.params = self._local(full)
        named = t5.tree_leaves_with_path(self.params)
        self._paths = [path for path, _ in named]
        self._leaves = [p.requires_grad_(True) for _, p in named]
        stat_axes = stat_dims = None
        self._split, self._split_group = [False] * len(named), None
        if self.parallel and self.pp:
            self._split = [s is not None for s in tp_step.flat_specs(
                pp_step.pp_param_pspecs(self.params))]
            self._split_group = self.mesh.get_group("pipe")
            stat_dims = tp_step.flat_specs(
                pp_step.pp_stat_batch_dims(self.params))
        elif self.parallel and config.tp_axis is not None:
            stat_axes = tp_step.tp_stat_axes(self.params, self.mesh)
            self._split = [a is not None for a in stat_axes]
            self._split_group = self.mesh.get_group("tensor")
        self.optimizer = AdamWScale(
            tp_step.optimizer_groups(named, tcfg.weight_decay, stat_axes,
                                     stat_dims), lr=self.schedule,
            betas=(tcfg.adam_beta1, tcfg.adam_beta2), eps=tcfg.adam_epsilon,
            kahan_sum=tcfg.kahan_sum,
            state_dtype=(runtime.torch_dtype(tcfg.state_dtype)
                         if tcfg.state_dtype else None))
        data_index = (self.mesh.get_local_rank("data") if self.parallel
                      else 0)
        self.generator = torch.Generator(device=self.device).manual_seed(
            tcfg.seed + 1 + (data_index << 32))
        self.step_num = 0
        # gradient accumulation: the running mean and the micro-batches in it
        self._acc = None
        self._mini_step = 0

    # -- layouts ------------------------------------------------------------

    def _local(self, tree):
        """This rank's part of a whole tree (parameters, or optimizer state
        in their shape)."""
        if not self.parallel:
            return tree
        if self.pp:
            pp = pp_step.to_pp_params(tree)
            return shard_tree(pp, pp_step.pp_param_pspecs(pp), self.mesh,
                              "pipe")
        return shard_tree(tree, param_pspecs(tree), self.mesh)

    def _gather(self, local):
        """The whole tree from every rank's part (a collective)."""
        if not self.parallel:
            return local
        if self.pp:
            full = gather_tree(local, pp_step.pp_param_pspecs(local),
                               self.mesh, "pipe")
            return _tree_map(lambda t: t if t is None else t.clone(),
                             pp_step.from_pp_params(full))
        return gather_tree(local, param_pspecs(local), self.mesh)

    def full_params(self):
        """The whole parameter tree on every rank (a collective)."""
        return self._gather(_tree_map(torch.Tensor.detach, self.params))

    def _device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        keys = list(batch)
        if self.pp:
            # the pipeline's step takes these two
            keys = ["input_ids", "labels"]
        rows = slice(None)
        if self.parallel:
            rows = batch_slice(self.mesh, len(batch["input_ids"]))
        return {k: torch.as_tensor(np.asarray(batch[k])[rows]).to(self.device)
                for k in keys}

    def _norm(self, grads) -> torch.Tensor:
        return tp_step.global_grad_norm(grads, self._split, self._split_group)

    def _loss_and_grads(self, batch):
        """Forward and backward; gradients summed over the ranks as the
        layout needs (`tp_step.grads_and_norm`, the step functions' path).
        Returns (loss, grads, norm). On one card the spans `train.forward`
        and `train.backward` (with `ensure_grads` and the norm) split it;
        across ranks, where one call runs both, `train.backward` covers
        the whole."""
        self.optimizer.zero_grad(set_to_none=True)
        if self.pp:
            with span("train.backward"):
                return tp_step.grads_and_norm(
                    lambda: pp_step.pp_batch_loss(self.config, self.mesh,
                                                  self.params, batch,
                                                  self.tcfg.pp_microbatches),
                    self._leaves, self._split, self.mesh)
        if self.parallel:
            with span("train.backward"):
                return tp_step.grads_and_norm(
                    lambda: tp_step.loss_and_grads(self.config, self.mesh,
                                                   self.params, batch,
                                                   self.generator),
                    self._leaves, self._split, self.mesh)
        with span("train.forward"):
            loss = t5.forward(self.config, self.params,
                              input_ids=batch["input_ids"],
                              attention_mask=batch.get("attention_mask"),
                              labels=batch["labels"],
                              generator=self.generator,
                              deterministic=False)["loss"]
        with span("train.backward"):
            loss.backward()
            grads = tp_step.ensure_grads(self._leaves)
            return loss.detach(), grads, self._norm(grads)

    def _step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One training step (one micro-batch under accumulation); returns
        the loss and its gradient's norm as device tensors (read only when
        logged). The span `train.optimizer` covers the accumulation, the
        clip and the update."""
        loss, grads, grad_norm = self._loss_and_grads(batch)
        metrics = {"loss": loss, "grad_norm": grad_norm}
        k = self.tcfg.gradient_accumulation_steps
        with span("train.optimizer"):
            if k > 1:
                if self._acc is None:
                    self._acc = [torch.zeros_like(p) for p in self._leaves]
                # optax.MultiSteps's running mean (its Welford form)
                torch._foreach_add_(self._acc, torch._foreach_div(
                    torch._foreach_sub(grads, self._acc),
                    self._mini_step + 1))
                self._mini_step += 1
                if self._mini_step < k:
                    return metrics
                self._mini_step = 0
                grads = self._acc
                for p, g in zip(self._leaves, grads):
                    p.grad = g
            clip = self.tcfg.gradient_clip_norm
            if clip:
                # optax.clip_by_global_norm: unchanged below the limit, else
                # scaled to it
                norm = grad_norm if k == 1 else self._norm(grads)
                factor = torch.where(norm < clip, 1.0, clip / norm)
                torch._foreach_mul_(grads, factor)
            self.optimizer.step()
            if k > 1:
                torch._foreach_zero_(self._acc)
        return metrics

    # -- checkpoints -------------------------------------------------------

    def _tree_of(self, values) -> Any:
        """A tree shaped as this rank's parameters from per-leaf values in
        path order (None where a leaf has none)."""
        by_path = dict(zip(self._paths, values))
        return _map_with_path(lambda path, _: by_path[path], self.params)

    def _one_card_order(self) -> list:
        """The whole tree's paths in the one-card optimizer's order: the
        decayed leaves, then the others (`optimizer_groups`)."""
        decay = no_decay_mask(self._full_paths)
        return ([p for p, d in zip(self._full_paths, decay) if d]
                + [p for p, d in zip(self._full_paths, decay) if not d])

    def _state_keys(self) -> list:
        keys = set()
        for p in self._leaves:
            keys.update(self.optimizer.state[p])
        return sorted(keys)

    def save_checkpoint(self, step: int) -> str:
        """Write `output_dir/step_<step>/checkpoint.pt` (the parameters, the
        AdamWScale state and the step, `torch.save`) and the model's
        `output_dir/config.json`; returns the step directory. Across ranks
        every rank calls it: the whole tree and state are gathered and
        rank 0 writes the one-card file."""
        path = os.path.abspath(os.path.join(self.tcfg.output_dir,
                                            f"step_{step}"))
        params = self.full_params()
        state = {}
        for key in self._state_keys():
            tree = self._gather(self._tree_of(
                [self.optimizer.state[p].get(key) for p in self._leaves]))
            state[key] = dict(t5.tree_leaves_with_path(tree))
        mean = None
        if self._acc is not None:
            mean = [t for _, t in t5.tree_leaves_with_path(
                self._gather(self._tree_of(self._acc)))]
        if self.rank0:
            opt_state = {
                "step_count": self.optimizer.step_count,
                "state": [{k: state[k][p] for k in state
                           if state[k][p] is not None}
                          for p in self._one_card_order()]}
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
            torch.save({"params": params, "opt_state": opt_state,
                        "accumulation": {"mini_step": self._mini_step,
                                         "mean": mean},
                        "step": step}, tmp)
            os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
            with open(os.path.join(self.tcfg.output_dir, "config.json"),
                      "w") as f:
                f.write(self.config.to_json())
        if self.parallel:
            dist.barrier()
        return path

    def restore_checkpoint(self, path: str) -> int:
        """Load a `save_checkpoint` directory into this trainer's parameters
        and optimizer, in place; returns the restored step."""
        ckpt = torch.load(os.path.join(path, CHECKPOINT_FILE),
                          map_location=self.device, weights_only=True)
        if [p for p, _ in t5.tree_leaves_with_path(ckpt["params"])] \
                != self._full_paths:
            raise ValueError(f"{path}: the checkpoint's parameter tree is "
                             f"not this model's")
        full = ckpt["params"]

        def local_leaves(values):
            by_path = dict(zip(self._full_paths, values))
            tree = _map_with_path(lambda p, _: by_path[p], full)
            return [t for _, t in t5.tree_leaves_with_path(self._local(tree))]

        with torch.no_grad():
            for dst, src in zip(self._leaves, local_leaves(
                    [t for _, t in t5.tree_leaves_with_path(full)])):
                dst.copy_(src)
        # the one-card optimizer state, by path, cut for this layout
        saved = dict(zip(self._one_card_order(),
                         ckpt["opt_state"]["state"]))
        keys = sorted({k for st in saved.values() for k in st})
        for key in keys:
            values = local_leaves([saved[p].get(key)
                                   for p in self._full_paths])
            for p, value in zip(self._leaves, values):
                if value is not None:
                    self.optimizer._state(p)[key].copy_(value)
        self.optimizer.step_count = int(ckpt["opt_state"]["step_count"])
        acc = ckpt.get("accumulation")
        if acc is not None:
            self._mini_step = int(acc["mini_step"])
            self._acc = (None if acc["mean"] is None
                         else local_leaves(acc["mean"]))
        self.step_num = int(ckpt["step"])
        return self.step_num

    @staticmethod
    def latest_checkpoint(output_dir: str) -> Optional[str]:
        """The `step_<n>` directory of the largest n in `output_dir` that
        holds a finished checkpoint, or None (the JAX package's glob,
        examples/minipile/train_fat5_minipile.py:115-116 in the reference).
        A save cut short leaves only `checkpoint.pt.tmp` in its directory,
        which is passed over."""
        if not os.path.isdir(output_dir):
            return None
        steps = [int(name[5:]) for name in os.listdir(output_dir)
                 if name.startswith("step_") and name[5:].isdigit()
                 and os.path.isfile(os.path.join(output_dir, name,
                                                 CHECKPOINT_FILE))]
        if not steps:
            return None
        return os.path.join(output_dir, f"step_{max(steps)}")

    # -- loops ---------------------------------------------------------------

    def _jsonl_logger(self) -> Callable[[Dict], None]:
        """Append each logged entry to `output_dir/train_log.jsonl`."""
        os.makedirs(self.tcfg.output_dir, exist_ok=True)
        path = os.path.join(self.tcfg.output_dir, "train_log.jsonl")

        def log(entry):
            with open(path, "a") as f:
                f.write(json.dumps(entry) + "\n")

        return log

    def _dispatch(self, hook: str, *args) -> None:
        if not self.rank0:
            return
        for cb in self.callbacks:
            getattr(cb, hook)(self, *args)

    def train(self, train_iter: Iterable[Dict], eval_iter=None,
              log_fn: Callable[[Dict], None] = None) -> Dict:
        """Steps over `train_iter` up to `max_steps` (at `max_steps` one
        more batch is fetched and left, as a `for` loop over it would). A
        logged entry's `tokens_per_sec` is every token since the start of
        this call over the time until the logging step's loss was read,
        which waits for the card to finish that step.

        Each fetch from the iterator is a span `train.batch`; the step that
        takes the batch is a span `train.step` (`step`, `tokens`) whose
        children are `train.to_device`, `train.forward`, `train.backward`,
        `train.optimizer` and, on a logging step, `train.log`
        (`utils/profiling.py`). Evaluation and checkpoints follow it."""
        logs = []
        tokens_seen = 0
        t_start = time.perf_counter()
        save_steps = self.tcfg.save_steps
        jsonl = self._jsonl_logger() if save_steps and self.rank0 else None
        self._dispatch("on_train_begin")
        try:
            for batch in _fetched(train_iter):
                if self.step_num >= self.tcfg.max_steps:
                    break
                with span("train.step") as step_span:
                    with span("train.to_device"):
                        device_batch = self._device_batch(batch)
                    metrics = self._step(device_batch)
                    self.step_num += 1
                    tokens = int(np.prod(np.shape(batch["input_ids"]))) + \
                        int(np.prod(np.shape(batch["labels"])))
                    tokens_seen += tokens
                    step_span.set(step=self.step_num, tokens=tokens)

                    if self.step_num % self.tcfg.logging_steps == 0 or \
                            self.step_num == self.tcfg.max_steps:
                        with span("train.log"):
                            # the loss's read waits for the step's end
                            loss = float(metrics["loss"])
                            grad_norm = float(metrics["grad_norm"])
                            dt = time.perf_counter() - t_start
                            entry = {"step": self.step_num, "loss": loss,
                                     "grad_norm": grad_norm,
                                     "tokens_per_sec":
                                         tokens_seen / max(dt, 1e-9)}
                            self._dispatch("on_log", entry)
                            logs.append(entry)
                            if log_fn and self.rank0:
                                log_fn(entry)
                            if jsonl:
                                jsonl(entry)

                if (self.tcfg.eval_steps and eval_iter is not None
                        and self.step_num % self.tcfg.eval_steps == 0):
                    ev = {"step": self.step_num, **self.evaluate(eval_iter)}
                    self._dispatch("on_eval", ev)
                    logs.append(ev)

                if save_steps and self.step_num % save_steps == 0:
                    self._dispatch("on_save",
                                   self.save_checkpoint(self.step_num))
        except KeyboardInterrupt:
            # keep the latest state before the interrupt propagates
            if save_steps:
                self.save_checkpoint(self.step_num)
            raise
        result = {"final_step": self.step_num, "logs": logs}
        self._dispatch("on_train_end", result)
        return result

    @torch.no_grad()
    def evaluate(self, eval_iter: Iterable[Dict]) -> Dict:
        if self.parallel:
            return self._evaluate_parallel(eval_iter)
        losses, accs = [], []
        for batch in eval_iter:
            db = self._device_batch(batch)
            out = t5.forward(self.config, self.params,
                             input_ids=db["input_ids"],
                             attention_mask=db.get("attention_mask"),
                             labels=db["labels"])
            losses.append(float(out["loss"]))
            accs.append(masked_accuracy(out["logits"].float().cpu().numpy(),
                                        np.asarray(batch["labels"])))
        return {"eval_loss": float(np.mean(losses)),
                "eval_masked_accuracy": float(np.mean(accs)),
                "eval_perplexity": float(np.exp(np.mean(losses)))}

    def _evaluate_parallel(self, eval_iter: Iterable[Dict]) -> Dict:
        """`evaluate` across ranks: each rank's rows, the loss over the
        global count and the accuracy's counts summed over "data" (the
        one-card numbers). The pipeline's stages each run the gathered
        whole model on their rows."""
        from flasht5_tpu_torch.parallel.vocab_parallel import (
            vocab_parallel_next_token)
        config, params = self.config, self.params
        if self.pp:
            params = self.full_params()
        data = self.mesh.get_group("data")
        split = config.tp_axis is not None and not config.tie_word_embeddings
        losses, accs = [], []
        for batch in eval_iter:
            db = self._device_batch(batch)
            labels = db["labels"]
            den = tp_step.global_denominator(config, labels, data)
            with use_mesh(self.mesh):
                out = t5.forward(config, params, input_ids=db["input_ids"],
                                 attention_mask=db.get("attention_mask"),
                                 labels=labels, loss_denominator=den)
                logits = out["logits"]
                if split:
                    preds = vocab_parallel_next_token(
                        logits.reshape(-1, logits.shape[-1]),
                        self.mesh.get_group("tensor")).view(labels.shape)
                else:
                    preds = logits.float().argmax(-1)
            mask = labels > 0
            sums = torch.stack([out["loss"].float(),
                                ((preds == labels) & mask).sum().float(),
                                mask.sum().float()])
            dist.all_reduce(sums, group=data)
            losses.append(float(sums[0]))
            accs.append(float(sums[1] / sums[2]) if sums[2] > 0 else 0.0)
        return {"eval_loss": float(np.mean(losses)),
                "eval_masked_accuracy": float(np.mean(accs)),
                "eval_perplexity": float(np.exp(np.mean(losses)))}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)
