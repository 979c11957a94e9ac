"""Pretraining/finetuning trainer on one GPU.

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

Not ported yet, and refused with NotImplementedError: data, tensor and
pipeline parallelism (`parallel/`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.optim import (AdamWScale, cosine_schedule,
                                     no_decay_mask, wsd_schedule)


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


def _refuse_unported(tcfg: TrainerConfig) -> None:
    for name in ("data_parallel", "tensor_parallel", "pipeline_parallel"):
        if getattr(tcfg, name) > 1:
            raise NotImplementedError(f"{name} > 1 comes with parallel/, "
                                      f"not ported yet")


CHECKPOINT_FILE = "checkpoint.pt"


class Trainer:
    """`Trainer(config, tcfg).train(batches)`: batches are dicts of numpy
    arrays (`input_ids`, `labels`, optionally `attention_mask`). Runs on
    `device` (default `cuda`; raises without a GPU unless device='cpu')."""

    def __init__(self, config: FlashT5Config, tcfg: TrainerConfig,
                 params: Optional[Any] = None,
                 callbacks: Optional[list] = None, device=None):
        _refuse_unported(tcfg)
        t5.check_supported(config)
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
            self.params = t5.init_params(config, seed=tcfg.seed,
                                         device=self.device)
        else:
            # a copy: the step updates the parameters in place
            self.params = _tree_map(
                lambda t: t.detach().to(self.device, copy=True), params)
        named = t5.tree_leaves_with_path(self.params)
        self._leaves = [p.requires_grad_(True) for _, p in named]
        decay = no_decay_mask(path for path, _ in named)
        groups = [
            {"params": [p for (_, p), d in zip(named, decay) if d],
             "weight_decay": tcfg.weight_decay},
            {"params": [p for (_, p), d in zip(named, decay) if not d],
             "weight_decay": 0.0},
        ]
        self.optimizer = AdamWScale(
            [g for g in groups if g["params"]], lr=self.schedule,
            betas=(tcfg.adam_beta1, tcfg.adam_beta2), eps=tcfg.adam_epsilon,
            kahan_sum=tcfg.kahan_sum,
            state_dtype=(runtime.torch_dtype(tcfg.state_dtype)
                         if tcfg.state_dtype else None))
        self.generator = torch.Generator(device=self.device).manual_seed(
            tcfg.seed + 1)
        self.step_num = 0
        # gradient accumulation: the running mean and the micro-batches in it
        self._acc = None
        self._mini_step = 0

    def _device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def _step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One training step (one micro-batch under accumulation); returns
        the loss and its gradient's norm as device tensors (read only when
        logged)."""
        loss = t5.forward(self.config, self.params,
                          input_ids=batch["input_ids"],
                          attention_mask=batch.get("attention_mask"),
                          labels=batch["labels"], generator=self.generator,
                          deterministic=False)["loss"]
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in self._leaves:
            if p.grad is None:          # a leaf the loss does not reach
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self._leaves]
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
        k = self.tcfg.gradient_accumulation_steps
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self._leaves]
            # optax.MultiSteps's running mean (its Welford form)
            torch._foreach_add_(self._acc, torch._foreach_div(
                torch._foreach_sub(grads, self._acc), self._mini_step + 1))
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
            norm = grad_norm if k == 1 else torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            factor = torch.where(norm < clip, 1.0, clip / norm)
            torch._foreach_mul_(grads, factor)
        self.optimizer.step()
        if k > 1:
            torch._foreach_zero_(self._acc)
        return metrics

    # -- checkpoints -------------------------------------------------------

    def save_checkpoint(self, step: int) -> str:
        """Write `output_dir/step_<step>/checkpoint.pt` (the parameters, the
        AdamWScale state and the step, `torch.save`) and the model's
        `output_dir/config.json`; returns the step directory."""
        path = os.path.abspath(os.path.join(self.tcfg.output_dir,
                                            f"step_{step}"))
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
        torch.save({"params": _tree_map(torch.Tensor.detach, self.params),
                    "opt_state": self.optimizer.state_dict(),
                    "accumulation": {"mini_step": self._mini_step,
                                     "mean": self._acc},
                    "step": step}, tmp)
        os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
        with open(os.path.join(self.tcfg.output_dir, "config.json"), "w") as f:
            f.write(self.config.to_json())
        return path

    def restore_checkpoint(self, path: str) -> int:
        """Load a `save_checkpoint` directory into this trainer's parameters
        and optimizer, in place; returns the restored step."""
        ckpt = torch.load(os.path.join(path, CHECKPOINT_FILE),
                          map_location=self.device, weights_only=True)
        saved = t5.tree_leaves_with_path(ckpt["params"])
        mine = t5.tree_leaves_with_path(self.params)
        if [p for p, _ in saved] != [p for p, _ in mine]:
            raise ValueError(f"{path}: the checkpoint's parameter tree is "
                             f"not this model's")
        with torch.no_grad():
            for (_, dst), (_, src) in zip(mine, saved):
                dst.copy_(src)
        self.optimizer.load_state_dict(ckpt["opt_state"])
        acc = ckpt.get("accumulation")
        if acc is not None:
            self._mini_step = int(acc["mini_step"])
            self._acc = acc["mean"]
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
        for cb in self.callbacks:
            getattr(cb, hook)(self, *args)

    def train(self, train_iter: Iterable[Dict], eval_iter=None,
              log_fn: Callable[[Dict], None] = None) -> Dict:
        logs = []
        tokens_seen = 0
        t_start = time.perf_counter()
        save_steps = self.tcfg.save_steps
        jsonl = self._jsonl_logger() if save_steps else None
        self._dispatch("on_train_begin")
        try:
            for batch in train_iter:
                if self.step_num >= self.tcfg.max_steps:
                    break
                metrics = self._step(self._device_batch(batch))
                self.step_num += 1
                tokens_seen += int(np.prod(np.shape(batch["input_ids"]))) + \
                    int(np.prod(np.shape(batch["labels"])))

                if self.step_num % self.tcfg.logging_steps == 0 or \
                        self.step_num == self.tcfg.max_steps:
                    dt = time.perf_counter() - t_start
                    entry = {"step": self.step_num,
                             "loss": float(metrics["loss"]),
                             "grad_norm": float(metrics["grad_norm"]),
                             "tokens_per_sec": tokens_seen / max(dt, 1e-9)}
                    self._dispatch("on_log", entry)
                    logs.append(entry)
                    if log_fn:
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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)
