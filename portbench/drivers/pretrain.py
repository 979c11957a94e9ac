"""Pretraining: `Trainer.train` fed by `train.cli.batch_iterator` over
`train.cli.make_collator`, as `train.cli.run` builds them, without its
resume and its final save.

Set-up builds the one trainer, on weights the harness draws from the seed,
and drives it through its first three steps with the window's own call and
feed (the set-up also warms every shape the window uses: the batches are of
one shape). The window is the same trainer, fed on until `--seconds` have
passed: tokens are every input and label token of every step it took, over
its wall, read after a synchronize.

The checks: the collator's batches undone back to slices of the corpus
(`reference/span_ref.py`, exact); a float32 reference
(`reference/t5_ref.py`, AdamWScale in `reference/adamw_ref.py`) follows
the first three steps on the same batches and weights, after the window.
Compared: each step's loss; each leaf's first gradient as the optimizer
got it (its first moment after one step over 1 - beta1); each leaf's
change over the three steps.
"""

from __future__ import annotations

import dataclasses
import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench.bench import compare, traffic, weights
from portbench.bench.tokenizer import StubTokenizer
from portbench.bench.trace import Tracer, span
from portbench.reference import adamw_ref, span_ref, t5_ref
from portbench.work import t5_model

SETUP_STEPS = 3
TRACE_FROM, TRACE_STEPS = 2, 3
REF_BLOCK_ROWS = 8
# the control: the configuration states bfloat16 activations, so the
# reference rounds its activations (and gradients) to float8 e4m3
CONTROL = t5_ref.Precision(act="fp8")


def keystr(path) -> str:
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def _sync(device) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


class Feed:
    """The program's batch iterator as the trainer sees it: each batch's
    collation timed, stopped at a count or a deadline, the tracer started
    and stopped between steps."""

    def __init__(self, batches, keep: int):
        self.batches = batches
        self.keep = keep
        self.kept = []
        self.count = 0
        self.limit = None
        self.deadline = None
        self.collate_s = 0.0
        self.tracer = None

    def __iter__(self):
        return self

    def __next__(self):
        if self.limit is not None and self.count >= self.limit:
            raise StopIteration
        if self.deadline is not None and time.perf_counter() >= \
                self.deadline:
            raise StopIteration
        if self.tracer is not None and \
                self.count == TRACE_FROM + TRACE_STEPS:
            self.tracer.stop()
        with span("collate"):
            t = time.perf_counter()
            batch = next(self.batches)
            self.collate_s += time.perf_counter() - t
        if self.tracer is not None and self.count == TRACE_FROM:
            # after the collation, so the traced stretch starts with a step
            # (its start waits for the card to finish the step before)
            self.tracer.start()
        self.count += 1
        if len(self.kept) < self.keep:
            self.kept.append(batch)
        return batch


def _leaf_norms(trainer, fn):
    return {name: fn(leaf, trainer.optimizer.state.get(leaf, {}))
            for name, leaf in zip(trainer._paths, trainer._leaves)}


def plant(trainer, fault):
    """The faults a training cell can have, for the checks' own tests."""
    if fault == "unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":
        whole = trainer._device_batch

        def half(batch):
            return {k: v[: v.shape[0] // 2] for k, v in whole(batch).items()}
        trainer._device_batch = half
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")


class Inputs:
    """Everything a run draws from its seed: the run configuration, the
    stub tokenizer, the corpus, and the program's collator and batch
    iterator over it."""

    def __init__(self, ctx):
        from flasht5_tpu_torch.config import FlashT5Config
        from flasht5_tpu_torch.train import cli

        cfg = ctx.cell.config
        vocab = int(cfg["vocab_size"])
        self.s_weights, s_docs, s_train = traffic.seeds(ctx.seed, 3)
        self.out_dir = tempfile.mkdtemp(prefix="portbench-")
        self.targs = dict(cfg["training_args"], seed=s_train,
                          output_dir=self.out_dir)
        run_cfg = {"model_args": cfg["model_args"],
                   "training_args": self.targs,
                   "collator_args": cfg["collator_args"]}
        tok = StubTokenizer(vocab)
        self.model_cfg = FlashT5Config.from_dict(cfg["model_args"]).replace(
            vocab_size=len(tok), pad_token_id=tok.pad_token_id)
        self.m = dict(cfg["model_args"], vocab_size=vocab, pad_token_id=0)
        self.vocab = vocab
        self.docs = traffic.documents(ctx.cell.traffic["documents"], vocab,
                                      s_docs)
        collator = cli.make_collator(run_cfg, tok, self.model_cfg)
        self.tcfg = cli.trainer_config(self.targs)
        self.callbacks = cli._callbacks(self.targs, self.tcfg.output_dir,
                                        ctx.device)
        self.feed = Feed(cli.batch_iterator(
            self.docs, collator, collator.batch_size, seed=self.tcfg.seed),
            keep=SETUP_STEPS)


def run(ctx):
    """Set-up and window, then the checks once the trainer is freed."""
    got = body(ctx)
    dev = ctx.device
    if dev == "cuda":
        torch.cuda.empty_cache()
    inputs = got.pop("inputs")
    shutil.rmtree(inputs.out_dir, ignore_errors=True)
    ref = reference_steps(inputs.m, inputs.s_weights, inputs.feed.kept,
                          inputs.targs, dev)
    judge(ctx, got, ref)
    check_batches(ctx, inputs, inputs.feed.kept)


def body(ctx):
    """The trainer's first three steps, then the window. Returns the
    numbers the checks compare."""
    from flasht5_tpu_torch.train.trainer import Trainer

    dev = ctx.device
    inputs = Inputs(ctx)
    m, tcfg, feed = inputs.m, inputs.tcfg, inputs.feed
    params = weights.make(m, inputs.s_weights, dev)
    trainer = Trainer(inputs.model_cfg, tcfg, params=params, device=dev,
                      callbacks=inputs.callbacks)
    plant(trainer, ctx.fault)

    # the first three steps, each loss logged
    logged = []
    trainer.tcfg = dataclasses.replace(tcfg, logging_steps=1)
    feed.limit = 1
    trainer.train(feed, log_fn=logged.append)
    b1 = tcfg.adam_beta1
    grad1 = _leaf_norms(trainer, lambda p, st: float(
        st["exp_avg"].float().norm()) / (1 - b1) if "exp_avg" in st else 0.0)
    feed.limit = SETUP_STEPS
    trainer.train(feed, log_fn=logged.append)
    losses = [e["loss"] for e in logged if isinstance(e, dict)]
    start = {keystr(p): t for p, t in weights.leaves(params)}
    change = {name: float((leaf.detach().float()
                           - start[name].float()).norm())
              for name, leaf in zip(trainer._paths, trainer._leaves)}
    del params, start
    trainer.tcfg = tcfg
    gc.collect()

    # the window
    tracer = Tracer(ctx.trace_on and dev == "cuda")
    feed.tracer = tracer
    feed.count, feed.limit, feed.collate_s = 0, None, 0.0
    _sync(dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ctx.setup_s = time.perf_counter() - ctx.t_start
    t0 = time.perf_counter()
    feed.deadline = t0 + ctx.seconds
    trainer.train(feed)
    _sync(dev)
    wall = time.perf_counter() - t0
    tracer.stop()
    if dev == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()
    ctx.trace = tracer.read()
    steps = feed.count
    batch, enc_len = feed.kept[0]["input_ids"].shape
    dec_len = feed.kept[0]["labels"].shape[1]
    traced = min(max(steps - TRACE_FROM, 0), TRACE_STEPS)
    heads, d = m["num_heads"], m["d_kv"]
    ctx.window = {
        "wall_s": wall, "steps": steps,
        "tokens": steps * batch * (enc_len + dec_len),
        "collate_s": feed.collate_s,
        "model_flops": steps * t5_model.train_step_flops(m, batch, enc_len,
                                                         dec_len),
        "ops": {"bias_attn_bwd": {"calls": [
            (dict(batch=batch, heads=heads, m=enc_len, n=enc_len, d=d,
                  causal=False), m["num_layers"] * traced),
            (dict(batch=batch, heads=heads, m=dec_len, n=dec_len, d=d,
                  causal=True),
             (m.get("num_decoder_layers") or m["num_layers"]) * traced)]}},
    }
    ctx.attempted, ctx.failed = steps, 0
    del trainer, feed.batches
    gc.collect()
    return {"losses": losses, "grad1": grad1, "change": change,
            "inputs": inputs}


def check_batches(ctx, inputs, batches):
    """The collator's batches undone (`reference/span_ref.py`): each row
    has to give back a slice of a document of the corpus."""
    v = inputs.vocab
    ctx.check("collate_bad_rows", span_ref.bad_rows(
        batches, inputs.docs, v, first_sentinel=v - 1,
        last_sentinel=v - 100))


def judge(ctx, got, ref):
    """The three numbers compared, each against its limit."""
    keep = compare.moving_leaves(ref["grad1"])
    losses = got["losses"]
    loss_gaps = [compare.relative_gap(a, b)
                 for a, b in zip(losses, ref["losses"])]
    if len(losses) != SETUP_STEPS or not all(np.isfinite(losses)):
        loss_gaps.append(float("inf"))
    g_gap, g_leaf = compare.worst_leaf_gap(got["grad1"], ref["grad1"], keep)
    c_gap, c_leaf = compare.worst_leaf_gap(got["change"], ref["change"],
                                           keep)
    ctx.check("loss_gap", max(loss_gaps))
    ctx.check("grad_gap", g_gap)
    ctx.check("change_gap", c_gap)
    ctx.readings.update({
        "losses": losses, "reference_losses": ref["losses"],
        "grad_gap_leaf": g_leaf, "change_gap_leaf": c_leaf,
        "leaves_compared": len(keep), "leaves": len(ref["grad1"])})


def control(ctx, precision):
    """The reference computed at `precision` in the program's place, on the
    run's first three batches, judged as the program is."""
    inputs = Inputs(ctx)
    batches = [next(inputs.feed) for _ in range(SETUP_STEPS)]
    shutil.rmtree(inputs.out_dir, ignore_errors=True)
    got = reference_steps(inputs.m, inputs.s_weights, batches,
                          inputs.targs, ctx.device, precision)
    ref = reference_steps(inputs.m, inputs.s_weights, batches,
                          inputs.targs, ctx.device)
    judge(ctx, got, ref)


def reference_steps(m, seed, batches, targs, device,
                    precision=t5_ref.FLOAT32):
    """The reference's first steps on `batches` from the seed's weights:
    each step's loss, each leaf's first gradient norm and each leaf's
    change over the steps."""
    t5_ref.no_tf32()
    tree = weights.make(m, seed, device)
    named = {keystr(p): t for p, t in weights.leaves(tree)}
    start = {k: t.clone() for k, t in named.items()}
    for t in named.values():
        t.requires_grad_(True)
    names = sorted(named)
    if targs.get("lr_scheduler_type", "cosine") != "cosine":
        raise ValueError("the reference follows the cosine schedule only")
    total = int(targs["max_steps"])
    warmup = int(targs.get("warmup_steps", 0)) or int(
        total * float(targs.get("warmup_ratio", 0.0)))
    base = float(targs["learning_rate"])
    opt = adamw_ref.AdamWScaleRef(
        names, lambda t: adamw_ref.cosine_lr(t, base, total, warmup),
        betas=(float(targs.get("adam_beta1", 0.9)),
               float(targs.get("adam_beta2", 0.999))),
        eps=float(targs.get("adam_epsilon", 1e-6)),
        weight_decay=float(targs.get("weight_decay", 0.0)))
    leaves = [named[k] for k in names]
    losses, grad1 = [], None
    for step, batch in enumerate(batches):
        ids = torch.as_tensor(np.asarray(batch["input_ids"])).long().to(
            device)
        labels = torch.as_tensor(np.asarray(batch["labels"])).long().to(
            device)
        rows = labels.numel()
        grads = [torch.zeros_like(t) for t in leaves]
        loss = 0.0
        prepared = t5_ref.prepare(tree, precision)
        for r in range(0, ids.shape[0], REF_BLOCK_ROWS):
            part = t5_ref.loss_sum(prepared, ids[r:r + REF_BLOCK_ROWS],
                                   labels[r:r + REF_BLOCK_ROWS], m,
                                   precision) / rows
            for acc, g in zip(grads, torch.autograd.grad(
                    part, leaves, retain_graph=False, allow_unused=True)):
                if g is not None:
                    acc.add_(g)
            loss += float(part.detach())
        losses.append(loss)
        if step == 0:
            grad1 = {k: float(g.norm()) for k, g in zip(names, grads)}
        opt.step(named, dict(zip(names, grads)))
    change = {k: float((named[k].detach() - start[k]).norm())
              for k in names}
    return {"losses": losses, "grad1": grad1, "change": change}
