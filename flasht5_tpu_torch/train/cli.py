"""The pretraining driver: one YAML run configuration, end to end.

    python -m flasht5_tpu_torch.train.cli <config.yaml> [--device cpu]

The counterpart of the repository's `train.py`: the YAML's model_args,
training_args and collator_args sections drive the tokenizer, the
pretokenized dataset, the UL2 collator (the reference's 7-denoiser mixture,
train_flash_t5.py:57-64), AdamWScale with its schedule, and the trainer
loop with checkpoints and resume. `main` loads the tokenizer (`transformers`)
and the datasets (`datasets`) and hands them to `run`, which takes any
tokenizer with the HF surface the collator reads and any indexable set of
rows with `input_ids`.

Runs on the card unless `--device cpu`, and raises where there is none. As
`train.py` does, a resumed run starts its batch iterator (and the
collator's random stream) from the seed again, so it sees the first batches
again.

Across ranks, the YAML's training_args `data_parallel`,
`tensor_parallel`, `pipeline_parallel` and `pp_microbatches` lay them out
(as `train.py:93-95` reads them), one process a card:

    python -m torch.distributed.run --nproc-per-node N \
        -m flasht5_tpu_torch.train.cli <config.yaml> [--device cpu]

`main` then joins the process group (`parallel.distributed.
initialize_multihost`: NCCL on the cards, gloo with `--device cpu`). Every
rank collates the same global batch of `per_device_train_batch_size` rows
and takes its "data" slice of it; rank 0 prints and writes the files.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np

from flasht5_tpu_torch.config import FlashT5Config, load_run_config
from flasht5_tpu_torch.data import DataCollatorForUL2, Denoiser
from flasht5_tpu_torch.train import callbacks as cb
from flasht5_tpu_torch.train.trainer import Trainer, TrainerConfig

# The reference's 7-denoiser UL2 mixture (train_flash_t5.py:57-64)
UL2_DENOISERS = [
    Denoiser(mu=3.0, r=0.15, max_spans=100, prefix="[R]"),
    Denoiser(mu=8.0, r=0.15, max_spans=100, prefix="[R]"),
    Denoiser(mu=4.0, r=0.0, max_spans=1, prefix="[S]"),
    Denoiser(mu=3.0, r=0.5, max_spans=100, prefix="[X]"),
    Denoiser(mu=8.0, r=0.5, max_spans=100, prefix="[X]"),
    Denoiser(mu=64.0, r=0.15, max_spans=100, prefix="[X]"),
    Denoiser(mu=64.0, r=0.5, max_spans=100, prefix="[X]"),
]
UL2_PROPORTIONS = [0.165, 0.165, 0.34, 0.0825, 0.0825, 0.0825, 0.0825]


def batch_iterator(dataset, collator, batch_size, seed=0, epochs=10_000):
    """Collated batches over `dataset` in a seeded order, epoch by epoch."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    for _ in range(epochs):
        order = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            examples = [{"input_ids": np.asarray(dataset[int(i)]["input_ids"])}
                        for i in idx]
            yield collator(examples)


def trainer_config(targs: dict) -> TrainerConfig:
    """`TrainerConfig` from a YAML's training_args, with `train.py`'s
    names and defaults."""
    return TrainerConfig(
        learning_rate=float(targs.get("learning_rate", 1e-3)),
        adam_beta1=float(targs.get("adam_beta1", 0.9)),
        adam_beta2=float(targs.get("adam_beta2", 0.999)),
        adam_epsilon=float(targs.get("adam_epsilon", 1e-6)),
        weight_decay=float(targs.get("weight_decay", 0.0)),
        max_steps=int(targs.get("max_steps", 10000)),
        warmup_steps=int(targs.get("warmup_steps", 0)),
        warmup_ratio=float(targs.get("warmup_ratio", 0.0)),
        lr_scheduler=str(targs.get("lr_scheduler_type", "cosine")),
        gradient_clip_norm=targs.get("max_grad_norm"),
        logging_steps=int(targs.get("logging_steps", 50)),
        eval_steps=int(targs.get("eval_steps", 0)),
        save_steps=int(targs.get("save_steps", 0)),
        output_dir=str(targs.get("output_dir", "checkpoints")),
        seed=int(targs.get("seed", 0)),
        data_parallel=int(targs.get("data_parallel", 1)),
        tensor_parallel=int(targs.get("tensor_parallel", 1)),
        pipeline_parallel=int(targs.get("pipeline_parallel", 1)),
        pp_microbatches=int(targs.get("pp_microbatches", 4)),
        gradient_accumulation_steps=int(
            targs.get("gradient_accumulation_steps", 1)),
        kahan_sum=bool(targs.get("kahan_sum", False)),
        state_dtype=targs.get("state_dtype"),
    )


def make_collator(run_cfg: dict, tokenizer,
                  model_cfg: FlashT5Config) -> DataCollatorForUL2:
    """The UL2 collator of a run, with `train.py`'s defaults."""
    targs, cargs = run_cfg["training_args"], run_cfg["collator_args"]
    return DataCollatorForUL2(
        tokenizer,
        max_length=int(cargs.get("max_length", model_cfg.max_sequence_length)),
        max_labels_length=int(cargs.get("max_labels_length", 256)),
        batch_size=int(targs.get("per_device_train_batch_size", 8)),
        denoiser_list=UL2_DENOISERS,
        denoiser_proportions=UL2_PROPORTIONS,
        causal=bool(cargs.get("causal", False)),
        random_chunk=bool(cargs.get("random_chunk", True)),
        fixed_batch_size=bool(cargs.get("fixed_batch_size", True)),
        min_size_inputs=int(cargs.get("min_size_inputs", 10)),
        seed=int(targs.get("seed", 0)),
    )


def _callbacks(targs: dict, output_dir: str, device=None) -> list:
    """The trackers `report_to` names (`train.py`'s mapping): jsonl, wandb,
    clearml and energy. A tracker whose package is missing is printed and
    skipped, as `train.py` does; an unknown name raises."""
    callbacks = []
    project = str(targs.get("project", "flasht5_tpu"))
    for tracker in targs.get("report_to", ["jsonl"]):
        try:
            if tracker == "jsonl":
                callbacks.append(cb.JSONLCallback(
                    f"{output_dir}/tracker_log.jsonl"))
            elif tracker == "wandb":
                callbacks.append(cb.WandbCallback(project=project))
            elif tracker == "clearml":
                callbacks.append(cb.ClearMLCallback(
                    project=project,
                    task_name=str(targs.get("run_name", "pretrain"))))
            elif tracker == "energy":
                callbacks.append(cb.EnergyCallback(
                    watts_per_chip=targs.get("watts_per_chip"),
                    out_path=f"{output_dir}/energy.json", device=device))
            else:
                raise ValueError(f"unknown tracker {tracker!r}")
        except ImportError as e:
            print(f"tracker {tracker!r} unavailable: {e}")
    return callbacks


def run(run_cfg: dict, tokenizer, train_set, eval_set=None, *, device=None,
        log_fn: Callable = print):
    """Everything after loading: the model configuration with the
    tokenizer's vocabulary and pad id, the collator, the trainer and its
    trackers, resume from the latest checkpoint, training, the final save.
    Returns (trainer, the result of `Trainer.train`)."""
    model_cfg = FlashT5Config.from_dict(run_cfg["model_args"]).replace(
        vocab_size=len(tokenizer), pad_token_id=tokenizer.pad_token_id)
    targs = run_cfg["training_args"]
    collator = make_collator(run_cfg, tokenizer, model_cfg)
    tcfg = trainer_config(targs)
    trainer = Trainer(model_cfg, tcfg,
                      callbacks=_callbacks(targs, tcfg.output_dir, device),
                      device=device)
    resume = Trainer.latest_checkpoint(tcfg.output_dir)
    if resume:
        if trainer.rank0:
            log_fn(f"resuming from {resume}")
        trainer.restore_checkpoint(resume)

    train_iter = batch_iterator(train_set, collator, collator.batch_size,
                                seed=tcfg.seed)
    eval_iter = None
    if eval_set is not None:
        eval_iter = batch_iterator(eval_set, collator, collator.batch_size,
                                   seed=tcfg.seed + 1, epochs=1)
    result = trainer.train(train_iter, eval_iter, log_fn=log_fn)
    trainer.save_checkpoint(trainer.step_num)
    if trainer.rank0:
        log_fn(f"done: {result['final_step']} steps")
    return trainer, result


def main(config_path: str, device: Optional[str] = None):
    """`train.py`'s `main`: the YAML, the tokenizer and the datasets, then
    `run`."""
    if "WORLD_SIZE" in os.environ:
        from flasht5_tpu_torch.parallel.distributed import (
            initialize_multihost)
        initialize_multihost(device=device)
    run_cfg = load_run_config(config_path)
    targs = run_cfg["training_args"]
    from transformers import AutoTokenizer
    tokenizer = AutoTokenizer.from_pretrained(targs["tokenizer_name"])
    import datasets
    train_set = datasets.load_from_disk(targs["train_dataset_path"])
    eval_set = (datasets.load_from_disk(targs["eval_dataset_path"])
                if targs.get("eval_dataset_path") else None)
    return run(run_cfg, tokenizer, train_set, eval_set, device=device,
               log_fn=lambda entry: print(entry, flush=True))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("config", help="the run's YAML")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.config, device=args.device)
