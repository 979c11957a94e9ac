"""Quantization-quality harness: the perplexity of a model in full precision
and in four weight-only quantized variants (the counterpart of the root
`bench_quality.py`).

    python -m flasht5_tpu_torch.quality                       # synthetic
    python -m flasht5_tpu_torch.quality ckpt.safetensors      # FAT5 naming
    ... [--device cpu]

Scores teacher-forced perplexity on a fixed token stream with the model in
full precision, then INT8 and FP8-E4M3, each with per-output-channel and
group-wise (g64) scales, and prints one JSON line per variant with the
keys of `bench_quality.py`. Weights whose input dim is not divisible by the
group size fall back to per-channel scales; `g64_fallbacks` counts them.
Runs on the card unless `--device cpu`; on the card the full-precision
scoring takes the fused lm_head+CE kernel.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import load_fat5_safetensors
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.quantize import count_group_fallbacks, quantize_params

VARIANTS = (
    ("int8_weight_only", "int8", None),
    ("fp8_weight_only", "fp8", None),
    ("int8_weight_only_g64", "int8", 64),
    ("fp8_weight_only_g64", "fp8", 64),
)

Batch = Tuple[np.ndarray, np.ndarray]


def eval_ppl(config: FlashT5Config, params, batches: Sequence[Batch]
             ) -> float:
    """Teacher-forced perplexity over (input_ids, labels) batches, on the
    device that holds the parameters. On the card the fused lm_head+CE
    kernel scores (a forward pays no logits recompute), as the JAX package
    turns it on for the TPU; `t5.forward` takes the unfused path by itself
    where the lm_head is quantized or the embeddings are tied."""
    device = params["shared"]["embedding"].device
    if device.type == "cuda":
        config = config.replace(use_fused_lm_head_ce=True)
    with torch.no_grad():
        losses = [float(t5.forward(
            config, params, input_ids=torch.from_numpy(i).to(device),
            labels=torch.from_numpy(l).to(device))["loss"])
            for i, l in batches]
    return float(np.exp(np.mean(losses)))


def checkpoint_config(params) -> FlashT5Config:
    """The configuration of a FAT5 checkpoint from its shapes
    (`bench_quality.py:49-55`)."""
    emb = params["shared"]["embedding"]
    return FlashT5Config(
        vocab_size=emb.shape[0], d_model=emb.shape[1],
        num_layers=len(params["encoder"]["block"]),
        num_heads=params["encoder"]["block"][0]["self_attention_layer"][
            "self_attention"]["pe_encoding"]["relative_attention_bias"]
        .shape[1],
        attention_scale=1.0, dropout_rate=0.0)


def checkpoint_batches(config: FlashT5Config) -> List[Batch]:
    """4 seeded batches of 4 x 128 input and 4 x 64 label tokens."""
    rng = np.random.default_rng(0)
    return [(rng.integers(2, config.vocab_size, size=(4, 128)).astype(
                 np.int32),
             rng.integers(2, config.vocab_size, size=(4, 64)).astype(
                 np.int32))
            for _ in range(4)]


def synthetic_model(device) -> Tuple[FlashT5Config, dict, List[Batch]]:
    """The tiny copy-with-shift model, trained briefly with AdamWScale so
    that the quantization delta is measured on non-random weights, and its
    4 evaluation batches of the same task (`bench_quality.py:57-100`)."""
    from flasht5_tpu_torch.train import Trainer, TrainerConfig

    config = FlashT5Config(vocab_size=1024, d_model=128, d_kv=32,
                           num_heads=4, d_ff=256, num_layers=4,
                           dropout_rate=0.0, attention_scale=1.0,
                           pad_token_id=0)
    n_train = 60 if device.type == "cuda" else 10
    trng = np.random.default_rng(7)
    train = []
    for _ in range(n_train):
        ids = trng.integers(2, config.vocab_size // 2,
                            size=(8, 64)).astype(np.int32)
        train.append({"input_ids": ids, "labels": (
            (ids[:, :32] + 3) % config.vocab_size).astype(np.int32)})
    trainer = Trainer(config, TrainerConfig(
        learning_rate=3e-3, lr_scheduler="constant", max_steps=n_train,
        logging_steps=n_train), device=device)
    trainer.train(train)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(4):
        ids = rng.integers(2, config.vocab_size // 2,
                           size=(4, 64)).astype(np.int32)
        batches.append((ids, ((ids[:, :32] + 3)
                              % config.vocab_size).astype(np.int32)))
    return config, trainer.params, batches


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Print and return one result per quantized variant."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", nargs="?",
                    help="a FAT5-named safetensors file")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = runtime.resolve_device(args.device)
    if args.checkpoint:
        params = load_fat5_safetensors(args.checkpoint, device=device)
        config = checkpoint_config(params)
        batches = checkpoint_batches(config)
    else:
        config, params, batches = synthetic_model(device)
    with torch.no_grad():
        return score_variants(config, params, batches)


def score_variants(config: FlashT5Config, params, batches: Sequence[Batch]
                   ) -> List[dict]:
    """The full-precision perplexity, then each quantized variant's: one
    JSON line each, printed and returned."""
    ppl_fp = eval_ppl(config, params, batches)
    results = []
    for tag, fmt, group_size in VARIANTS:
        fallbacks = (count_group_fallbacks(params, group_size)
                     if group_size else None)
        ppl_q = eval_ppl(config, quantize_params(params, fmt, group_size),
                         batches)
        delta = ppl_q - ppl_fp
        # acceptance: the north star's absolute criterion (<= 0.1 ppl) on a
        # real low-perplexity checkpoint; relative <= 1% as the scale-aware
        # criterion for the synthetic model
        ok = abs(delta) <= 0.1 or abs(delta) / ppl_fp <= 0.01
        line = {
            "metric": f"delta_ppl_{tag}",
            "value": round(delta, 4),
            "unit": "ppl",
            "ppl_fp": round(ppl_fp, 4),
            "ppl_quant": round(ppl_q, 4),
            "rel_delta": round(delta / ppl_fp, 6),
            "vs_baseline": 1.0 if ok else 0.0,
            **({} if fallbacks is None else {"g64_fallbacks": fallbacks}),
        }
        print(json.dumps(line), flush=True)
        results.append(line)
    return results


if __name__ == "__main__":
    main()
