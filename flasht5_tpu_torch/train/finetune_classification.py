"""Sequence-classification fine-tuning over an encoder trunk.

    python -m flasht5_tpu_torch.train.finetune_classification [ckpt] \\
        --num-labels N [--hf] --steps S --lr LR \\
        [--attention-type pallas_rpe] [--dtype bfloat16] [--device cpu]

The counterpart of `examples/finetune_classification.py`: the trunk comes
from a FAT5-named safetensors checkpoint (`--hf`: HF T5 names) or, without
one, is seeded at the JAX demo's toy size; a classification head is
attached (`heads.init_sequence_classification_params`), and AdamWScale with
weight decay 0.01 on the `no_decay_mask` grouping trains both on the demo's
toy task: the label says whether a row's first token lies in the upper half
of the vocabulary, four fixed batches of 16 x 24 tokens drawn from a numpy
seed, each ending in EOS. It prints the loss and accuracy every 20 steps.

A checkpoint's configuration takes the vocabulary, width and depth from the
trunk's shapes, its heads from Wq's width over d_kv 64 and d_ff from its
feed-forward, as the JAX demo takes the first three; dropout 0 and T5's
unscaled attention as there. `--attention-type` other than `ref` also turns
on the fused `rms_norm`, so that `pallas_rpe` runs the card's attention and
`rms_norm` kernels forward and backward. Runs on the card unless
`--device cpu`, and raises where there is none. `train_step` is one step as
a function of its own, for callers that drive the loop themselves.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.models import heads, t5
from flasht5_tpu_torch.optim import AdamWScale, no_decay_mask

TOY_BATCHES, TOY_ROWS, TOY_LEN = 4, 16, 24


def demo_config(attention_type: str = "ref",
                dtype: str = "float32") -> FlashT5Config:
    """The JAX demo's toy trunk (vocabulary 512, 2 layers of d_model 64)."""
    return FlashT5Config(vocab_size=512, d_model=64, d_kv=16, num_heads=4,
                         d_ff=128, num_layers=2, dropout_rate=0.0,
                         attention_scale=1.0, pad_token_id=0, dtype=dtype,
                         attention_type=attention_type,
                         use_fused_layernorm=attention_type != "ref")


def config_for_trunk(trunk, attention_type: str = "ref",
                     dtype: str = "float32") -> FlashT5Config:
    """A configuration that fits an imported trunk's shapes."""
    emb = trunk["shared"]["embedding"]
    blocks = trunk["encoder"]["block"]
    d_kv = 64            # the configuration's default, as the JAX demo's
    ff = blocks[0]["ff_layer"]
    wi = ff["act"].get("wi_0", ff["act"].get("wi"))
    return FlashT5Config(
        vocab_size=emb.shape[0], d_model=emb.shape[1],
        num_layers=len(blocks), d_kv=d_kv,
        num_heads=blocks[0]["self_attention_layer"]["self_attention"][
            "Wq"].shape[1] // d_kv,
        d_ff=wi.shape[1], use_glu_mlp="wi_0" in ff["act"],
        dropout_rate=0.0, attention_scale=1.0, pad_token_id=0, dtype=dtype,
        attention_type=attention_type,
        use_fused_layernorm=attention_type != "ref")


def toy_pool(config: FlashT5Config, seed: int = 0, batches: int = TOY_BATCHES,
             rows: int = TOY_ROWS, length: int = TOY_LEN
             ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The demo's fixed dataset: (ids, labels) int32 batches, label 1 where
    the row's first token lies in the upper half of the vocabulary."""
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(batches):
        ids = rng.integers(2, config.vocab_size,
                           size=(rows, length)).astype(np.int32)
        ids[:, -1] = config.eos_token_id
        y = (ids[:, 0] >= config.vocab_size // 2).astype(np.int32)
        pool.append((ids, y))
    return pool


def attach_head(config: FlashT5Config, trunk, num_labels: int,
                seed: int = 1):
    """A classification head (from `seed`) over an imported trunk, on the
    trunk's device."""
    device = trunk["shared"]["embedding"].device
    full = heads.init_sequence_classification_params(
        config, num_labels, seed=seed, device=device)
    full["shared"] = trunk["shared"]
    full["encoder"] = trunk["encoder"]
    return full


def make_optimizer(params, lr: float,
                   weight_decay: float = 0.01) -> AdamWScale:
    """AdamWScale over every leaf (each made trainable), weight decay on
    the `no_decay_mask` grouping, a constant learning rate."""
    named = t5.tree_leaves_with_path(params)
    decay = no_decay_mask(path for path, _ in named)
    groups = [
        {"params": [p.requires_grad_(True) for (_, p), d in zip(named, decay)
                    if d], "weight_decay": weight_decay},
        {"params": [p.requires_grad_(True) for (_, p), d in zip(named, decay)
                    if not d], "weight_decay": 0.0},
    ]
    return AdamWScale([g for g in groups if g["params"]], lr=lr)


def train_step(config: FlashT5Config, params, optimizer: AdamWScale,
               ids: torch.Tensor, y: torch.Tensor, num_labels: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the demo's loop: the single-label loss, its gradient,
    the AdamWScale update (in place). Returns (loss, accuracy) as device
    tensors, read only where the caller needs them."""
    out = heads.sequence_classification_forward(
        config, params, ids, labels=y,
        problem_type="single_label_classification", num_labels=num_labels)
    optimizer.zero_grad(set_to_none=True)
    out["loss"].backward()
    optimizer.step()
    acc = (torch.argmax(out["logits"].detach(), -1) == y).float().mean()
    return out["loss"].detach(), acc


def main(argv: Optional[List[str]] = None) -> List[Tuple[int, float, float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--num-labels", type=int, default=2)
    ap.add_argument("--hf", action="store_true",
                    help="checkpoint uses HF T5 naming")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--attention-type", default="ref",
                    help="ref (plain), pallas_rpe or pallas (the kernels)")
    ap.add_argument("--dtype", default="float32",
                    help="activation dtype: float32 or bfloat16")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = runtime.resolve_device(args.device)

    if args.checkpoint:
        from flasht5_tpu_torch.convert import (load_fat5_safetensors,
                                               load_hf_t5_safetensors)
        loader = load_hf_t5_safetensors if args.hf else load_fat5_safetensors
        trunk = loader(args.checkpoint, device=device)
        trunk = {"shared": trunk["shared"], "encoder": trunk["encoder"]}
        config = config_for_trunk(trunk, args.attention_type, args.dtype)
    else:   # demo mode: a seeded trunk on the toy task
        config = demo_config(args.attention_type, args.dtype)
        trunk = t5.init_encoder_params(config, seed=0, device=device)

    params = attach_head(config, trunk, args.num_labels)
    optimizer = make_optimizer(params, args.lr)
    pool = [(torch.from_numpy(ids).to(device), torch.from_numpy(y).to(device))
            for ids, y in toy_pool(config)]
    logged = []
    for i in range(args.steps):
        ids, y = pool[i % len(pool)]
        loss, acc = train_step(config, params, optimizer, ids, y,
                               args.num_labels)
        if i % 20 == 0 or i == args.steps - 1:
            logged.append((i, float(loss), float(acc)))
            print(f"step {i}: loss {logged[-1][1]:.4f} acc "
                  f"{logged[-1][2]:.3f}", flush=True)
    return logged


if __name__ == "__main__":
    main()
