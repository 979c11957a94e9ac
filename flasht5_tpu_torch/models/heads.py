"""Task heads over the encoder-only trunk.

The counterpart of `flasht5_tpu/models/heads.py` (the reference's custom
heads, src/model/custom_heads_flash_t5.py): token classification, a tanh
classification head, sequence classification pooled on each row's last EOS
with its loss picked by `problem_type`, and extractive QA with start and end
logits. All are functions over parameter trees whose `shared` and `encoder`
subtrees are the trunk's (`t5.init_encoder_params`), so a FAT5 or HF
checkpoint's trunk drops in.

The trunk runs through `t5.encode`, so `attention_type="pallas_rpe"` on the
card runs the attention and `rms_norm` kernels forward and backward; the
heads' own losses are plain PyTorch on the (rows, labels) logits, as the
JAX package's are plain XLA. Dropout (`deterministic=False`) draws from the
caller's `torch.Generator`, in the order the JAX package splits its keys;
its bits are not the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.ops.cross_entropy import cross_entropy_loss_ref

Params = Dict[str, Any]


def _mean_ce(logits: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = -100) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss semantics: the mean over non-ignored
    rows."""
    losses, _ = cross_entropy_loss_ref(logits, labels,
                                       ignore_index=ignore_index)
    n = torch.clamp(torch.sum(labels != ignore_index), min=1)
    return torch.sum(losses) / n


def _init_linear(gen: torch.Generator, d_in: int, d_out: int, std: float,
                 device) -> Params:
    return {"weight": torch.randn((d_in, d_out), generator=gen,
                                  dtype=torch.float32, device=device) * std,
            "bias": torch.zeros((d_out,), dtype=torch.float32, device=device)}


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["weight"].to(x.dtype)) + p["bias"].to(x.dtype)


def _head_init(config: FlashT5Config, seed: int, device):
    """The trunk from `seed` and a generator for the head (`seed` + 1)."""
    device = runtime.resolve_device(device)
    params = t5.init_encoder_params(config, seed=seed, device=device)
    return params, torch.Generator(device=device).manual_seed(seed + 1), device


# ---------------------------------------------------------------------------
# Token classification (reference: custom_heads_flash_t5.py:20-86)
# ---------------------------------------------------------------------------

def init_token_classification_params(config: FlashT5Config, num_labels: int,
                                     seed: int = 0, device=None) -> Params:
    params, gen, device = _head_init(config, seed, device)
    params["classifier"] = _init_linear(gen, config.d_model, num_labels,
                                        config.initializer_factor * 1.0,
                                        device)
    return params


def token_classification_forward(config: FlashT5Config, params: Params,
                                 input_ids, attention_mask=None, labels=None,
                                 *, classifier_dropout: float = 0.0,
                                 generator: Optional[torch.Generator] = None,
                                 deterministic: bool = True) -> Dict:
    h = t5.encode(config, params, input_ids, attention_mask,
                  generator=generator, deterministic=deterministic)
    h = t5._dropout(generator, classifier_dropout, h, deterministic)
    logits = _linear(params["classifier"], h)
    out = {"logits": logits}
    if labels is not None:
        out["loss"] = _mean_ce(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
    return out


# ---------------------------------------------------------------------------
# Sequence classification (reference: custom_heads_flash_t5.py:89-220)
# ---------------------------------------------------------------------------

def init_sequence_classification_params(config: FlashT5Config,
                                        num_labels: int, seed: int = 0,
                                        device=None) -> Params:
    params, gen, device = _head_init(config, seed, device)
    std = config.initializer_factor * config.d_model ** -0.5
    params["classification_head"] = {
        "dense": _init_linear(gen, config.d_model, config.d_model, std,
                              device),
        "out_proj": _init_linear(gen, config.d_model, num_labels, std,
                                 device),
    }
    return params


def _classification_head(p: Params, x: torch.Tensor, *, dropout: float,
                         generator, deterministic: bool) -> torch.Tensor:
    x = t5._dropout(generator, dropout, x, deterministic)
    x = torch.tanh(_linear(p["dense"], x))
    x = t5._dropout(generator, dropout, x, deterministic)
    return _linear(p["out_proj"], x)


def last_eos_positions(input_ids: torch.Tensor,
                       eos_token_id: int) -> torch.Tensor:
    """Each row's last EOS position; a row without one pools its last
    position (the JAX package's static-shape form of the reference's
    boolean indexing, reference :180-185)."""
    eos = input_ids == eos_token_id
    seq_len = input_ids.shape[1]
    rev_idx = seq_len - 1 - torch.argmax(eos.flip(1).int(), dim=1)
    return torch.where(eos.any(dim=1), rev_idx, seq_len - 1)


def infer_problem_type(num_labels: int, labels: torch.Tensor) -> str:
    """The reference's rule: one label is regression, integer labels are
    single-label classification, float labels multi-label."""
    if num_labels == 1:
        return "regression"
    if not labels.dtype.is_floating_point:
        return "single_label_classification"
    return "multi_label_classification"


def sequence_classification_forward(config: FlashT5Config, params: Params,
                                    input_ids, attention_mask=None,
                                    labels=None, *, problem_type=None,
                                    num_labels=None,
                                    classifier_dropout: float = 0.0,
                                    generator: Optional[torch.Generator] = None,
                                    deterministic: bool = True) -> Dict:
    """The classification head on each row's last EOS (`last_eos_positions`);
    the loss by `problem_type` (inferred as `infer_problem_type` does):
    MSE, CE, or BCE with logits."""
    h = t5.encode(config, params, input_ids, attention_mask,
                  generator=generator, deterministic=deterministic)
    last = last_eos_positions(input_ids, config.eos_token_id)
    pooled = h[torch.arange(h.shape[0], device=h.device), last]
    logits = _classification_head(params["classification_head"], pooled,
                                  dropout=classifier_dropout,
                                  generator=generator,
                                  deterministic=deterministic)
    out = {"logits": logits}
    if labels is None:
        return out

    nl = num_labels if num_labels is not None else logits.shape[-1]
    if problem_type is None:
        problem_type = infer_problem_type(nl, labels)
    if problem_type == "regression":
        out["loss"] = torch.mean((torch.squeeze(logits) - torch.squeeze(
            labels).to(logits.dtype)) ** 2)
    elif problem_type == "single_label_classification":
        out["loss"] = _mean_ce(logits.reshape(-1, nl), labels.reshape(-1))
    elif problem_type == "multi_label_classification":
        z = logits.float()
        y = labels.float()
        out["loss"] = torch.mean(torch.clamp(z, min=0) - z * y
                                 + torch.log1p(torch.exp(-torch.abs(z))))
    else:
        raise ValueError(f"unknown problem_type {problem_type!r}")
    return out


# ---------------------------------------------------------------------------
# Question answering (reference: custom_heads_flash_t5.py:223-314)
# ---------------------------------------------------------------------------

def init_question_answering_params(config: FlashT5Config, seed: int = 0,
                                   device=None) -> Params:
    params, gen, device = _head_init(config, seed, device)
    params["qa_outputs"] = _init_linear(gen, config.d_model, 2,
                                        config.initializer_factor * 1.0,
                                        device)
    return params


def question_answering_forward(config: FlashT5Config, params: Params,
                               input_ids, attention_mask=None,
                               start_positions=None, end_positions=None, *,
                               generator: Optional[torch.Generator] = None,
                               deterministic: bool = True) -> Dict:
    h = t5.encode(config, params, input_ids, attention_mask,
                  generator=generator, deterministic=deterministic)
    logits = _linear(params["qa_outputs"], h)          # (B, L, 2)
    start_logits, end_logits = logits[..., 0], logits[..., 1]
    out = {"start_logits": start_logits, "end_logits": end_logits}
    if start_positions is not None and end_positions is not None:
        # positions outside the sequence are ignored (reference :290-296):
        # clamped to seq_len, which becomes the ignore index, beside one
        # padded logit column that no row targets
        seq_len = start_logits.shape[1]
        sp = torch.clamp(start_positions.reshape(-1).long(), 0, seq_len)
        ep = torch.clamp(end_positions.reshape(-1).long(), 0, seq_len)
        pad = torch.full((start_logits.shape[0], 1), -1e9,
                         dtype=start_logits.dtype, device=h.device)
        sl = torch.cat([start_logits, pad], dim=1)
        el = torch.cat([end_logits, pad], dim=1)
        sp = torch.where(sp == seq_len, -100, sp)
        ep = torch.where(ep == seq_len, -100, ep)
        out["loss"] = 0.5 * (_mean_ce(sl, sp) + _mean_ce(el, ep))
    return out
