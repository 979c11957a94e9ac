"""AdamWScale (flashT5's `adamw_scaled.py`) and its learning-rate
schedules, on plain float32 tensors, one leaf at a time.

AdamW with the bias correction folded into the step size, lr * sqrt(1 -
b2^t) / (1 - b1^t), and each leaf's step scaled by max(1e-3, rms(leaf));
decoupled weight decay after the update, on leaves whose names hold none of
bias / layer_norm / layernorm / LayerNorm / ln. The cosine schedule warms
up linearly from half the rate and anneals to 1e-5 (flashT5's
`optimization.py`).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

_NO_DECAY = ("bias", "layer_norm", "layernorm", "LayerNorm", "ln")


def cosine_lr(step: int, base: float, total: int, warmup: int,
              eta_min: float = 1e-5) -> float:
    if warmup > 0 and step < warmup:
        return base * (0.5 + 0.5 * step / warmup)
    t = min(max(step - warmup, 0), total - warmup)
    return eta_min + (base - eta_min) * 0.5 * (
        1 + math.cos(math.pi * t / max(total - warmup, 1)))


class AdamWScaleRef:
    def __init__(self, names: List[str], lr_fn, betas=(0.9, 0.999),
                 eps=1e-6, weight_decay=0.0):
        self.names = names
        self.lr_fn = lr_fn
        self.b1, self.b2 = betas
        self.eps = eps
        self.wd = weight_decay
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        lr = self.lr_fn(self.t)
        step_size = lr * math.sqrt(1 - self.b2 ** self.t) / (
            1 - self.b1 ** self.t)
        for name in self.names:
            p, g = params[name], grads[name].float()
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = m / (v.sqrt() + self.eps)
            rms = float(p.float().norm()) / math.sqrt(p.numel())
            p.sub_(upd * (max(1e-3, rms) * step_size))
            if self.wd and not any(s in name for s in _NO_DECAY):
                p.mul_(1 - lr * self.wd)
