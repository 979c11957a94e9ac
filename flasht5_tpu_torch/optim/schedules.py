"""LR schedules on Python floats: warmup (linear 0.5 -> 1) + cosine, and
warmup-stable-decay.

A copy of `flasht5_tpu/optim/schedules.py` without `jax.numpy`: warmup is a
linear ramp from half the base LR (torch LinearLR(start_factor=0.5)), cosine
anneals to eta_min=1e-5, and WSD holds the base LR then ramps back down to
half over the final `warmup_steps` (reference optimization.py:38-104).
"""

from __future__ import annotations

import math


def _resolve_warmup(warmup_steps, warmup_ratio, num_training_steps):
    return (warmup_steps if warmup_steps != 0
            else int(num_training_steps * warmup_ratio))


def cosine_schedule(base_lr: float, num_training_steps: int,
                    warmup_steps: int = 0, warmup_ratio: float = 0.0,
                    eta_min: float = 1e-5):
    """Linear 0.5->1 warmup then cosine to eta_min (reference :38-69)."""
    warmup = _resolve_warmup(warmup_steps, warmup_ratio, num_training_steps)

    def schedule(step) -> float:
        step = float(step)
        w = float(max(warmup, 1))
        warm = base_lr * (0.5 + 0.5 * min(step, w) / w)
        t = min(max(step - warmup, 0.0), num_training_steps - warmup)
        tmax = max(num_training_steps - warmup, 1)
        cos = eta_min + (base_lr - eta_min) * 0.5 * (
            1 + math.cos(math.pi * t / tmax))
        return (warm if step < warmup else cos) if warmup > 0 else cos

    return schedule


def wsd_schedule(base_lr: float, num_training_steps: int,
                 warmup_steps: int = 0, warmup_ratio: float = 0.0):
    """Warmup-stable-decay (reference :71-104): linear 0.5->1 over warmup,
    constant, then linear 1->0.5 over the last `warmup` steps."""
    warmup = _resolve_warmup(warmup_steps, warmup_ratio, num_training_steps)

    def schedule(step) -> float:
        step = float(step)
        w = float(max(warmup, 1))
        warm = base_lr * (0.5 + 0.5 * min(step, w) / w)
        decay_start = num_training_steps - warmup
        d = min(max(step - decay_start, 0.0), warmup)
        decay = base_lr * (1.0 - 0.5 * d / w)
        if step < warmup:
            return warm
        return base_lr if step < decay_start else decay

    return schedule
