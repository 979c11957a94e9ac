"""Optimization: the RMS-scaled AdamW and the LR schedules."""

from flasht5_tpu_torch.optim.adamw_scaled import AdamWScale, no_decay_mask
from flasht5_tpu_torch.optim.schedules import cosine_schedule, wsd_schedule

__all__ = ["AdamWScale", "no_decay_mask", "cosine_schedule", "wsd_schedule"]
