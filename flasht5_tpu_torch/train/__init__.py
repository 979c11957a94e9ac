"""Training driver: the single-GPU trainer loop and its metrics."""

from flasht5_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                             masked_accuracy)

__all__ = ["Trainer", "TrainerConfig", "masked_accuracy"]
