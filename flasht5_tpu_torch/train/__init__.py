"""Training: the single-GPU trainer loop with checkpoints, its callbacks,
and the pretraining driver (`train.cli`)."""

from flasht5_tpu_torch.train.callbacks import JSONLCallback, TrainerCallback
from flasht5_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                             masked_accuracy)

__all__ = ["JSONLCallback", "Trainer", "TrainerCallback", "TrainerConfig",
           "masked_accuracy"]
