"""Training: the single-GPU trainer loop with checkpoints, its callbacks
and trackers, the pretraining driver (`train.cli`) and classification
fine-tuning (`train.finetune_classification`)."""

from flasht5_tpu_torch.train.callbacks import (ClearMLCallback,
                                               EnergyCallback, JSONLCallback,
                                               TrainerCallback, WandbCallback)
from flasht5_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                             masked_accuracy)

__all__ = ["ClearMLCallback", "EnergyCallback", "JSONLCallback", "Trainer",
           "TrainerCallback", "TrainerConfig", "WandbCallback",
           "masked_accuracy"]
