"""Model layer: the T5 v1.1 encoder-decoder (parameters, blocks, encode,
forward with the loss)."""

from flasht5_tpu_torch.models import t5

__all__ = ["t5"]
