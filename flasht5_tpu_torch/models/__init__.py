"""Model layer: the T5 v1.1 encoder-decoder (parameters, blocks, encode,
forward with the loss) and the task heads over its encoder."""

from flasht5_tpu_torch.models import heads, t5

__all__ = ["heads", "t5"]
