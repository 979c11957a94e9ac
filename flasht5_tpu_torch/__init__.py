"""flasht5_tpu_torch: the PyTorch / CUDA port of flasht5_tpu for Hopper GPUs.

The JAX package `flasht5_tpu` is the reference; this package mirrors its
layout (config, runtime, positional, quantize, ops, models, optim, train,
inference, convert) and replaces each Pallas kernel on the ported paths with
a kernel written by hand for an NVIDIA H100 (`csrc/*.cu` in CUDA C++, or
Triton).
It imports PyTorch and never JAX. Entry points run on the GPU unless the
caller asks for the CPU, where every kernel runs its plain PyTorch version.
"""

from flasht5_tpu_torch.config import FlashT5Config, flagship_config

__all__ = ["FlashT5Config", "flagship_config"]
