"""Host-side data pipeline: UL2 span-corruption collation with packing (a
copy of the JAX package's, in numpy)."""

from flasht5_tpu_torch.data.ul2_collator import (
    DataCollatorForUL2,
    Denoiser,
    compute_input_and_target_lengths,
    random_spans_noise_mask,
)

__all__ = [
    "DataCollatorForUL2",
    "Denoiser",
    "compute_input_and_target_lengths",
    "random_spans_noise_mask",
]
