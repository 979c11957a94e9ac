"""Compute ops: plain PyTorch versions and the hand-written Hopper kernels.

Each kernel wrapper launches its kernel for CUDA tensors, runs its plain
version for CPU tensors, and counts its launches in a `.launches` integer.

- rmsnorm:             RMS norm forward and backward -> csrc/rmsnorm.cu
- flash_attention_rpe: attention with the T5 bias from the bucket table, or
                       none, forward and backward (CUDA)
- flash_attention:     attention with an additive bias tensor (the
                       materialized T5 bias), forward, dK/dV + dbias and dQ
                       (CUDA); without a bias, the RPE kernels given no table
- cross_entropy:       cross-entropy with z-loss, forward (the loss in its
                       epilogue) and backward, and the vocab-split form's
                       combine over shards (Triton)
- fused_linear_ce:     the lm_head matmul fused with cross-entropy, forward
                       (split vocab + merge) and backward (dx, dW) (CUDA)
- quant:               INT8/FP8 weight-only dequant matmul (CUDA)
- decode_attention:    single-query attention over int8/bf16/f32 caches (CUDA)
- paged_attention:     single-query attention over paged int8/bf16/f32 pools
                       (CUDA)
- t5_bias_grad:        the T5 bucket table's gradient through the
                       materialized bias (CUDA)
- attn_ref:            plain attention oracle
"""

from flasht5_tpu_torch.ops import (cross_entropy, decode_attention,
                                   flash_attention, flash_attention_rpe,
                                   fused_linear_ce, paged_attention, quant,
                                   rmsnorm, t5_bias_grad)

# name -> the wrapper that launches (and counts) the kernel
KERNELS = {
    "rms_norm": rmsnorm.rms_norm_fwd,
    "rms_norm_bwd": rmsnorm.rms_norm_bwd,
    "flash_attention_rpe": flash_attention_rpe.flash_attention_rpe_fwd,
    "flash_attention_bwd": flash_attention_rpe.flash_attention_bwd,
    "flash_attention_bias": flash_attention.flash_attention_bias_fwd,
    "flash_attention_bias_dkv": flash_attention.flash_attention_bias_dkv,
    "flash_attention_bias_dq": flash_attention.flash_attention_bias_dq,
    "cross_entropy_fwd": cross_entropy.cross_entropy_fwd,
    "cross_entropy_bwd": cross_entropy.cross_entropy_bwd,
    "cross_entropy_combine": cross_entropy.cross_entropy_combine,
    "fused_linear_ce_fwd": fused_linear_ce.fused_linear_ce_fwd,
    "fused_linear_ce_bwd": fused_linear_ce.fused_linear_ce_bwd,
    "quant_matmul": quant.quant_matmul,
    "decode_attention": decode_attention.decode_attention,
    "paged_decode_attention": paged_attention.paged_attention,
    "t5_bias_grad": t5_bias_grad.t5_bias_grad,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]
