"""Flash attention without a positional bias (the decoder's cross-attention).

The counterpart of `flasht5_tpu/ops/flash_attention.py::flash_attention` for
`bias=None`: its forward (`_fwd_kernel_nj1_bfold`, `_fwd_kernel`) and
backward (`_bwd_fused_nj1_bfold_kernel`, `_bwd_fused_nj1_kernel`,
`_bwd_dkv_kernel`, `_bwd_dq_kernel`) run here on the same two Hopper kernels
as the RPE attention (`ops/flash_attention_rpe.py`), given no bucket table.
The materialized-bias form (`attention_type="pallas"`, and its `dbias`) is
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from flasht5_tpu_torch.ops.flash_attention_rpe import attention


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    causal: bool = False,
                    sm_scale: float = 1.0) -> torch.Tensor:
    """Flash attention, differentiable in q, k and v. q (B,H,M,D); k, v
    (B,H,N,D); causal masking is bottom-right aligned."""
    if bias is not None:
        raise NotImplementedError(
            "flash attention with a materialized bias (attention_type="
            "'pallas') is not ported yet")
    return attention(q, k, v, None, causal=causal, sm_scale=sm_scale)
