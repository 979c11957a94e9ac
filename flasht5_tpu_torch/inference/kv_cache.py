"""Decoder KV caches: the per-layer cache record and the head projection.

Self-attention caches are (B, H, max_len, d_kv), written at each slot's
position every step; cross-attention caches are computed once from the
encoder output.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from flasht5_tpu_torch.models import t5


class LayerCache(NamedTuple):
    self_k: Any    # (B, H, max_len, d_kv)
    self_v: Any
    cross_k: Any   # (B, H, n_enc, d_kv)
    cross_v: Any


def _proj_heads(x: torch.Tensor, w, num_heads: int, d_kv: int
                ) -> torch.Tensor:
    """x (B, L, d_model) @ w -> (B, H, L, d_kv), quant-aware."""
    b, n = x.shape[:2]
    return t5._matmul(x, w).reshape(b, n, num_heads, d_kv).transpose(1, 2)
