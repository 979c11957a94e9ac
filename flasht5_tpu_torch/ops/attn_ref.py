"""Plain PyTorch attention reference (the JAX package's `attn_ref`, with its
attention dropout). Layout (B, H, M, D) x (B, H, N, D)."""

from __future__ import annotations

from typing import Optional

import torch


def attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             bias: Optional[torch.Tensor] = None, *, sm_scale: float = 1.0,
             causal: bool = False, dropout_p: float = 0.0,
             generator: Optional[torch.Generator] = None,
             upcast: bool = True) -> torch.Tensor:
    """Scaled dot-product attention with an additive bias broadcastable to
    (B, H, M, N); returns (B, H, M, D) in q.dtype. Causal masking is
    bottom-right aligned, and a row with no visible key outputs 0. With
    `dropout_p` > 0 each entry of P is kept with probability 1 - dropout_p
    (the keep-mask drawn from `generator`) and scaled by 1 / (1 - p)."""
    out_dtype = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
        if bias is not None:
            bias = bias.float()
    scores = torch.einsum("bhmd,bhnd->bhmn", q, k) * sm_scale
    if bias is not None:
        scores = scores + bias
    fully_masked = None
    if causal:
        m, n = scores.shape[-2], scores.shape[-1]
        row = torch.arange(m, device=q.device)[:, None]
        col = torch.arange(n, device=q.device)[None, :]
        mask = col <= row + (n - m)
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
        fully_masked = ~mask.any(dim=-1)
    p = torch.softmax(scores, dim=-1)
    if fully_masked is not None:
        p = torch.where(fully_masked[None, None, :, None], 0.0, p)
    if dropout_p > 0.0:
        if generator is None:
            raise ValueError("dropout_p > 0 draws from a torch.Generator: "
                             "pass `generator`")
        keep = torch.rand(p.shape, generator=generator,
                          device=p.device) < 1.0 - dropout_p
        p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhmn,bhnd->bhmd", p, v)
    return out.to(out_dtype)
