"""Token sampling for decode loops: temperature / top-k / top-p (nucleus).

The counterpart of `flasht5_tpu/inference/sampling.py`. The filters mask
with -1e30 as there; the draw is `jax.random.categorical`'s: the argmax of
the filtered logits plus Gumbel noise, here drawn from an explicit
`torch.Generator` (`gumbel`). `draw` takes the noise as an argument, so the
same noise (JAX's own `jax.random.gumbel(key, shape)`) gives the same token
as JAX's draw.
"""

from __future__ import annotations

from typing import Optional

import torch

_MASKED = -1e30


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row, mask the rest. logits (..., V)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _MASKED, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the probability-sorted
    vocabulary whose cumulative mass reaches p (the top token always kept)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep positions whose PRECEDING mass is < p (so the boundary token stays)
    keep_sorted = (cum - probs) < p
    n_keep = torch.clamp(keep_sorted.sum(dim=-1, keepdim=True), min=1)
    threshold = torch.gather(sorted_logits, -1, n_keep - 1)
    return torch.where(logits < threshold, _MASKED, logits)


def gumbel(shape, generator: Optional[torch.Generator],
           device=None) -> torch.Tensor:
    """Standard Gumbel noise in f32, -log(-log(u)) with u uniform in
    [tiny, 1), as `jax.random.gumbel` draws it, from `generator`."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return -torch.log(-torch.log(u * (1.0 - tiny) + tiny))


def draw(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The categorical draw over the last axis given its Gumbel noise:
    argmax(noise + logits), as `jax.random.categorical` computes it."""
    return torch.argmax(noise + logits, dim=-1)


def sample_token(logits: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """Draw one token id per row of `logits` (..., V) -> (...) int64, the
    noise from `generator`.

    temperature <= 0 means greedy (argmax); top_k=0 and top_p=1 disable the
    respective filters."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits.float() / temperature
    scaled = apply_top_k(scaled, top_k)
    scaled = apply_top_p(scaled, top_p)
    return draw(scaled, gumbel(scaled.shape, generator, scaled.device))
