"""T5 relative position bias (ALiBi, RoPE and FIRE are not ported yet).

`relative_position_bucket` is a float32 transcription of the Mesh-TF / T5
log-bucketing (reference positional_encoding.py:26-71). Its float32 value
lands exactly on an integer at some offsets (2.0, 4.0, 6.0 at |rel| = 16, 32,
64 for 16 buckets per direction), so a `log` one ulp low would move those
offsets into the bucket below. The port therefore evaluates it only on the
CPU, where it is pinned to the JAX package's function over every offset the
tests cover, and hands the GPU integer bucket tables (`bucket_lut`), never a
`log` to evaluate.
"""

from __future__ import annotations

import functools
import math
import torch


def relative_position_bucket(relative_position: torch.Tensor, *,
                             bidirectional: bool = True,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Map relative positions (k_pos - q_pos) to int32 bucket indices."""
    rel = relative_position.to(torch.int32)
    buckets = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        buckets += (rel > 0).to(torch.int32) * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_f = torch.clamp(rel.to(torch.float32), min=1.0)
    f32 = functools.partial(torch.tensor, dtype=torch.float32,
                            device=rel.device)
    large = (torch.log(rel_f / f32(max_exact))
             / f32(math.log(max_distance / max_exact))
             * f32(num_buckets - max_exact)).to(torch.int32) + max_exact
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(is_small, rel, large)


@functools.lru_cache(maxsize=64)
def bucket_lut(lo: int, hi: int, *, bidirectional: bool, num_buckets: int,
               max_distance: int, device) -> torch.Tensor:
    """(hi - lo + 1,) int32 buckets of the offsets lo..hi, computed on the
    CPU and kept on `device` (entry i is the bucket of offset lo + i)."""
    rel = torch.arange(lo, hi + 1, dtype=torch.int32)
    return relative_position_bucket(
        rel, bidirectional=bidirectional, num_buckets=num_buckets,
        max_distance=max_distance).to(device)


def init_relative_bias_params(generator: torch.Generator, num_buckets: int,
                              num_heads: int, initializer_factor: float = 1.0,
                              d_model: int = 512, dtype=torch.float32,
                              device=None) -> dict:
    """T5 init: normal(0, factor * d_model**-0.5) (reference
    modeling_flash_t5.py:489-490)."""
    std = initializer_factor * (d_model ** -0.5)
    w = torch.randn((num_buckets, num_heads), generator=generator,
                    dtype=torch.float32, device=device) * std
    return {"relative_attention_bias": w.to(dtype)}


def t5_relative_bias(params: dict, q_len: int, k_len: int, *,
                     bidirectional: bool = True, num_buckets: int = 32,
                     max_distance: int = 128,
                     dtype=torch.float32) -> torch.Tensor:
    """The (1, H, q_len, k_len) T5 bias gathered from the bucket table."""
    table = params["relative_attention_bias"]
    lut = bucket_lut(-(q_len - 1), k_len - 1, bidirectional=bidirectional,
                     num_buckets=num_buckets, max_distance=max_distance,
                     device=table.device)
    rel = (torch.arange(k_len, device=table.device)[None, :]
           - torch.arange(q_len, device=table.device)[:, None])
    values = table[lut[rel + (q_len - 1)].long()]    # (M, N, H)
    return values.permute(2, 0, 1)[None].to(dtype)
