"""Positional encodings: T5 relative bias, ALiBi, RoPE and FIRE.

The counterpart of `flasht5_tpu/positional.py`, the same functions with the
same float32 arithmetic, over explicit parameter dicts; a `torch.Generator`
takes the place of each rng. Every bias-producing family returns a
`(1, num_heads, q_len, k_len)` additive bias; RoPE rotates q and k (and v)
and returns no bias.

The T5 bias is a gather from the (num_buckets, H) bucket table
(`_BucketGather`); its backward sums the bias's gradient by bucket through
`ops.t5_bias_grad` (the kernel `csrc/t5_bias_grad.cu` on the card,
`index_put_` on the CPU), which opens a `t5_bias.grad` span.

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
from typing import Optional, Tuple

import numpy as np
import torch

from flasht5_tpu_torch.ops.t5_bias_grad import t5_bias_grad


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


def _randomized_positions(generator: torch.Generator, length: int,
                          max_length: int) -> torch.Tensor:
    """Sorted random subsample of [0, max_length), the first element pinned
    to 0, on the generator's device (the length-generalization trick,
    reference positional_encoding.py:78-87)."""
    perm = torch.randperm(max_length, generator=generator,
                          device=generator.device)[:length]
    pos = torch.sort(perm).values
    pos[0] = 0
    return pos


def bucket_map(q_len: int, k_len: int, *, bidirectional: bool = True,
               num_buckets: int = 32, max_distance: int = 128,
               q_positions: Optional[torch.Tensor] = None,
               k_positions: Optional[torch.Tensor] = None,
               max_len: Optional[int] = None, device=None) -> torch.Tensor:
    """The (q_len, k_len) int32 bucket of every (query, key) on `device`.
    Explicit positions must lie in [0, max_len); their bucket table covers
    the offsets -(max_len - 1)..max_len - 1, the same table for every
    draw."""
    if q_positions is None and k_positions is None:
        lo, hi = -(q_len - 1), k_len - 1
        rel = (torch.arange(k_len, device=device)[None, :]
               - torch.arange(q_len, device=device)[:, None])
    else:
        if max_len is None:
            raise ValueError("explicit positions need max_len, the bound "
                             "they lie under")
        if q_positions is None:
            q_positions = torch.arange(q_len, device=device)
        if k_positions is None:
            k_positions = torch.arange(k_len, device=device)
        rel = (k_positions.to(device).long()[None, :]
               - q_positions.to(device).long()[:, None])
        lo, hi = -(max_len - 1), max_len - 1
    lut = bucket_lut(lo, hi, bidirectional=bidirectional,
                     num_buckets=num_buckets, max_distance=max_distance,
                     device=device)
    return lut[rel - lo]


def t5_relative_bias(params: dict, q_len: int, k_len: int, *,
                     bidirectional: bool = True, num_buckets: int = 32,
                     max_distance: int = 128, dtype=torch.float32,
                     q_positions: Optional[torch.Tensor] = None,
                     k_positions: Optional[torch.Tensor] = None,
                     max_len: Optional[int] = None) -> torch.Tensor:
    """The (1, H, q_len, k_len) T5 bias gathered from the bucket table,
    contiguous. `q_positions`/`k_positions` replace the default aranges
    (randomized positions, decoding rows) under `max_len` (`bucket_map`)."""
    table = params["relative_attention_bias"]
    buckets = bucket_map(
        q_len, k_len, bidirectional=bidirectional, num_buckets=num_buckets,
        max_distance=max_distance, q_positions=q_positions,
        k_positions=k_positions, max_len=max_len, device=table.device)
    return _BucketGather.apply(table, buckets).to(dtype)


class _BucketGather(torch.autograd.Function):
    """table[buckets] as the contiguous (1, H, M, N) bias; its backward is
    `t5_bias_grad`, in the table's dtype."""

    @staticmethod
    def forward(ctx, table, buckets):
        ctx.save_for_backward(buckets)
        ctx.num_buckets, ctx.dtype = table.shape[0], table.dtype
        flat = torch.index_select(table.t(), 1, buckets.reshape(-1).long())
        return flat.view(1, table.shape[1], *buckets.shape)

    @staticmethod
    def backward(ctx, grad):
        buckets, = ctx.saved_tensors
        dw = t5_bias_grad(grad, buckets, ctx.num_buckets)
        return dw.to(ctx.dtype), None


# ---------------------------------------------------------------------------
# ALiBi
# ---------------------------------------------------------------------------

def alibi_slopes(num_heads: int) -> np.ndarray:
    """Per-head geometric slopes; head counts that are not a power of two
    take the ALiBi paper's interleaved workaround (reference
    positional_encoding.py:131-142)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        return np.asarray(pow2_slopes(num_heads), dtype=np.float32)
    closest = 2 ** math.floor(math.log2(num_heads))
    extra = pow2_slopes(2 * closest)[0::2][: num_heads - closest]
    return np.asarray(pow2_slopes(closest) + extra, dtype=np.float32)


def alibi_bias(num_heads: int, q_len: int, k_len: int, *,
               mode: str = "symetric", dtype=torch.float32,
               q_positions: Optional[torch.Tensor] = None,
               k_positions: Optional[torch.Tensor] = None,
               device=None) -> torch.Tensor:
    """ALiBi additive bias (1, H, q_len, k_len) on `device` (that of the
    positions, if given).

    symetric: -slope * |k - q| for every head. asymetric: the first half of
    the heads sees only the past (the future at -inf), the second half only
    the future (reference positional_encoding.py:144-173)."""
    if q_positions is not None:
        device = q_positions.device
    elif k_positions is not None:
        device = k_positions.device
    if q_positions is None:
        q_positions = torch.arange(q_len, device=device)
    if k_positions is None:
        k_positions = torch.arange(k_len, device=device)
    rel = (k_positions.to(device)[None, :].float()
           - q_positions.to(device)[:, None].float())
    dist = rel.abs()
    if mode == "symetric":
        slopes = torch.from_numpy(alibi_slopes(num_heads)).to(device)
        return (-slopes[:, None, None] * dist[None])[None].to(dtype)
    if mode == "asymetric":
        half = num_heads // 2
        slopes = torch.from_numpy(alibi_slopes(half)).to(device)
        base = -slopes[:, None, None] * dist[None]          # (half, M, N)
        mask_right = torch.where(rel > 0, -torch.inf, 0.0)  # no future
        mask_left = torch.where(rel < 0, -torch.inf, 0.0)   # no past
        bias = torch.cat([base + mask_right[None], base + mask_left[None]])
        return bias[None].to(dtype)
    raise ValueError(f"ALiBi mode {mode!r} is not implemented")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(seq_len: int, rotary_dim: int, *, base: float = 10000.0,
                 scale_base: Optional[float] = None, dtype=torch.float32,
                 offset: int = 0, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor], Optional[torch.Tensor]]:
    """f32 cos/sin tables (seq_len, rotary_dim // 2). With xPos's
    `scale_base`, separately scaled (cos, sin) for q and (cos_k, sin_k) for
    k (reference positional_encoding.py:264-279), centred at seq_len // 2;
    otherwise the k tables are None and the q tables serve both."""
    even = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device)
    inv_freq = 1.0 / (base ** (even / rotary_dim))
    t = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                     device=device)
    freqs = torch.outer(t, inv_freq)
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    if scale_base is None:
        return cos.to(dtype), sin.to(dtype), None, None
    scale_vec = (even + 0.4 * rotary_dim) / (1.4 * rotary_dim)
    power = (t - seq_len // 2) / scale_base
    scale = scale_vec[None, :] ** power[:, None]
    return ((cos * scale).to(dtype), (sin * scale).to(dtype),
            (cos / scale).to(dtype), (sin / scale).to(dtype))


def gather_rope_tables(tables, positions: torch.Tensor):
    """The (cos, sin, cos_k, sin_k) tables' rows at integer `positions`
    (randomized-position training; the query's own rows in decoding)."""
    return tuple(None if t is None else t[positions.to(t.device).long()]
                 for t in tables)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
                 interleaved: bool = False) -> torch.Tensor:
    """Rotate the leading 2 * cos.shape[-1] features of x (..., seq, heads,
    head_dim) by cos/sin (seq, rotary_dim // 2): split halves, or even/odd
    pairs when `interleaved`; the other features pass through. Computed in
    f32 (x promoted by the f32 tables) and returned in x.dtype."""
    half = cos.shape[-1]
    rot_dim = 2 * half
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    cos = cos[:, None, :]           # (seq, 1, half), broadcast over heads
    sin = sin[:, None, :]
    if interleaved:
        x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(x_rot.shape)
    else:
        x1, x2 = x_rot[..., :half], x_rot[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if x_pass.numel():
        out = torch.cat([out, x_pass.to(out.dtype)], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# FIRE
# ---------------------------------------------------------------------------

def init_fire_params(generator: torch.Generator, num_heads: int,
                     mlp_width: int = 32, init_c: float = 0.1,
                     init_L: float = 128.0, dtype=torch.float32,
                     device=None) -> dict:
    """FIRE's MLP, torch.nn.Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    weights and zero biases, and its 0-d scalars c, L_multiplier and init_L
    (reference positional_encoding.py:358-372). No mask freezes init_L: it
    trains, as in the JAX package."""

    def uniform(shape, lim):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        return (u * (2 * lim) - lim).to(dtype)

    def scalar(value):
        return torch.tensor(value, dtype=dtype, device=device)

    return {
        "mlp": {
            "w1": uniform((1, mlp_width), 1.0),
            "b1": torch.zeros((mlp_width,), dtype=dtype, device=device),
            "w2": uniform((mlp_width, num_heads), 1.0 / math.sqrt(mlp_width)),
            "b2": torch.zeros((num_heads,), dtype=dtype, device=device),
        },
        "c": scalar(init_c),
        "L_multiplier": scalar(1.0),
        "init_L": scalar(init_L),
    }


def fire_bias(params: dict, seq_len: int, *, eps: float = 1e-6,
              dtype=torch.float32,
              q_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FIRE's functional bias (1, H, seq_len, seq_len): the MLP of the
    log-transformed relative distance, normalized by the query's position
    (reference positional_encoding.py:375-411). `q_positions` keeps only
    those rows (1, H, len(q_positions), seq_len), with the same values."""
    mlp = params["mlp"]
    dev = mlp["w1"].device
    positions = torch.arange(seq_len, dtype=torch.float32, device=dev)
    rows = positions if q_positions is None else \
        q_positions.to(dev).float()
    rel = rows[:, None] - positions[None, :]
    c = params["c"].float()
    threshold = torch.abs(params["L_multiplier"].float()
                          * params["init_L"].float())
    pos_norm = torch.maximum(rows, threshold)[:, None]
    rel_t = torch.sign(rel) * torch.log(torch.abs(c * rel) + 1.0)
    norm_t = torch.log(torch.abs(c * pos_norm) + 1.0) + eps
    x = (rel_t / norm_t)[..., None]                        # (M, N, 1)
    h = torch.relu(x @ mlp["w1"].float() + mlp["b1"].float())
    out = h @ mlp["w2"].float() + mlp["b2"].float()        # (M, N, H)
    return out.permute(2, 0, 1)[None].to(dtype)
