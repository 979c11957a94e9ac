"""Decoder KV caches for incremental decoding: the per-layer cache record,
the head projection, the decode state and the decode steps.

The counterpart of `flasht5_tpu/inference/kv_cache.py`. Self-attention
caches are (B, H, max_len, d_kv) in the activations' dtype, written at the
step's positions in place (where the JAX package returns an updated array);
cross-attention caches are computed once from the encoder output. The step
counter `t` is a host integer, so a step reads nothing back from the card.

Attention inside a step is routed by the window's width Q:
- Q = 1 (`decode_step`, generation's every step): the single-query kernel
  `ops.decode_attention.decode_attention` for the self-attention (lengths
  t + 1, the bias row of position t) and the cross-attention (every
  encoder position, no bias);
- Q > 1 (speculative verify windows): plain PyTorch, f32 scores and a
  softmax, causal within the window, as the JAX package computes it
  (`_single_query_attention`, outside any Pallas kernel); the single-query
  kernel takes one query a row.

Positional encodings as in the JAX package: the T5, ALiBi and FIRE bias
rows of positions t..t+Q-1 against every cache position are built at layer
0 and reused in every layer (FIRE computes only those rows; JAX slices them
from the full square, the same values). ALiBi's asymmetric -inf entries
are clamped at -1e29, as the bias kernels' wrapper clamps them: a warp's
share of the single-query kernel whose positions all lie in the masked
half would otherwise take exp(-inf - (-inf)); the query's own position is
always finite, so the softmax is unchanged. RoPE rotates the cross K (and
V) by encoder position once, and q and the new K/V rows at positions
t..t+Q-1 and the cross q at t..t+Q-1 each step.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from flasht5_tpu_torch import positional, runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.ops.decode_attention import decode_attention

_NEG_INF = -1e30


class LayerCache(NamedTuple):
    self_k: Any    # (B, H, max_len, d_kv)
    self_v: Any
    cross_k: Any   # (B, H, n_enc, d_kv)
    cross_v: Any


class DecodeState(NamedTuple):
    layers: Tuple[LayerCache, ...]
    encoder_mask: Optional[torch.Tensor]
    t: int                          # the next position to decode


def _proj_heads(x: torch.Tensor, w, num_heads: int, d_kv: int
                ) -> torch.Tensor:
    """x (B, L, d_model) @ w -> (B, H, L, d_kv), quant-aware."""
    b, n = x.shape[:2]
    return t5._matmul(x, w).reshape(b, n, num_heads, d_kv).transpose(1, 2)


def _rotated(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             config: FlashT5Config) -> torch.Tensor:
    """x (B, H, L, D) rotated by the tables' L rows."""
    return positional.apply_rotary(
        x.transpose(1, 2), cos, sin,
        interleaved=config.rotary_interleaved).transpose(1, 2)


def init_decode_state(config: FlashT5Config, params,
                      encoder_hidden_states: torch.Tensor,
                      max_decode_len: int,
                      encoder_mask: Optional[torch.Tensor] = None
                      ) -> DecodeState:
    """Allocate self caches and precompute cross K/V from the encoder
    output (rotated by encoder position under RoPE)."""
    t5.check_supported(config)
    b, n_enc = encoder_hidden_states.shape[:2]
    dkv = config.d_kv
    dt = encoder_hidden_states.dtype
    dev = encoder_hidden_states.device
    rope = config.position_encoding_type == "RoPE"
    if rope:
        _, _, ck, sk = (t[:n_enc] for t in t5.rope_tables_for(
            config, n_enc, dev))
    layers = []
    for blk in params["decoder"]["block"]:
        ca = blk["cross_attention_layer"]["cross_attention"]
        h = ca["Wk"].shape[1] // dkv
        cross_k = _proj_heads(encoder_hidden_states, ca["Wk"], h, dkv)
        cross_v = _proj_heads(encoder_hidden_states, ca["Wv"], h, dkv)
        if rope:
            cross_k = _rotated(cross_k, ck, sk, config)
            if config.rope_rotate_v:
                cross_v = _rotated(cross_v, ck, sk, config)
        layers.append(LayerCache(
            self_k=torch.zeros((b, h, max_decode_len, dkv), dtype=dt,
                               device=dev),
            self_v=torch.zeros((b, h, max_decode_len, dkv), dtype=dt,
                               device=dev),
            cross_k=cross_k.contiguous(), cross_v=cross_v.contiguous()))
    return DecodeState(tuple(layers), encoder_mask, 0)


def _write(cache: torch.Tensor, new: torch.Tensor, t: int) -> None:
    """new (B, H, Q, D) into positions t..t+Q-1 of a self cache, in place."""
    cache[:, :, t:t + new.shape[2]] = new


def _window_attention(q, k, v, bias, scale, valid):
    """q (B, H, Q, D); k, v (B, H, N, D); bias (1, H, Q, N) or None; valid
    (Q, N) bool or None: f32 scores, softmax, cast to q.dtype (the JAX
    package's `_single_query_attention`)."""
    s = torch.einsum("bhqd,bhnd->bhqn", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if valid is not None:
        s = torch.where(valid[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqn,bhnd->bhqd", p, v.float()).to(q.dtype)


_BIAS_MIN = -1e29      # ops/flash_attention.py's clamp of a bias


def _self_bias(config: FlashT5Config, sa, t: int, q_len: int, max_len: int,
               dev) -> torch.Tensor:
    """The decoder's bias rows of positions t..t+q_len-1 against every
    cache position, (1, H, q_len, max_len) f32 on `dev`, clamped at -1e29
    (ALiBi's -inf): the model's own T5 (unidirectional), ALiBi or FIRE bias
    (`sa` is layer 0's self-attention)."""
    return t5._position_bias(
        config, sa.get("pe_encoding"), q_len, max_len, bidirectional=False,
        device=dev, q_positions=torch.arange(t, t + q_len, device=dev)
    ).clamp_min(_BIAS_MIN)


def decode_step(config: FlashT5Config, params, state: DecodeState,
                token: torch.Tensor):
    """One incremental decode step. token: (B,) current decoder input.
    Returns (logits (B, V), the state with t advanced by 1)."""
    logits, new_state = decode_window_step(config, params, state,
                                           token[:, None])
    return logits[:, 0], new_state


def decode_window_step(config: FlashT5Config, params, state: DecodeState,
                       tokens: torch.Tensor):
    """Incremental decode over a window of Q tokens at positions t..t+Q-1.

    tokens: (B, Q) decoder inputs. Returns (logits (B, Q, V), the state with
    t advanced by Q); the self caches are written in place. Queries attend
    the committed cache plus the window's own earlier tokens (causal within
    the window); the self-bias rows are built at layer 0 and reused in
    every layer (none under RoPE, which rotates instead); the
    cross-attention has no mask (the training path's encoder mask acts
    only through `use_masking`, which needs a bias)."""
    b, q_len = tokens.shape
    dkv = config.d_kv
    t = state.t
    max_len = state.layers[0].self_k.shape[2]
    if t + q_len > max_len:
        raise ValueError(f"decode window at positions {t}..{t + q_len - 1} "
                         f"past the cache's {max_len}")
    emb = params["shared"]["embedding"]
    dev = emb.device
    x = emb[tokens.long()].to(runtime.torch_dtype(config.dtype))
    scale = config.softmax_scale
    single = q_len == 1
    if single:
        self_len = torch.full((b,), t + 1, dtype=torch.int32, device=dev)
        cross_len = torch.full((b,), state.layers[0].cross_k.shape[2],
                               dtype=torch.int32, device=dev)
        valid = None
    else:
        valid = (torch.arange(max_len, device=dev)[None, :]
                 <= torch.arange(t, t + q_len, device=dev)[:, None])
    self_bias = None
    rope = config.position_encoding_type == "RoPE"
    if rope:
        cos_t, sin_t, ck_t, sk_t = (
            tab[t:t + q_len] for tab in t5.rope_tables_for(config, max_len,
                                                           dev))
    for li, blk in enumerate(params["decoder"]["block"]):
        cache = state.layers[li]

        # ---- self attention ----
        sa = blk["self_attention_layer"]["self_attention"]
        h = sa["Wq"].shape[1] // dkv
        normed = t5._layer_norm(
            config, blk["self_attention_layer"]["layer_norm"]["weight"], x)
        q = _proj_heads(normed, sa["Wq"], h, dkv)
        k_new = _proj_heads(normed, sa["Wk"], h, dkv)
        v_new = _proj_heads(normed, sa["Wv"], h, dkv)
        if rope:
            q = _rotated(q, cos_t, sin_t, config)
            k_new = _rotated(k_new, ck_t, sk_t, config)
            if config.rope_rotate_v:
                v_new = _rotated(v_new, ck_t, sk_t, config)
        _write(cache.self_k, k_new, t)
        _write(cache.self_v, v_new, t)
        if li == 0 and not rope:
            self_bias = _self_bias(config, sa, t, q_len, max_len, dev)
            if single:
                # the kernel's (B, H, L) rows, made once for every layer
                self_bias = self_bias[:, :, 0].expand(b, h,
                                                      max_len).contiguous()
        if single:
            attn = decode_attention(q[:, :, 0], cache.self_k, cache.self_v,
                                    lengths=self_len, bias=self_bias,
                                    sm_scale=scale)[:, :, None]
        else:
            attn = _window_attention(q, cache.self_k, cache.self_v,
                                     self_bias, scale, valid)
        attn = attn.transpose(1, 2).reshape(b, q_len, h * dkv)
        x = x + t5._matmul(attn, sa["o"])

        # ---- cross attention ----
        ca = blk["cross_attention_layer"]["cross_attention"]
        normed = t5._layer_norm(
            config, blk["cross_attention_layer"]["layer_norm"]["weight"], x)
        qc = _proj_heads(normed, ca["Wq"], h, dkv)
        if rope:
            qc = _rotated(qc, cos_t, sin_t, config)
        if single:
            attn = decode_attention(qc[:, :, 0], cache.cross_k,
                                    cache.cross_v, lengths=cross_len,
                                    sm_scale=scale)[:, :, None]
        else:
            attn = _window_attention(qc, cache.cross_k, cache.cross_v, None,
                                     scale, None)
        attn = attn.transpose(1, 2).reshape(b, q_len, h * dkv)
        x = x + t5._matmul(attn, ca["o"])

        # ---- mlp ----
        x = t5._ff(config, blk["ff_layer"], x)

    x = t5._layer_norm(config,
                       params["decoder"]["final_layer_norm"]["weight"], x)
    if config.tie_word_embeddings:
        logits = torch.matmul(x, emb.T.to(x.dtype))
    else:
        logits = t5._matmul(x, params["lm_head"])
    return logits, state._replace(t=t + q_len)
