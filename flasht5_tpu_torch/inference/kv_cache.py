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
  t + 1, the T5 bias row of position t) and the cross-attention (every
  encoder position, no bias);
- Q > 1 (speculative verify windows): plain PyTorch, f32 scores and a
  softmax, causal within the window, as the JAX package computes it
  (`_single_query_attention`, outside any Pallas kernel); the single-query
  kernel takes one query a row.
Only the T5 relative bias is ported (`t5.check_supported`).
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


def init_decode_state(config: FlashT5Config, params,
                      encoder_hidden_states: torch.Tensor,
                      max_decode_len: int,
                      encoder_mask: Optional[torch.Tensor] = None
                      ) -> DecodeState:
    """Allocate self caches and precompute cross K/V from the encoder
    output."""
    t5.check_supported(config)
    b = encoder_hidden_states.shape[0]
    dkv = config.d_kv
    dt = encoder_hidden_states.dtype
    dev = encoder_hidden_states.device
    layers = []
    for blk in params["decoder"]["block"]:
        ca = blk["cross_attention_layer"]["cross_attention"]
        h = ca["Wk"].shape[1] // dkv
        layers.append(LayerCache(
            self_k=torch.zeros((b, h, max_decode_len, dkv), dtype=dt,
                               device=dev),
            self_v=torch.zeros((b, h, max_decode_len, dkv), dtype=dt,
                               device=dev),
            cross_k=_proj_heads(encoder_hidden_states, ca["Wk"], h,
                                dkv).contiguous(),
            cross_v=_proj_heads(encoder_hidden_states, ca["Wv"], h,
                                dkv).contiguous()))
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


def _self_bias(config: FlashT5Config, table: torch.Tensor, t: int,
               q_len: int, max_len: int) -> torch.Tensor:
    """The T5 bias rows of positions t..t+q_len-1 against every cache
    position, (1, H, q_len, max_len) f32 (decoder: unidirectional)."""
    dev = table.device
    lut = positional.bucket_lut(
        -(max_len - 1), max_len - 1, bidirectional=False,
        num_buckets=config.relative_attention_num_buckets,
        max_distance=config.relative_attention_max_distance, device=dev)
    rel = (torch.arange(max_len, device=dev)[None, :]
           - torch.arange(t, t + q_len, device=dev)[:, None])
    values = table.float()[lut[rel + (max_len - 1)].long()]   # (Q, N, H)
    return values.permute(2, 0, 1)[None]


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
    the window); the T5 self-bias rows are built at layer 0 and reused in
    every layer; the cross-attention has no mask (the training path's
    encoder mask acts only through `use_masking`, which needs a bias)."""
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
    for li, blk in enumerate(params["decoder"]["block"]):
        cache = state.layers[li]

        # ---- self attention ----
        sa = blk["self_attention_layer"]["self_attention"]
        h = sa["Wq"].shape[1] // dkv
        normed = t5._layer_norm(
            config, blk["self_attention_layer"]["layer_norm"]["weight"], x)
        q = _proj_heads(normed, sa["Wq"], h, dkv)
        _write(cache.self_k, _proj_heads(normed, sa["Wk"], h, dkv), t)
        _write(cache.self_v, _proj_heads(normed, sa["Wv"], h, dkv), t)
        if li == 0:
            self_bias = _self_bias(
                config, sa["pe_encoding"]["relative_attention_bias"], t,
                q_len, max_len)
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
