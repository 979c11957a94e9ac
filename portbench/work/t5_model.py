"""Analytic model operations of T5 v1.1 (gated feed-forward, untied
lm_head): two per multiply-add of every weight product and of attention's
two products, a token at a time. Training is three times the forward
(forward, and the backward's two products per forward product), with no
recomputation counted."""

from __future__ import annotations

from typing import Dict


def _dims(m: Dict):
    d, inner, dff = m["d_model"], m["num_heads"] * m["d_kv"], m["d_ff"]
    n_enc = m["num_layers"]
    n_dec = m.get("num_decoder_layers") or n_enc
    return d, inner, dff, n_enc, n_dec, m["vocab_size"]


def encode_flops(m: Dict, length: int) -> float:
    """One sequence through the encoder, and the decoder layers' cross K/V
    projections of its states."""
    d, inner, dff, n_enc, n_dec, _ = _dims(m)
    per_layer = 2 * length * (4 * d * inner + 3 * d * dff) \
        + 4 * length * length * inner
    return n_enc * per_layer + n_dec * 2 * length * 2 * d * inner


def decode_flops(m: Dict, length: int, enc_len: int) -> float:
    """`length` decoder tokens of one sequence, causal, over `enc_len`
    encoder states, with the lm_head."""
    d, inner, dff, _, n_dec, vocab = _dims(m)
    linear = 2 * length * (6 * d * inner + 3 * d * dff)
    attn = 4 * inner * (length * (length + 1) // 2) \
        + 4 * inner * length * enc_len
    return n_dec * (linear + attn) + 2 * length * d * vocab


def decode_token_flops(m: Dict, pos: int, enc_len: int) -> float:
    """The decoder token at position `pos` (0-based) of one sequence."""
    d, inner, dff, _, n_dec, vocab = _dims(m)
    per_layer = 2 * (6 * d * inner + 3 * d * dff) \
        + 4 * inner * (pos + 1) + 4 * inner * enc_len
    return n_dec * per_layer + 2 * d * vocab


def train_step_flops(m: Dict, batch: int, enc_len: int, dec_len: int
                     ) -> float:
    return 3.0 * batch * (encode_flops(m, enc_len)
                          + decode_flops(m, dec_len, enc_len))
