"""T5 v1.1 (FAT5 and FLAN-T5 widths) in plain float32 PyTorch.

Follows the published model (HF `modeling_t5.py` and flashT5's
`modeling_flash_t5.py`): pre-norm RMSNorm blocks with weights and no
bias, the T5 relative position bias built once by the first block of each
stack and added in every block, unscaled dot products (`attention_scale`
1.0), gated GELU (tanh form) feed-forward, an untied lm_head without
rescaling, and flashT5's loss: cross-entropy plus z-loss * lse^2 per row,
averaged over every row, ignored ones included (the fused loss's
reduction). Masks act only through `use_masking`, which these
configurations leave off, so padded positions are attended as the model
sees them.

`Precision` says where values are rounded: `act` rounds every activation
where a bfloat16 program would hold one (None: float32 throughout; "fp8":
float8 e4m3 with a per-tensor scale, forward and backward); `weights` and
`kv` quantize the linear weights and the attention caches (None, "int8" or
"int4", symmetric, per output column and per head and position).
The float32 products run with TF32 off.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

LINEAR_KEYS = ("Wq", "Wk", "Wv", "o", "wi_0", "wi_1", "wo")


@dataclasses.dataclass(frozen=True)
class Precision:
    act: Optional[str] = None
    weights: Optional[str] = None
    kv: Optional[str] = None


FLOAT32 = Precision()


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# rounding
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale)


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def act(x: torch.Tensor, p: Precision) -> torch.Tensor:
    if p.act is None:
        return x
    if p.act == "fp8":
        return _RoundFp8.apply(x)
    raise ValueError(f"unknown activation precision {p.act!r}")


_LEVELS = {"int8": 127.0, "int4": 7.0}


def quantize_columns(w: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    """w (in, out) rounded to `mode` with one symmetric scale per output
    column (absmax / levels), returned dequantized in float32."""
    if mode is None:
        return w.float()
    levels = _LEVELS[mode]
    w = w.float()
    absmax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.where(absmax > 0, absmax / levels, torch.ones_like(absmax))
    return torch.clamp(torch.round(w / scale), -levels, levels) * scale


def quantize_rows(x: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    """x (..., D) rounded to `mode` with one symmetric scale per row over
    its last axis (a cache's head and position), dequantized."""
    if mode is None:
        return x
    levels = _LEVELS[mode]
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / levels, torch.ones_like(absmax))
    return torch.clamp(torch.round(x / scale), -levels, levels) * scale


def prepare(params: Dict, p: Precision) -> Dict:
    """The parameter tree with every linear weight (and the lm_head) in the
    precision `p.weights` states, dequantized to float32."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if key in LINEAR_KEYS or key == "lm_head":
            return quantize_columns(node, p.weights)
        return node.float()
    return walk(params)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def relative_bucket(rel: torch.Tensor, bidirectional: bool,
                    num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's log-bucketing of k_pos - q_pos (HF `_relative_position_bucket`,
    in float32 as the published model computes it)."""
    buckets = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        buckets += (rel > 0).long() * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = max_exact + (
        torch.log(rel.float() / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(is_small, rel, large)


def position_bias(table: torch.Tensor, q_len: int, k_len: int,
                  bidirectional: bool, m: Dict) -> torch.Tensor:
    """(1, H, q_len, k_len) float32 bias from the (buckets, H) table."""
    rel = (torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None])
    idx = relative_bucket(rel, bidirectional,
                          m.get("relative_attention_num_buckets", 32),
                          m.get("relative_attention_max_distance", 128))
    return table.float()[idx.to(table.device)].permute(2, 0, 1)[None]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.float().pow(2).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, n, _ = x.shape
    return x.view(b, n, h, -1).transpose(1, 2)


def attention(a: Dict, x: torch.Tensor, kv: torch.Tensor,
              bias: Optional[torch.Tensor], causal: bool, m: Dict,
              p: Precision) -> torch.Tensor:
    h = m["num_heads"]
    q = _heads(act(x @ a["Wq"], p), h)
    k = quantize_rows(_heads(act(kv @ a["Wk"], p), h), p.kv)
    v = quantize_rows(_heads(act(kv @ a["Wv"], p), h), p.kv)
    s = torch.matmul(q, k.transpose(-1, -2)) * float(
        m.get("attention_scale", 1.0) or 1.0)
    if bias is not None:
        s = s + bias
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool,
                                     device=s.device).triu(1), -math.inf)
    o = torch.matmul(torch.softmax(s.float(), dim=-1), v)
    o = act(o.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1), p)
    return act(o @ a["o"], p)


def feed_forward(f: Dict, x: torch.Tensor, p: Precision) -> torch.Tensor:
    g = F.gelu(act(x @ f["act"]["wi_0"], p), approximate="tanh")
    hidden = act(g * act(x @ f["act"]["wi_1"], p), p)
    return act(hidden @ f["wo"], p)


def _norm(x, w, m, p):
    return act(rms_norm(x, w, float(m.get("layer_norm_epsilon", 1e-6))), p)


def encode(params: Dict, ids: torch.Tensor, m: Dict,
           p: Precision = FLOAT32) -> torch.Tensor:
    enc = params["encoder"]
    x = act(params["shared"]["embedding"][ids], p)
    n = ids.shape[1]
    table = enc["block"][0]["self_attention_layer"]["self_attention"][
        "pe_encoding"]["relative_attention_bias"]
    bias = position_bias(table, n, n, True, m)
    for blk in enc["block"]:
        sa = blk["self_attention_layer"]
        h = _norm(x, sa["layer_norm"]["weight"], m, p)
        x = act(x + attention(sa["self_attention"], h, h, bias, False, m, p),
                p)
        ff = blk["ff_layer"]
        x = act(x + feed_forward(ff, _norm(x, ff["layer_norm"]["weight"], m,
                                           p), p), p)
    return _norm(x, enc["final_layer_norm"]["weight"], m, p)


def decode(params: Dict, dec_ids: torch.Tensor, enc: torch.Tensor, m: Dict,
           p: Precision = FLOAT32) -> torch.Tensor:
    """The decoder's final hidden states for teacher-forced inputs."""
    dec = params["decoder"]
    x = act(params["shared"]["embedding"][dec_ids], p)
    n = dec_ids.shape[1]
    table = dec["block"][0]["self_attention_layer"]["self_attention"][
        "pe_encoding"]["relative_attention_bias"]
    bias = position_bias(table, n, n, False, m)
    for blk in dec["block"]:
        sa = blk["self_attention_layer"]
        h = _norm(x, sa["layer_norm"]["weight"], m, p)
        x = act(x + attention(sa["self_attention"], h, h, bias, True, m, p),
                p)
        ca = blk["cross_attention_layer"]
        h = _norm(x, ca["layer_norm"]["weight"], m, p)
        x = act(x + attention(ca["cross_attention"], h, enc, None, False, m,
                              p), p)
        ff = blk["ff_layer"]
        x = act(x + feed_forward(ff, _norm(x, ff["layer_norm"]["weight"], m,
                                           p), p), p)
    return _norm(x, dec["final_layer_norm"]["weight"], m, p)


def shift_right(labels: torch.Tensor, start: int, pad: int) -> torch.Tensor:
    dec = torch.roll(labels, 1, dims=-1)
    dec[..., 0] = start
    return torch.where(dec == -100, pad, dec)


def logits(params: Dict, ids: torch.Tensor, dec_ids: torch.Tensor, m: Dict,
           p: Precision = FLOAT32) -> torch.Tensor:
    enc = encode(params, ids, m, p)
    return decode(params, dec_ids, enc, m, p) @ params["lm_head"]


def loss_sum(params: Dict, ids: torch.Tensor, labels: torch.Tensor, m: Dict,
             p: Precision = FLOAT32) -> torch.Tensor:
    """The sum over rows of cross-entropy + z_loss * lse^2 (0 for ignored
    rows); the model's loss is this over the number of rows."""
    dec_ids = shift_right(labels, int(m.get("decoder_start_token_id", 0)),
                          int(m.get("pad_token_id", 0)))
    out = logits(params, ids, dec_ids, m, p).float()
    flat = out.reshape(-1, out.shape[-1])
    lab = labels.reshape(-1).long()
    lse = torch.logsumexp(flat, dim=-1)
    keep = lab != -100
    picked = flat.gather(1, torch.where(keep, lab, 0)[:, None])[:, 0]
    z = float(m.get("z_loss") or 0.0)
    rows = lse - picked + z * lse * lse
    return torch.where(keep, rows, torch.zeros_like(rows)).sum()
