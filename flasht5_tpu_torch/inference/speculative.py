"""Draft-free speculative decoding: prompt-lookup drafts + windowed verify.

The counterpart of `flasht5_tpu/inference/speculative.py`. A bigram "prompt
lookup" proposes the next ``window-1`` tokens by copying from the encoder
input, and one `decode_window_step` scores them all; the model's own argmax
accepts the longest matching prefix plus one bonus token, so the output is
the greedy decode's token for token (per the model's argmax chain: the
Q-row verify and the one-row step may sum in another order, so at bf16 a
near-tied argmax can flip; f32 is exact).

The verify window runs at Q = window, whose attention is plain PyTorch
(`kv_cache.decode_window_step`). The batch's rows advance together at the
batch-minimum acceptance: the cache position stays one host integer, and
the rows past it are rewritten by the next window ("rollback" is that
integer). That advance is read from the card once a window.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.inference.kv_cache import (decode_window_step,
                                                  init_decode_state)
from flasht5_tpu_torch.models import t5


def _lookup_draft(src_pad: torch.Tensor, prev_src: torch.Tensor,
                  a: torch.Tensor, b_tok: torch.Tensor, n_draft: int,
                  s_len: int) -> torch.Tensor:
    """Propose ``n_draft`` tokens: find the LAST position j in the source
    where (src[j-1], src[j]) == (a, b) and copy src[j+1 : j+1+n_draft].

    src_pad: (B, S + n_draft) zero-padded source; prev_src: (B, S) source
    shifted right with -1 at position 0. Rows with no match draft zeros."""
    src = src_pad[:, :s_len]
    match = (src == b_tok[:, None]) & (prev_src == a[:, None])   # (B, S)
    j = torch.arange(s_len, device=src.device)[None, :]
    j_star = torch.where(match, j, -1).max(dim=-1).values        # (B,)
    found = j_star >= 0
    idx = (j_star[:, None] + 1
           + torch.arange(n_draft, device=src.device)[None, :])
    idx = idx.clamp(0, src_pad.shape[1] - 1)
    draft = torch.gather(src_pad, 1, idx)
    return torch.where(found[:, None], draft, 0)


@torch.no_grad()
def speculative_generate(config: FlashT5Config, params,
                         input_ids: torch.Tensor,
                         attention_mask: Optional[torch.Tensor] = None, *,
                         max_length: int = 32, window: int = 8,
                         draft_source: Optional[torch.Tensor] = None,
                         return_stats: bool = False):
    """Greedy generation through speculative verify windows: the tokens of
    ``generate(..., temperature=0)``. ``window`` is the verify width: one
    current token plus ``window - 1`` drafted ones a model pass.

    Returns tokens (B, max_length+1); with ``return_stats=True`` also a dict
    with ``windows`` (model passes) and ``generated`` (tokens decoded before
    the stop condition)."""
    if window < 2:
        raise ValueError("window must be >= 2 (1 input + >=1 draft)")
    dev = params["shared"]["embedding"].device
    ids = torch.as_tensor(input_ids, device=dev)
    b = ids.shape[0]
    eos = config.eos_token_id
    l1 = max_length + 1
    n_draft = window - 1

    src = torch.as_tensor(ids if draft_source is None else draft_source,
                          device=dev).long()
    s_len = src.shape[1]
    src_pad = F.pad(src, (0, n_draft))
    prev_src = F.pad(src[:, :-1], (1, 0), value=-1)

    enc = t5.encode(config, params, ids, attention_mask)
    # window slack: the last verify window may overhang max_length
    state = init_decode_state(config, params, enc, max_length + window,
                              encoder_mask=attention_mask)
    tokens = torch.zeros((b, l1), dtype=torch.int64, device=dev)
    pos = torch.arange(l1, device=dev)[None, :]
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    all_done = False
    windows = 0
    while state.t < max_length and not all_done:
        t = state.t
        b_tok = tokens[:, t]
        # -2 never matches prev_src: no draft on the first window
        a = tokens[:, t - 1] if t >= 1 else torch.full_like(b_tok, -2)
        draft = _lookup_draft(src_pad, prev_src, a, b_tok, n_draft, s_len)
        w_in = torch.cat([b_tok[:, None], draft], dim=1)         # (B, Q)

        logits, state = decode_window_step(config, params, state, w_in)
        g = torch.argmax(logits, dim=-1)                         # (B, Q)

        ok = torch.cumprod((draft == g[:, :-1]).long(), dim=1)
        n_acc = ok.sum(dim=1)                                    # (B,)
        advance = torch.where(done, window, n_acc + 1)
        m_adv = advance.min().clamp(max=max_length - t).clamp(min=1)

        rel = pos - (t + 1)
        wmask = (rel >= 0) & (rel < m_adv) & ~done[:, None]
        vals = torch.gather(g, 1, rel.clamp(0, window - 1).expand(b, l1))
        tokens = torch.where(wmask, vals, tokens)
        gen = (pos >= 1) & (pos <= t + m_adv)
        done = ((tokens == eos) & gen).any(dim=-1)
        # the one host read of the window: the advance and the stop flag
        adv, all_done = torch.stack([m_adv, done.all().long()]).tolist()
        state = state._replace(t=t + adv)                        # rollback
        windows += 1

    tokens = t5.finish_generation(config, tokens, state.t == max_length)
    if return_stats:
        return tokens, {"windows": windows, "generated": state.t}
    return tokens
