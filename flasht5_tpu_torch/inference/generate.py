"""KV-cached generation: greedy and sampling decode loops.

The counterpart of `flasht5_tpu/inference/generate.py`, with its contract
(the reference generate, modeling_flash_t5.py:648-690): decoding starts from
token 0, stops once every row has emitted EOS or at max_length, the final
position is forced to EOS, and everything after each row's first EOS is
zero-padded.

Each step is one single-token `decode_step` (the single-query kernel on the
card). The JAX loop decodes through a two-token window whose second row it
throws away, a TPU lowering workaround that the port drops. The loop reads
its stop flag from the card every SYNC_EVERY steps instead of every step:
the steps it runs past the point where every row has emitted EOS write only
positions after each row's first EOS, which the padding zeroes, and leave
the boundary unforced (every row already ends), so the tokens are those of
a loop that stops at once.
"""

from __future__ import annotations

from typing import Optional

import torch

from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.inference.kv_cache import (decode_step,
                                                  init_decode_state)
from flasht5_tpu_torch.inference.sampling import draw, gumbel
from flasht5_tpu_torch.models import t5


# steps between two reads of the stop flag
SYNC_EVERY = 8


def _sample_token(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int], top_p: Optional[float],
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """The JAX generate loop's own draw (not `sampling.sample_token`): its
    top-k masks with -inf below the k-th sorted logit, and its top-p keeps
    `sum(cum < p) + 1` tokens. The Gumbel noise comes from `generator`."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k is not None and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1)     # keep cutoff_idx + 1
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return draw(logits, gumbel(logits.shape, generator, logits.device))


@torch.no_grad()
def generate(config: FlashT5Config, params, input_ids: torch.Tensor,
             attention_mask: Optional[torch.Tensor] = None,
             max_length: int = 32, *, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """KV-cached generation. Returns (B, max_length + 1) token ids, on the
    device where `params` lie.

    temperature=0 -> greedy (the tokens of `t5.greedy_generate`). Sampling
    draws its Gumbel noise from `generator`. The stop flag is read every
    SYNC_EVERY steps (one host read)."""
    dev = params["shared"]["embedding"].device
    ids = torch.as_tensor(input_ids, device=dev)
    b = ids.shape[0]
    eos = config.eos_token_id
    enc = t5.encode(config, params, ids, attention_mask)
    state = init_decode_state(config, params, enc, max_length,
                              encoder_mask=attention_mask)
    tokens = torch.zeros((b, max_length + 1), dtype=torch.int64, device=dev)
    seen_eos = torch.zeros((b,), dtype=torch.bool, device=dev)
    t = 0
    while t < max_length:
        logits, state = decode_step(config, params, state, tokens[:, t])
        nxt = _sample_token(logits, temperature, top_k, top_p, generator)
        tokens[:, t + 1] = nxt
        seen_eos |= nxt == eos
        t += 1
        if t % SYNC_EVERY == 0 and t < max_length and bool(seen_eos.all()):
            break
    return t5.finish_generation(config, tokens, t == max_length)
