"""KV-cached beam search decoding.

The counterpart of `flasht5_tpu/inference/beam_search.py`, with its
semantics (HF's BeamSearchScorer):

- per step, take the top ``2*num_beams`` candidates of
  ``log_softmax(logits) + beam_score`` over the flattened (beam, vocab) axis;
- a candidate whose token is EOS and whose rank is < ``num_beams`` becomes a
  finished hypothesis with score ``sum_logprobs / prefix_len**length_penalty``
  (``prefix_len`` counts the decoder-start token plus the generated tokens,
  excluding the EOS itself);
- the best ``num_beams`` non-EOS candidates continue as the next beams;
- with ``early_stopping=True`` a batch row is done once ``num_beams``
  hypotheses are banked; with ``early_stopping=False`` it also requires the
  worst banked hypothesis to beat the best open beam's score at the current
  length (the JAX package's heuristic, kept as it is: it differs from HF's);
- at ``max_length``, still-open rows bank their current beams.

Beams ride the batch axis (B*K lanes) through the single-token
`decode_step` that greedy generation uses; the self caches are reordered
each step by a gather over the beam axis. Cross K/V are projected once at
batch B and repeated to B*K lanes. The loop reads its stop flag every
SYNC_EVERY steps: a step after every row is done changes nothing (frozen
rows keep their beams, scores and tokens, and bank nothing), so the result
is that of a loop that stops at once.

Output contract as `inference.generate`: tokens (B, max_length+1), position
0 the decoder start token 0, EOS forced at the boundary, zeros after the
first EOS; and the returned sequence's length-penalized score.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.inference.kv_cache import (DecodeState, LayerCache,
                                                  decode_step,
                                                  init_decode_state)
from flasht5_tpu_torch.models import t5

_NEG = -1e9
# steps between two reads of the stop flag
SYNC_EVERY = 8


def _bank_hypotheses(fields, add, scores_pen, src_tokens, eos_pos, eos):
    """Insert one candidate per batch row into the K-slot bank.

    ``fields``: (hyp_tokens (B, K, L1), hyp_scores (B, K), hyp_lens (B, K),
    hyp_count (B,)). ``add``: (B,) bool, whether the row banks the
    candidate; ``scores_pen``: (B,) its length-penalized score;
    ``src_tokens``: (B, L1) the prefix buffer to store; ``eos_pos``: the EOS
    write position (an int). Keeps the best K by replacing the current
    worst when full."""
    hyp_tokens, hyp_scores, hyp_lens, hyp_count = fields
    b, k, l1 = hyp_tokens.shape
    full = hyp_count >= k
    worst = torch.argmin(hyp_scores, dim=-1)                     # (B,)
    slot = torch.where(full, worst, torch.clamp(hyp_count, max=k - 1))
    worst_score = torch.gather(hyp_scores, 1, worst[:, None])[:, 0]
    better = torch.where(full, scores_pen > worst_score, True)
    do = add & better

    pos = torch.arange(l1, device=hyp_tokens.device)[None, :]
    row = torch.where(pos < eos_pos, src_tokens, 0)
    row = torch.where(pos == eos_pos, eos, row)

    write = (torch.nn.functional.one_hot(slot, k).bool()
             & do[:, None])                                      # (B, K)
    hyp_tokens = torch.where(write[:, :, None], row[:, None, :], hyp_tokens)
    hyp_scores = torch.where(write, scores_pen[:, None], hyp_scores)
    hyp_lens = torch.where(write, eos_pos, hyp_lens)
    hyp_count = hyp_count + (do & ~full).long()
    return hyp_tokens, hyp_scores, hyp_lens, hyp_count


def _repeat_beams(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, ...) -> (B*K, ...) with beams contiguous per row (b-major)."""
    return torch.repeat_interleave(x, k, dim=0)


@torch.no_grad()
def beam_generate(config: FlashT5Config, params, input_ids: torch.Tensor,
                  attention_mask: Optional[torch.Tensor] = None, *,
                  num_beams: int = 4, max_length: int = 32,
                  length_penalty: float = 1.0, early_stopping: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached beam search. Returns (tokens (B, max_length+1), scores
    (B,) f32), the scores the length-penalized log-prob of the returned
    sequence (HF's ``sequences_scores``)."""
    dev = params["shared"]["embedding"].device
    ids = torch.as_tensor(input_ids, device=dev)
    b = ids.shape[0]
    k = int(num_beams)
    eos = config.eos_token_id
    l1 = max_length + 1

    enc = t5.encode(config, params, ids, attention_mask)
    state = init_decode_state(config, params, enc, max_length,
                              encoder_mask=attention_mask)
    # cross K/V projected once at batch B and repeated; the self caches are
    # empty, so their repeat is just an allocation
    state = DecodeState(
        layers=tuple(LayerCache(*(_repeat_beams(x, k) for x in lc))
                     for lc in state.layers),
        encoder_mask=(None if state.encoder_mask is None
                      else _repeat_beams(state.encoder_mask, k)),
        t=state.t)

    tokens = torch.zeros((b, k, l1), dtype=torch.int64, device=dev)
    beam_scores = torch.full((b, k), _NEG, dtype=torch.float32, device=dev)
    beam_scores[:, 0] = 0.0
    hyp = (torch.zeros((b, k, l1), dtype=torch.int64, device=dev),
           torch.full((b, k), -torch.inf, dtype=torch.float32, device=dev),
           torch.zeros((b, k), dtype=torch.int64, device=dev),
           torch.zeros((b,), dtype=torch.int64, device=dev))
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    rank = torch.arange(2 * k, device=dev)[None, :]
    ident = torch.arange(k, device=dev)[None, :].expand(b, k)
    lanes = (torch.arange(b, device=dev)[:, None] * k)

    while state.t < max_length:
        t = state.t
        cur = tokens[:, :, t].reshape(b * k)
        logits, state = decode_step(config, params, state, cur)
        logp = torch.log_softmax(logits.float(), dim=-1)
        v = logp.shape[-1]
        total = logp.reshape(b, k, v) + beam_scores[:, :, None]
        cand_scores, cand_idx = torch.topk(total.reshape(b, k * v), 2 * k,
                                           dim=-1)
        cand_src = cand_idx // v                                 # (B, 2K)
        cand_tok = cand_idx % v
        is_eos = cand_tok == eos

        # ---- bank EOS candidates with rank < K (HF rank rule) ----
        plen = t + 1  # decoder-start + t generated tokens, EOS excluded
        pen = cand_scores / float(plen) ** length_penalty
        for j in range(k):
            prefix = torch.gather(
                tokens, 1, cand_src[:, j, None, None].expand(b, 1, l1))[:, 0]
            hyp = _bank_hypotheses(hyp, is_eos[:, j] & ~done, pen[:, j],
                                   prefix, plen, eos)

        # ---- continue with the best K non-EOS candidates ----
        keep_rank = torch.cumsum((~is_eos).long(), dim=-1) - 1
        pick = (~is_eos) & (keep_rank < k)
        order = torch.where(pick, rank, 2 * k + rank)
        sel = torch.argsort(order, dim=-1)[:, :k]                # (B, K)
        new_scores = torch.gather(cand_scores, 1, sel)
        new_src = torch.gather(cand_src, 1, sel)
        new_tok = torch.gather(cand_tok, 1, sel)

        # frozen rows: identity reorder, unchanged scores and tokens
        new_src = torch.where(done[:, None], ident, new_src)
        new_scores = torch.where(done[:, None], beam_scores, new_scores)
        nxt = torch.where(done[:, None], tokens[:, :, t + 1], new_tok)
        tokens = torch.gather(tokens, 1,
                              new_src[:, :, None].expand(b, k, l1))
        tokens[:, :, t + 1] = nxt
        flat = (lanes + new_src).reshape(b * k)
        state = state._replace(layers=tuple(
            lc._replace(self_k=lc.self_k.index_select(0, flat),
                        self_v=lc.self_v.index_select(0, flat))
            for lc in state.layers))

        # ---- done rule ----
        hyp_scores, hyp_count = hyp[1], hyp[3]
        have_k = hyp_count >= k
        if early_stopping:
            done = done | have_k
        else:
            best_possible = (new_scores.max(dim=-1).values
                             / float(t + 1) ** length_penalty)
            worst_kept = torch.where(torch.isfinite(hyp_scores), hyp_scores,
                                     torch.inf).min(dim=-1).values
            done = done | (have_k & (worst_kept >= best_possible))
        beam_scores = new_scores
        if (state.t % SYNC_EVERY == 0 and state.t < max_length
                and bool(done.all())):
            break

    # ---- finalize still-open rows: bank their current beams ----
    t_end = state.t
    plen = min(t_end + 1, max_length)  # EOS forced at the boundary
    pen_fin = beam_scores / float(t_end + 1) ** length_penalty
    for j in range(k):
        hyp = _bank_hypotheses(hyp, ~done, pen_fin[:, j], tokens[:, j],
                               plen, eos)
    hyp_tokens, hyp_scores, hyp_lens, _ = hyp

    best = torch.argmax(hyp_scores, dim=-1)                      # (B,)
    out = torch.gather(hyp_tokens, 1, best[:, None, None].expand(b, 1,
                                                                 l1))[:, 0]
    out_scores = torch.gather(hyp_scores, 1, best[:, None])[:, 0]
    # zeros after the first EOS (reference contract, modeling:683-688)
    first = torch.gather(hyp_lens, 1, best[:, None])
    pos = torch.arange(l1, device=dev)[None, :]
    out = torch.where(pos < first, out, 0)
    out = torch.where(pos == first, eos, out)
    return out, out_scores
