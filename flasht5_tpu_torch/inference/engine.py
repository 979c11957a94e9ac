"""Continuous-batching inference engine for encode+decode request mixes.

The PyTorch counterpart of `flasht5_tpu/inference/engine.py`: a fixed pool
of `max_slots` decode slots that decode in lockstep with per-slot state
(position, budget, active flag). New requests are admitted by a batched
prefill (inputs padded to the nearest encode bucket, batch rounded up to a
power of two) whose cross K/V is written into free slots; finished slots
are harvested and refilled between windows of `steps_per_sync` decode steps.

Where the JAX engine donates its state buffers, this engine writes the KV
caches in place (a slot's rows at insert, each slot's position at every
step); the small per-slot state tensors are replaced step by step. The host
synchronizes once per window: each window's tokens, finished flags and
active flags are copied to pinned host memory without blocking, and
`harvest` waits for that copy only, so the next window is already queued on
the device while the host reads the previous one.

Behaviour kept from the JAX engine: prefill encodes without an attention
mask and the cross-attention length is the padded bucket, not the true
input length; the decoder self-attention bias is built once, at layer 0,
and reused in every layer; decode-attention lengths are pos + 1 for
self-attention and the bucket for cross-attention; results end in EOS
(forced at the boundary when the budget runs out).

Each step picks its tokens by argmax, or with `temperature > 0` draws them
(`inference.sampling.sample_token`: temperature, top-k, top-p) with Gumbel
noise from one `torch.Generator` on the engine's device, seeded by
`sample_seed`.

The device work is shard-oblivious, as the JAX engine's step is: the slot
count comes from the state (this rank's slots under a data-split pool),
the head count from the (possibly tensor-split) projections, the
o-projections of a block go through the model's row-parallel product (an
all-reduce over the tensor group, or the ring under
`use_collective_matmul`) and, with an untied lm_head, the next token comes
from the vocab-parallel argmax; the hooks `_encode`, `_gather_slots`,
`_gather_vocab`, `_visible` and `_prefill_batch` are the identity here
and carry the collectives in `sharded_engine.ShardedEngine`.

Speculative windows (`spec_window` = Q >= 2, greedy only, the plain
attention path), as in the JAX engine (`_make_spec_step`): each step of a
window, every slot drafts Q - 1 tokens by bigram lookup in its own encoder
input (or its request's `draft_source`), runs [current token, drafts]
through one Q-row decode pass, causal within the window with each row's
own T5 bias row, and emits the longest prefix its argmax chain confirms
plus one bonus token, so each slot advances by its own count. The window's
K/V rows are masked overwrites (a rejected draft leaves stale rows that the
next window rewrites), native or int8. Each row's attention is the
standard step's plain attention on that row, and every other operation
acts row by row, so the tokens are the standard greedy engine's at any
acceptance rate (with `use_decode_kernel=False`, as the window requires).
`spec_stats` counts windows with an active slot, (window, active slot)
pairs and tokens: tokens / slot_windows is the acceptance.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flasht5_tpu_torch import positional, runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.inference import kv_cache, sampling
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.ops.decode_attention import decode_attention
from flasht5_tpu_torch.ops.quant import dequantize_kv, quantize_kv

_NEG_INF = -1e30


@dataclasses.dataclass
class Request:
    uid: int
    input_ids: np.ndarray           # (L,) int32
    max_new_tokens: int = 32
    result: Optional[np.ndarray] = None  # filled when finished
    # speculative windows look up their bigram drafts here instead of in
    # input_ids when set (a speed hint only: the tokens do not change)
    draft_source: Optional[np.ndarray] = None
    # host wall-clock seconds relative to the start of run():
    arrival_s: float = 0.0          # earliest admit time
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 8               # concurrent decoding sequences
    max_decode_len: int = 64         # self-KV capacity per slot
    max_encode_len: int = 512        # cross-KV capacity per slot
    encode_buckets: Tuple[int, ...] = (64, 128, 256, 512)
    kv_dtype: str = "native"         # "native" | "int8"
    steps_per_sync: int = 8          # decode steps per host synchronization
    use_decode_kernel: bool = False  # decode-attention kernel vs plain math
    # sampling (inference/sampling.py): temperature <= 0 -> greedy argmax;
    # > 0 -> a draw with optional top-k / nucleus filtering
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    sample_seed: int = 0
    # >= 2: Q-token speculative verify windows (greedy, plain attention)
    spec_window: int = 0


class KVTensor(NamedTuple):
    """(values, scales) cache tensor; scales None for the native dtype.
    INT8: values (B,H,L,D) int8 + per-(slot, head, position) fp32 scales
    (B,H,L,1)."""
    values: torch.Tensor
    scales: Optional[torch.Tensor] = None


def _kv_read(kv: KVTensor, dtype=torch.float32) -> torch.Tensor:
    if kv.scales is None:
        return kv.values.to(dtype)
    return dequantize_kv(kv.values, kv.scales, dtype)


def _kv_make(x: torch.Tensor, quantized: bool) -> KVTensor:
    if not quantized:
        return KVTensor(x)
    return KVTensor(*quantize_kv(x))


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor], valid: torch.Tensor,
                     scale: float, dtype: torch.dtype) -> torch.Tensor:
    """One query a slot: q (B, H, D) against f32 k, v (B, H, N, D), an
    f32 bias (B, H, N) or None, valid (B, N) -> (B, H, D) in `dtype`. The
    standard step's plain attention, and each row of a speculative
    window's."""
    s = torch.einsum("bhd,bhnd->bhn", q.float(), k) * scale
    if bias is not None:
        s = s + bias
    s = torch.where(valid[:, None, :], s, _NEG_INF)
    return torch.einsum("bhn,bhnd->bhd", torch.softmax(s, -1), v).to(dtype)


def _window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: Optional[torch.Tensor], valid: torch.Tensor,
                      scale: float, dtype: torch.dtype) -> torch.Tensor:
    """A speculative window's Q queries a slot: q (B, H, Q, D) against
    f32 k, v (B, H, N, D), an f32 bias (B, H, Q, N) or None, valid
    (B, Q, N) -> (B, Q, H, D) in `dtype`. Each row is the standard step's
    `_plain_attention`, call for call, so a window row rounds as the
    standard step does and the tokens stay the standard engine's (one
    batched einsum over the Q rows rounds otherwise, and at bf16 the
    argmax flips on near-ties: `chip_smoke.py --spec-probe`)."""
    return torch.stack([_plain_attention(
        q[:, :, j], k, v, None if bias is None else bias[:, :, j],
        valid[:, j], scale, dtype) for j in range(q.shape[2])], dim=1)


def bucket_for(buckets: Tuple[int, ...], length: int) -> int:
    """The smallest encode bucket that holds `length` (else the largest)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def prefill_batch(n: int, max_slots: int) -> int:
    """Round a prefill batch up to a power of two (at most max_slots)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max(1, max_slots))


def encode_cross(config: FlashT5Config, params, ids: np.ndarray,
                 device: torch.device) -> List[Tuple[torch.Tensor, ...]]:
    """Batched prefill: encode (nb, bucket) ids in one pass and return each
    decoder layer's cross K/V, (nb, H, bucket, d_kv) each."""
    enc = t5.encode(config, params, torch.from_numpy(ids).to(device))
    outs = []
    for blk in params["decoder"]["block"]:
        ca = blk["cross_attention_layer"]["cross_attention"]
        h = ca["Wk"].shape[1] // config.d_kv
        outs.append((kv_cache._proj_heads(enc, ca["Wk"], h, config.d_kv),
                     kv_cache._proj_heads(enc, ca["Wv"], h, config.d_kv)))
    return outs


def local_heads(config: FlashT5Config, params) -> int:
    """The heads this rank holds: the decoder's query projection's columns
    over d_kv (all of them without tensor parallelism)."""
    block = params["decoder"]["block"][0]
    return (block["self_attention_layer"]["self_attention"]["Wq"].shape[1]
            // config.d_kv)


def next_token(config: FlashT5Config, group, logits: torch.Tensor,
               generator: torch.Generator, ecfg) -> torch.Tensor:
    """Each slot's next token from its logits (B, V), or under tensor
    parallelism with an untied lm_head from this rank's (B, V/t) slice by
    the vocab-parallel argmax or draw (JAX engine.py:408-416)."""
    if group is not None and not config.tie_word_embeddings:
        from flasht5_tpu_torch.parallel.vocab_parallel import (
            vocab_parallel_next_token)
        return vocab_parallel_next_token(
            logits, group, generator=generator,
            temperature=ecfg.temperature, top_k=ecfg.top_k, top_p=ecfg.top_p)
    return sampling.sample_token(logits, generator=generator,
                                 temperature=ecfg.temperature,
                                 top_k=ecfg.top_k, top_p=ecfg.top_p)


class BatchState:
    """Device-side slot pool: KV caches (written in place) and per-slot
    scalars, for `slots` slots (all of them, or a data rank's) and the
    heads the parameters hold."""

    def __init__(self, config: FlashT5Config, params, ecfg: EngineConfig,
                 device: torch.device, slots: Optional[int] = None):
        b, h, dkv = (slots or ecfg.max_slots, local_heads(config, params),
                     config.d_kv)
        quant = ecfg.kv_dtype == "int8"
        dt = torch.int8 if quant else runtime.torch_dtype(config.dtype)

        def kv(length):
            vals = torch.zeros((b, h, length, dkv), dtype=dt, device=device)
            scales = (torch.zeros((b, h, length, 1), dtype=torch.float32,
                                  device=device) if quant else None)
            return KVTensor(vals, scales)

        self.layers = tuple(
            kv_cache.LayerCache(
                self_k=kv(ecfg.max_decode_len),
                self_v=kv(ecfg.max_decode_len),
                cross_k=kv(ecfg.max_encode_len),
                cross_v=kv(ecfg.max_encode_len),
            ) for _ in params["decoder"]["block"])

        def zeros(dtype):
            return torch.zeros((b,), dtype=dtype, device=device)

        self.enc_len = zeros(torch.int32)     # valid cross positions
        self.pos = zeros(torch.int64)         # next decode position
        self.cur_token = zeros(torch.int64)   # last emitted token
        self.active = zeros(torch.bool)
        self.budget = zeros(torch.int64)      # remaining new tokens
        self.prev_token = zeros(torch.int64)  # the token before cur_token


class InferenceEngine:
    """Continuous-batching engine over a slot pool (greedy or sampled).

        engine = InferenceEngine(config, params, EngineConfig(...))
        done = engine.run(requests)   # each request's .result is set

    Runs on `device` (default `cuda`; raises without a GPU unless
    device='cpu'), where `params` must already lie. With `config.tp_axis`
    the model's collectives need a current mesh (`parallel.mesh.use_mesh`):
    `sharded_engine.ShardedEngine` sets one up.
    """

    # data ranks the slots split over, and this rank's index among them
    # (set by the sharded subclass before this constructor runs)
    _data, _data_rank = 1, 0

    def __init__(self, config: FlashT5Config, params, ecfg: EngineConfig,
                 device=None):
        t5.check_supported(config)
        if config.position_encoding_type != "t5":
            # the JAX package's engine builds only the T5 bias
            # (flasht5_tpu/inference/engine.py:335 and :575) and serves
            # the other encodings with no position signal at all
            raise NotImplementedError(
                f"InferenceEngine serves the T5 relative bias only, not "
                f"{config.position_encoding_type}")
        if ecfg.spec_window >= 2 and ecfg.temperature > 0.0:
            raise ValueError("speculative windows are greedy only "
                             "(temperature must be 0)")
        if ecfg.spec_window >= 2 and ecfg.use_decode_kernel:
            raise ValueError("the decode kernel is single-query: "
                             "use_decode_kernel must be off with "
                             "spec_window >= 2")
        if ecfg.kv_dtype not in ("native", "int8"):
            raise ValueError(f"unknown kv_dtype {ecfg.kv_dtype!r}")
        self.device = runtime.resolve_device(device)
        emb = params["shared"]["embedding"]
        if emb.device != self.device:
            raise ValueError(f"params lie on {emb.device}, the engine runs "
                             f"on {self.device}")
        self.config = config
        self.params = params
        self.ecfg = ecfg
        self._group = t5._tp_group(config)
        self._b = ecfg.max_slots // self._data      # this rank's slots
        self.state = BatchState(config, params, ecfg, self.device, self._b)
        L = ecfg.max_decode_len
        self._slots = torch.arange(self._b, device=self.device)
        self._kpos = torch.arange(L, device=self.device)
        self._cpos = torch.arange(ecfg.max_encode_len, device=self.device)
        # bucket of every self-attention offset k - pos, pos in [0, L]
        self._self_lut = positional.bucket_lut(
            -L, L - 1, bidirectional=False,
            num_buckets=config.relative_attention_num_buckets,
            max_distance=config.relative_attention_max_distance,
            device=self.device)
        self._sample_gen = torch.Generator(device=self.device).manual_seed(
            ecfg.sample_seed)
        self._host_bufs = []
        self._windows = 0
        if ecfg.spec_window >= 2:
            q = ecfg.spec_window
            # buckets of the window rows' offsets k - (pos + j), down to
            # -(L + Q) (rows past the cache belong to slots that are done)
            self._spec_lut = positional.bucket_lut(
                -(L + q), L - 1, bidirectional=False,
                num_buckets=config.relative_attention_num_buckets,
                max_distance=config.relative_attention_max_distance,
                device=self.device)
            self._qrange = torch.arange(q, device=self.device)
            # each slot's draft source, written at admission
            self._draft = torch.zeros((self._b, ecfg.max_encode_len),
                                      dtype=torch.int64, device=self.device)
            self.spec_stats = {"windows": 0, "tokens": 0, "slot_windows": 0}

    # -- prefill -----------------------------------------------------------

    def _prefill_batch(self, n: int) -> int:
        """The rows of a prefill batch of n requests."""
        return prefill_batch(n, self.ecfg.max_slots)

    def _encode(self, ids: np.ndarray):
        """Each decoder layer's cross K/V of a prefill batch (nb, bucket)."""
        return encode_cross(self.config, self.params, ids, self.device)

    def _local_slot(self, slot: int) -> Optional[int]:
        """Slot `slot`'s index in this rank's pool, None where another
        data rank owns it."""
        local = slot - self._data_rank * self._b
        return local if 0 <= local < self._b else None

    def _insert(self, cross, row: int, slot: int, true_len: int,
                max_new: int) -> None:
        """Write row `row` of a batched prefill into slot `slot` and reset
        the slot (in place), on the data rank that owns it."""
        slot = self._local_slot(slot)
        if slot is None:
            return
        st, ecfg = self.state, self.ecfg
        quant = ecfg.kv_dtype == "int8"

        def put(kv: KVTensor, new: KVTensor):
            kv.values[slot] = new.values[0].to(kv.values.dtype)
            if kv.scales is not None:
                kv.scales[slot] = new.scales[0]

        for cache, (ckb, cvb) in zip(st.layers, cross):
            pad = ecfg.max_encode_len - ckb.shape[2]
            put(cache.cross_k, _kv_make(
                F.pad(ckb[row:row + 1], (0, 0, 0, pad)), quant))
            put(cache.cross_v, _kv_make(
                F.pad(cvb[row:row + 1], (0, 0, 0, pad)), quant))
            for kv in (cache.self_k, cache.self_v):
                kv.values[slot] = 0
                if kv.scales is not None:
                    kv.scales[slot] = 0
        st.enc_len[slot] = true_len
        st.pos[slot] = 0
        st.cur_token[slot] = 0          # decoder start token
        st.active[slot] = True
        st.budget[slot] = max_new
        st.prev_token[slot] = 0

    # -- decode ------------------------------------------------------------

    def _write_position(self, kv: KVTensor, new: torch.Tensor,
                        pos: torch.Tensor) -> None:
        """Write new (B, H, D) at each slot's position, in place. An active
        slot's position is always < max_decode_len and was zeroed at insert;
        an inactive slot's row is rewritten at insert before it is read."""
        newq = _kv_make(new, kv.scales is not None)
        kv.values[self._slots, :, pos] = newq.values.to(kv.values.dtype)
        if kv.scales is not None:
            kv.scales[self._slots, :, pos] = newq.scales

    def _step(self, cur_token: torch.Tensor):
        """One lockstep decode step for all slots (inactive slots run too;
        their outputs are masked). Updates the state; returns (next token,
        finished flags, logits), all on the device."""
        config, ecfg, st, params = self.config, self.ecfg, self.state, self.params
        b, dkv, group = self._b, config.d_kv, self._group
        L = ecfg.max_decode_len
        scale = config.softmax_scale
        emb = params["shared"]["embedding"]
        x = emb[cur_token].to(runtime.torch_dtype(config.dtype))[:, None, :]
        pos = st.pos
        wpos = pos.clamp(max=L - 1)
        self_len = (pos + 1).to(torch.int32)
        self_bias = None

        for li, blk in enumerate(params["decoder"]["block"]):
            cache = st.layers[li]
            sa = blk["self_attention_layer"]["self_attention"]
            h = sa["Wq"].shape[1] // dkv
            normed = t5._layer_norm(
                config, blk["self_attention_layer"]["layer_norm"]["weight"], x)
            q = kv_cache._proj_heads(normed, sa["Wq"], h, dkv)
            self._write_position(cache.self_k,
                                 kv_cache._proj_heads(normed, sa["Wk"], h,
                                                      dkv)[:, :, 0], wpos)
            self._write_position(cache.self_v,
                                 kv_cache._proj_heads(normed, sa["Wv"], h,
                                                      dkv)[:, :, 0], wpos)
            if li == 0:
                # per-slot bias row bucket(k - pos_slot) -> (B, H, L)
                rel = self._kpos[None, :] - pos[:, None] + L
                table = sa["pe_encoding"]["relative_attention_bias"]
                self_bias = table.float()[self._self_lut[rel].long()] \
                    .permute(0, 2, 1).contiguous()
            if ecfg.use_decode_kernel:
                attn = decode_attention(
                    q[:, :, 0], cache.self_k.values, cache.self_v.values,
                    k_scales=cache.self_k.scales,
                    v_scales=cache.self_v.scales, lengths=self_len,
                    bias=self_bias, sm_scale=scale)
            else:
                attn = _plain_attention(
                    q[:, :, 0], _kv_read(cache.self_k),
                    _kv_read(cache.self_v), self_bias,
                    self._kpos[None, :] <= pos[:, None], scale, x.dtype)
            x = x + t5._row_parallel_matmul(config, group,
                                            attn.reshape(b, 1, h * dkv),
                                            sa["o"])

            ca = blk["cross_attention_layer"]["cross_attention"]
            normed = t5._layer_norm(
                config, blk["cross_attention_layer"]["layer_norm"]["weight"],
                x)
            qc = kv_cache._proj_heads(normed, ca["Wq"], h, dkv)[:, :, 0]
            if ecfg.use_decode_kernel:
                attn = decode_attention(
                    qc, cache.cross_k.values, cache.cross_v.values,
                    k_scales=cache.cross_k.scales,
                    v_scales=cache.cross_v.scales, lengths=st.enc_len,
                    sm_scale=scale)
            else:
                attn = _plain_attention(
                    qc, _kv_read(cache.cross_k), _kv_read(cache.cross_v),
                    None, self._cpos[None, :] < st.enc_len[:, None], scale,
                    x.dtype)
            x = x + t5._row_parallel_matmul(config, group,
                                            attn.reshape(b, 1, h * dkv),
                                            ca["o"])
            x = t5._ff(config, blk["ff_layer"], x)

        x = t5._layer_norm(config, params["decoder"]["final_layer_norm"]["weight"],
                           x)
        if config.tie_word_embeddings:
            logits = torch.matmul(x, emb.T.to(x.dtype))[:, 0]
        else:
            logits = t5._matmul(x, params["lm_head"])[:, 0]
        nxt = next_token(config, group, logits, self._sample_gen, ecfg)

        active = st.active
        st.budget = torch.where(active, st.budget - 1, st.budget)
        out_of_room = (pos + 1 >= L) | (st.budget <= 0)
        finished = active & ((nxt == config.eos_token_id) | out_of_room)
        st.cur_token = torch.where(active, nxt, cur_token)
        st.pos = torch.where(active, pos + 1, pos)
        st.active = active & ~finished
        return nxt, finished, logits

    # -- speculative windows (spec_window >= 2) ---------------------------

    def _drafts(self) -> torch.Tensor:
        """Each slot's Q - 1 prompt-lookup drafts: the tokens after the last
        place where its draft source holds the bigram (previous token,
        current token), or zeros where it holds none; at position 0 the
        current token alone is matched at the source's first place."""
        st, q = self.state, self.ecfg.spec_window
        src = self._draft
        prev_eff = torch.where(st.pos == 0, -2, st.prev_token)
        prev_src = F.pad(src[:, :-1], (1, 0), value=-1)
        match = ((src == st.cur_token[:, None])
                 & (prev_src == prev_eff[:, None]))
        j_star = torch.where(match, self._cpos[None, :], -1).amax(dim=-1)
        src_pad = F.pad(src, (0, q - 1))
        idx = (j_star[:, None] + 1 + self._qrange[None, :q - 1]).clamp(
            0, src_pad.shape[1] - 1)
        draft = torch.gather(src_pad, 1, idx)
        return torch.where((j_star >= 0)[:, None], draft, 0)

    def _write_window(self, kv: KVTensor, new: torch.Tensor,
                      in_win: torch.Tensor, row: torch.Tensor) -> None:
        """Overwrite each slot's window rows pos..pos+Q-1 (those inside the
        cache) with new (B, H, Q, D), in place."""
        newq = _kv_make(new, kv.scales is not None)
        idx = row[:, None, :, None]
        mask = in_win[:, None, :, None]
        kv.values.copy_(torch.where(
            mask, torch.gather(newq.values.to(kv.values.dtype), 2,
                               idx.expand(-1, new.shape[1], -1,
                                          new.shape[3])), kv.values))
        if kv.scales is not None:
            kv.scales.copy_(torch.where(
                mask, torch.gather(newq.scales, 2,
                                   idx.expand(-1, new.shape[1], -1, 1)),
                kv.scales))

    def _spec_step(self):
        """One Q-row verify window for every slot (inactive slots run too;
        their outputs are masked). Updates the state; returns (the window's
        argmax tokens (B, Q), tokens emitted (B,), finished flags), on the
        device."""
        config, ecfg, st, params = self.config, self.ecfg, self.state, self.params
        b, dkv, q_len = self._b, config.d_kv, ecfg.spec_window
        L = ecfg.max_decode_len
        scale = config.softmax_scale
        emb = params["shared"]["embedding"]
        pos, cur, active = st.pos, st.cur_token, st.active
        draft = self._drafts()
        w_in = torch.cat([cur[:, None], draft], dim=1)            # (B, Q)
        x = emb[w_in].to(runtime.torch_dtype(config.dtype))
        q_pos = pos[:, None] + self._qrange[None, :]               # (B, Q)
        kpos = self._kpos
        in_win = ((kpos[None, :] >= pos[:, None])
                  & (kpos[None, :] < pos[:, None] + q_len))         # (B, L)
        row = (kpos[None, :] - pos[:, None]).clamp(0, q_len - 1)
        valid = kpos[None, None, :] <= q_pos[:, :, None]         # (B, Q, L)
        cross_valid = (self._cpos[None, :] < st.enc_len[:, None])[
            :, None, :].expand(-1, q_len, -1)
        bias = None

        for li, blk in enumerate(params["decoder"]["block"]):
            cache = st.layers[li]
            sa = blk["self_attention_layer"]["self_attention"]
            h = sa["Wq"].shape[1] // dkv
            normed = t5._layer_norm(
                config, blk["self_attention_layer"]["layer_norm"]["weight"], x)
            qh = kv_cache._proj_heads(normed, sa["Wq"], h, dkv)  # (B,H,Q,D)
            self._write_window(cache.self_k, kv_cache._proj_heads(
                normed, sa["Wk"], h, dkv), in_win, row)
            self._write_window(cache.self_v, kv_cache._proj_heads(
                normed, sa["Wv"], h, dkv), in_win, row)
            if li == 0:
                # each window row's bias row bucket(k - (pos + j)):
                # (B, H, Q, L)
                table = sa["pe_encoding"]["relative_attention_bias"].float()
                n_lut = self._spec_lut.shape[0]
                bias = table[self._spec_lut[
                    (kpos[None, None, :] - q_pos[:, :, None] + L
                     + q_len).clamp(0, n_lut - 1)].long()].permute(0, 3, 1, 2)
            attn = _window_attention(qh, _kv_read(cache.self_k),
                                     _kv_read(cache.self_v), bias, valid,
                                     scale, x.dtype)              # (B,Q,H,D)
            x = x + t5._matmul(attn.reshape(b, q_len, h * dkv), sa["o"])

            ca = blk["cross_attention_layer"]["cross_attention"]
            normed = t5._layer_norm(
                config, blk["cross_attention_layer"]["layer_norm"]["weight"],
                x)
            qc = kv_cache._proj_heads(normed, ca["Wq"], h, dkv)
            attn = _window_attention(qc, _kv_read(cache.cross_k),
                                     _kv_read(cache.cross_v), None,
                                     cross_valid, scale, x.dtype)
            x = x + t5._matmul(attn.reshape(b, q_len, h * dkv), ca["o"])
            x = t5._ff(config, blk["ff_layer"], x)

        x = t5._layer_norm(config, params["decoder"]["final_layer_norm"]["weight"],
                           x)
        if config.tie_word_embeddings:
            logits = torch.matmul(x, emb.T.to(x.dtype))
        else:
            logits = t5._matmul(x, params["lm_head"])
        g = torch.argmax(logits, dim=-1)                            # (B, Q)

        # acceptance: the confirmed prefix plus one, clipped to the budget,
        # stopped at the first EOS
        ok = torch.cumprod((draft == g[:, :-1]).long(), dim=1)
        n_emit = torch.minimum(ok.sum(dim=1) + 1, st.budget.clamp(min=1))
        within = self._qrange[None, :] < n_emit[:, None]
        eos_in = (g == config.eos_token_id) & within
        has_eos = eos_in.any(dim=-1)
        n_eff = torch.where(has_eos, eos_in.long().argmax(dim=-1) + 1, n_emit)
        n_eff = torch.where(active, n_eff, 0)
        st.budget = torch.where(active, st.budget - n_eff, st.budget)
        new_pos = pos + n_eff
        last = torch.gather(g, 1, (n_eff - 1).clamp(min=0)[:, None])[:, 0]
        before = torch.gather(g, 1, (n_eff - 2).clamp(min=0)[:, None])[:, 0]
        st.prev_token = torch.where(
            active & (n_eff >= 2), before,
            torch.where(active & (n_eff == 1), cur, st.prev_token))
        st.cur_token = torch.where(active & (n_eff > 0), last, cur)
        finished = active & (has_eos | (new_pos + 1 >= L) | (st.budget <= 0))
        st.pos = torch.where(active, new_pos, pos)
        st.active = active & ~finished
        return g, n_eff, finished

    def probe_step(self, token_override=None):
        """One decode step that also returns the (B, V) logits; optionally
        overrides cur_token first (teacher forcing). Mutates the state like
        a normal step. Returns numpy (next tokens, fp32 logits) of every
        slot."""
        cur = self.state.cur_token
        if token_override is not None:
            lo = self._data_rank * self._b
            cur = torch.as_tensor(np.array(token_override)[lo:lo + self._b],
                                  dtype=torch.int64, device=self.device)
        nxt, _, logits = self._step(cur)
        logits = self._gather_slots(self._gather_vocab(logits.float()))
        return (self._gather_slots(nxt).cpu().numpy(),
                logits.cpu().numpy())

    # -- collective hooks (the identity on one rank) -----------------------

    def _gather_slots(self, x: torch.Tensor) -> torch.Tensor:
        """x with every data rank's slots along its last slot dimension
        (dim 0 of a per-slot vector or matrix, the last of a window's
        (rows, k, B) outputs)."""
        return x

    def _gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, V) logits from this rank's (B, V/t) slice."""
        return logits

    def _visible(self, waiting: List[Request], t: float) -> int:
        """How many of the waiting requests (by arrival) have arrived at
        time t."""
        n = 0
        while n < len(waiting) and waiting[n].arrival_s <= t:
            n += 1
        return n

    def _window(self):
        """`steps_per_sync` decode steps (speculative windows with
        `spec_window` >= 2), queued without a host sync. Returns (host
        int64 outputs, ready event): (3, k, B) tokens/finished/was-active,
        or (Q + 3, k, B) for speculative windows, the Q argmax tokens, then
        tokens emitted/finished/was-active."""
        rows = []
        for _ in range(self.ecfg.steps_per_sync):
            was_active = self.state.active
            if self.ecfg.spec_window >= 2:
                g, n_eff, finished = self._spec_step()
                rows.append(torch.cat([g.T, torch.stack(
                    [n_eff, finished.long(), was_active.long()])]))
            else:
                nxt, finished, _ = self._step(self.state.cur_token)
                rows.append(torch.stack([nxt, finished.long(),
                                         was_active.long()]))
        out = self._gather_slots(torch.stack(rows, dim=1))
        if self.device.type != "cuda":
            return out, None
        if not self._host_bufs:
            self._host_bufs = [torch.empty(out.shape, dtype=out.dtype,
                                           pin_memory=True) for _ in range(2)]
        host = self._host_bufs[self._windows % 2]
        self._windows += 1
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def warmup(self, buckets=None) -> None:
        """Run every prefill variant (all power-of-two batch sizes per bucket)
        and one decode window once, so that kernel builds and Triton
        compilation happen before serving; leaves the pool idle."""
        st = self.state
        for bucket in buckets or self.ecfg.encode_buckets:
            nb = self._prefill_batch(1)
            while True:
                self._insert(self._encode(np.zeros((nb, bucket), np.int32)),
                             0, 0, bucket, 1)
                if nb >= self._prefill_batch(self.ecfg.max_slots):
                    break
                nb *= 2
        host, event = self._window()
        if event is not None:
            event.synchronize()
        st.active = torch.zeros_like(st.active)

    def admit_request(self, req: Request, slot: int) -> None:
        """Prefill + insert one request into `slot` without running the
        scheduler loop (pairs with probe_step)."""
        L = min(len(req.input_ids), self.ecfg.max_encode_len)
        bucket = bucket_for(self.ecfg.encode_buckets, L)
        padded = np.zeros((self._prefill_batch(1), bucket), np.int32)
        padded[0, :L] = req.input_ids[:L]
        self._insert(self._encode(padded), 0, slot, bucket,
                     min(req.max_new_tokens, self.ecfg.max_decode_len - 1))

    # -- host-side scheduler ----------------------------------------------
    #
    # Double-buffered dispatch, as in the JAX engine: while the budget
    # arithmetic says more windows are needed after the one in flight, the
    # next window is queued BEFORE the in-flight one's outputs are read, so
    # the host's harvest overlaps device work. When the in-flight window
    # finishes everything that is running, the scheduler harvests first
    # instead of queueing an idle window. Early EOS makes the arithmetic an
    # overestimate; the cost is at most one window of masked idle steps.

    def run(self, requests: List[Request],
            now: Callable[[], float] = None) -> List[Request]:
        """Serve all requests to completion; returns them with .result set
        (tokens WITHOUT the leading start token, EOS-terminated).

        Requests with arrival_s > 0 become visible only once that much time
        has passed since run() started; admitted_at / first_token_at /
        finished_at are stamped on the same clock."""
        now = now or time.perf_counter
        ecfg = self.ecfg
        t0 = now()
        waiting = sorted(requests, key=lambda r: r.arrival_s)
        queue: List[Request] = []
        slots: List[Optional[Request]] = [None] * ecfg.max_slots
        emitted: List[List[int]] = [[] for _ in range(ecfg.max_slots)]
        limits: List[int] = [0] * ecfg.max_slots
        eos = self.config.eos_token_id
        spec = ecfg.spec_window >= 2
        # tokens one queued window can emit a slot, at most
        window_credit = ecfg.steps_per_sync * (ecfg.spec_window if spec
                                               else 1)

        def refresh_queue():
            if waiting:
                n = self._visible(waiting, now() - t0)
                queue.extend(waiting[:n])
                del waiting[:n]

        def admit():
            refresh_queue()
            free = [i for i, s in enumerate(slots) if s is None]
            if not free or not queue:
                return
            take = queue[: len(free)]
            del queue[: len(take)]
            by_bucket: Dict[int, list] = {}
            for req in take:
                L = min(len(req.input_ids), ecfg.max_encode_len)
                by_bucket.setdefault(bucket_for(ecfg.encode_buckets, L),
                                     []).append((req, L))
            for bucket, items in by_bucket.items():
                # ONE batched encode for every same-bucket waiting request
                nb = self._prefill_batch(len(items))
                padded = np.zeros((nb, bucket), np.int32)
                for j, (req, L) in enumerate(items):
                    padded[j, :L] = req.input_ids[:L]
                cross = self._encode(padded)
                for j, (req, L) in enumerate(items):
                    i = free.pop(0)
                    # the cross length is the padded bucket (no mask), as
                    # the reference's unmasked cross-attention sees it
                    limits[i] = min(req.max_new_tokens,
                                    ecfg.max_decode_len - 1)
                    self._insert(cross, j, i, bucket, limits[i])
                    slots[i] = req
                    emitted[i] = []
                    req.admitted_at = now() - t0
                    if spec:
                        src = (req.input_ids if req.draft_source is None
                               else req.draft_source)
                        n = min(len(src), ecfg.max_encode_len)
                        row = np.zeros((ecfg.max_encode_len,), np.int64)
                        row[:n] = np.asarray(src[:n], np.int64)
                        self._draft[i] = torch.from_numpy(row).to(self.device)

        def harvest(pending):
            """Wait for one window's host copy and retire finished requests."""
            snapshot, _credit, host, event = pending
            if event is not None:
                event.synchronize()
            out = host.numpy().copy()
            # (Q, k, B) argmax tokens and the tokens each slot emitted, or
            # (1, k, B) tokens and one each
            toks_h, n_h, fins_h, act_h = (
                (out[:-3], out[-3], out[-2], out[-1]) if spec
                else (out[:1], np.ones_like(out[0]), out[1], out[2]))
            t_host = now() - t0
            finished_now = [False] * len(snapshot)
            for t in range(toks_h.shape[1]):
                any_active = False
                for i, req in enumerate(snapshot):
                    if req is None or finished_now[i] or not act_h[t, i]:
                        continue
                    any_active = True
                    n = int(n_h[t, i])
                    if n > 0 and not emitted[i]:
                        req.first_token_at = t_host
                    emitted[i].extend(int(v) for v in toks_h[:n, t, i])
                    if spec:
                        self.spec_stats["tokens"] += n
                        self.spec_stats["slot_windows"] += 1
                    if fins_h[t, i]:
                        finished_now[i] = True
                if spec and any_active:
                    self.spec_stats["windows"] += 1
            for i, req in enumerate(snapshot):
                if req is None or not finished_now[i]:
                    continue
                toks_l = list(emitted[i])
                if eos in toks_l:
                    toks_l = toks_l[: toks_l.index(eos) + 1]
                else:
                    # reference contract: the boundary position is forced
                    # to EOS (modeling_flash_t5.py:683)
                    toks_l[-1] = eos
                req.result = np.asarray(toks_l, np.int32)
                req.finished_at = now() - t0
                slots[i] = None

        pending = None
        admit()
        while True:
            if not any(s is not None for s in slots):
                if pending is not None:
                    harvest(pending)
                    pending = None
                    admit()
                    continue
                refresh_queue()
                if queue:
                    admit()
                    continue
                if waiting:
                    dt = waiting[0].arrival_s - (now() - t0)
                    if dt > 0:
                        time.sleep(min(dt, 0.02))
                    continue
                break
            # decode steps still needed after every queued window lands
            rem = 0
            for i, req in enumerate(slots):
                if req is None:
                    continue
                credit = pending[1].get(i, 0) if pending is not None else 0
                rem = max(rem, limits[i] - len(emitted[i]) - credit)
            if pending is not None and rem <= 0:
                harvest(pending)
                pending = None
                admit()
                continue
            host, event = self._window()
            snapshot = list(slots)
            credit = {i: window_credit for i, s in enumerate(slots)
                      if s is not None}
            if pending is not None:
                harvest(pending)
            pending = (snapshot, credit, host, event)
            admit()
        return requests
