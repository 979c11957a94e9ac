"""Continuous-batching engine over a paged decoder KV cache.

The PyTorch counterpart of `flasht5_tpu/inference/paged_engine.py`. The slot
engine (`engine.py`) gives every slot `max_decode_len` positions of cache;
this engine keeps each layer's decoder self-attention K/V in a page pool
(`paged_kv.py`), so memory scales with the tokens in flight and requests of
mixed lengths pack densely. Cross-attention K/V stay slot-dense (written
once per request at prefill) and are read by plain PyTorch attention, as
the JAX engine reads them with a plain einsum.

The scheduler is the JAX engine's: bucketed batched prefill, lockstep decode
windows of `steps_per_sync` steps, then harvest and admission between
windows (one window in flight; the slot engine's double-buffered dispatch
is not used here). Pages are allocated on the host between windows; the
host's page table is shipped to the device once a window.

Decode paths:
- `kernel="chunked"` with `window_appends` (the default): each step's new
  K/V go to a dense per-window side buffer; attention is the paged kernel
  over the pages committed before the window, with its softmax state,
  merged by log-sum-exp with plain attention over the side buffer; the
  window's tokens are written to the pages once, at its end.
- `kernel="dense"` / `"ragged"`, or `"chunked"` with `window_appends=False`:
  every step appends its K/V to the pages and runs the kernel over them.
Every route keeps each layer's pool as fused K/V page records and reaches
the one paged kernel; the three names are kept so that JAX configurations
carry over, and choose only between the window and the per-step path.

The JAX engine's two opt-ins (off by default; measured slower than the
kernel on a TPU) read the committed pages without the kernel, in plain
PyTorch as they are plain XLA there; each is chosen at construction, as
JAX chooses it at trace time:
- `dense_read_max`: where a slot's pool (max_pages_per_slot x page_size
  tokens) is at most this many tokens, `paged_kv.dense_small_pool_attention`
  gathers the slots' pages through the table and attends over them
  (both paths, kernel="chunked");
- `window_stage_max_bytes`: where the window's staged caches fit in this
  many bytes, each layer's committed pages are gathered once a window into
  slot-dense caches in the pool's dtype (`gather_pool_dense(...,
  dequant=False)`) and each step reads them with `dense_cache_attention`
  (the window path).

The device work is shard-oblivious, as the slot engine's is (engine.py):
this rank's slots and heads, the o-projections through the model's
row-parallel product, the next token from the vocab-parallel argmax under
tensor parallelism; `sharded_paged_engine.ShardedPagedEngine` gives each
data rank a pool of its own.

Where the JAX engine donates its state, this one writes the pools, the
cross caches and the side buffers in place. Every write of a token that is
not live (an inactive slot's step, the unused columns of a window) goes to a
trash page (index `num_pages`, never allocated): a slot's table row may name
pages that now belong to another slot, and PyTorch does not define which of
two writes to one place wins. The JAX engine skips the kernel while no slot
has committed tokens (`lax.cond` on the device); here the host, which
harvests every window, knows each slot's committed count and skips the
launch without reading the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flasht5_tpu_torch import positional, runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.inference import kv_cache, paged_kv
from flasht5_tpu_torch.inference.engine import (KVTensor, Request, _kv_make,
                                                _kv_read, bucket_for,
                                                encode_cross, local_heads,
                                                prefill_batch)
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.utils.profiling import span

_NEG_INF = -1e30


@dataclasses.dataclass
class PagedEngineConfig:
    max_slots: int = 8
    page_size: int = 16
    num_pages: int = 64               # shared per-layer pool size
    max_pages_per_slot: int = 8
    max_encode_len: int = 512
    encode_buckets: Tuple[int, ...] = (64, 128, 256, 512)
    kv_dtype: str = "native"          # pages + cross cache: "native" | "int8"
    steps_per_sync: int = 8
    # "chunked" (default) takes the window path when window_appends is on;
    # "ragged" and "dense" (TPU kernels there) take the per-step path. All
    # three read the same fused pool with the one paged kernel.
    kernel: str = "chunked"
    # the width (in pages) of a TPU work item of the chunked kernel; kept so
    # that JAX configurations carry over, unused by the card's kernel
    pages_per_item: int = 8
    # the JAX opt-ins, off by default (module docstring): read the
    # committed pages with one gather where a slot's pool holds at most
    # this many tokens; stage them once a window where the staged caches
    # take at most this many bytes
    dense_read_max: int = 0
    window_appends: bool = True
    window_stage_max_bytes: int = 0


class PagedState:
    """Device pools, cross caches and per-slot scalars of `slots` slots (all
    of them, or a data rank's) and the heads the parameters hold; the host
    allocator and its page table (`pages`) of every slot, with a free list
    for each of `shards` data ranks' pools."""

    def __init__(self, config: FlashT5Config, params, ecfg: PagedEngineConfig,
                 device: torch.device, slots: Optional[int] = None,
                 shards: int = 1):
        b, h, dkv = (slots or ecfg.max_slots, local_heads(config, params),
                     config.d_kv)
        P = ecfg.page_size
        quant = ecfg.kv_dtype == "int8"
        dt = torch.int8 if quant else runtime.torch_dtype(config.dtype)
        # + the trash page (index num_pages, never allocated)
        n = ecfg.num_pages + 1

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        def cross():
            return KVTensor(zeros((b, h, ecfg.max_encode_len, dkv), dt),
                            zeros((b, h, ecfg.max_encode_len, 1),
                                  torch.float32) if quant else None)

        self.layers = []
        for _ in params["decoder"]["block"]:
            pages_kv = KVTensor(
                zeros((n, 2, h, P, dkv), dt),
                zeros((n, 2, h, P), torch.float32) if quant else None)
            self.layers.append({"cross_k": cross(), "cross_v": cross(),
                                "pages_kv": pages_kv,
                                "planes": _planes(pages_kv)})
        # the allocator writes its host table, each window ships it
        self.pages = paged_kv.PageAllocator(ecfg.num_pages, ecfg.max_slots,
                                            ecfg.max_pages_per_slot, shards)

        def slots(dtype):
            return zeros((b,), dtype)

        self.enc_len = slots(torch.int32)
        self.pos = slots(torch.int64)
        self.cur_token = slots(torch.int64)
        self.active = slots(torch.bool)
        self.budget = slots(torch.int64)


def _planes(pages_kv: KVTensor) -> Tuple[KVTensor, KVTensor]:
    """The K and V planes of a fused pool as (N, H, P, D) value and
    (N, H, P) scale views."""
    vals, scales = pages_kv
    return tuple(KVTensor(vals[:, i], None if scales is None else scales[:, i])
                 for i in (0, 1))


def _stage_read(values: torch.Tensor,
                scales: Optional[torch.Tensor]) -> torch.Tensor:
    """One staged cache plane (values in the pool's dtype, scales or None)
    in f32 (JAX paged_engine.py:42)."""
    x = values.float()
    return x if scales is None else x * scales


def _write_tokens(plane: KVTensor, pids, offsets, values, scales) -> None:
    """plane[pids, :, offsets] = values (..., H, D) and its scales (..., H),
    in place."""
    plane.values[pids, :, offsets] = values.to(plane.values.dtype)
    if plane.scales is not None:
        plane.scales[pids, :, offsets] = scales


class PagedInferenceEngine:
    """Greedy continuous batching with a paged decoder KV cache.

        engine = PagedInferenceEngine(config, params, PagedEngineConfig(...))
        done = engine.run(requests)   # each request's .result is set

    Runs on `device` (default `cuda`; raises without a GPU unless
    device='cpu'), where `params` must already lie. With `config.tp_axis`
    the model's collectives need a current mesh (`parallel.mesh.use_mesh`):
    `sharded_paged_engine.ShardedPagedEngine` sets one up.
    """

    # data ranks the slots split over, and this rank's index among them
    # (set by the sharded subclass before this constructor runs)
    _data, _data_rank = 1, 0

    def __init__(self, config: FlashT5Config, params, ecfg: PagedEngineConfig,
                 device=None):
        t5.check_supported(config)
        if config.position_encoding_type != "t5":
            # the JAX package's engine builds only the T5 bias
            # (flasht5_tpu/inference/paged_engine.py:367 and :553) and
            # serves the other encodings with no position signal at all
            raise NotImplementedError(
                f"PagedInferenceEngine serves the T5 relative bias only, not "
                f"{config.position_encoding_type}")
        if ecfg.kernel not in ("chunked", "ragged", "dense"):
            raise ValueError(f"unknown kernel {ecfg.kernel!r}")
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
        self.state = PagedState(config, params, ecfg, self.device, self._b,
                                self._data)
        self._windowed = ecfg.kernel == "chunked" and ecfg.window_appends
        dev = self.device
        k = ecfg.steps_per_sync
        self._max_len = maxL = ecfg.max_pages_per_slot * ecfg.page_size
        h, dkv = local_heads(config, params), config.d_kv
        # the opt-ins' readers, chosen here as JAX chooses them at trace
        # time (JAX paged_engine.py:262-278; its staged bytes count 2 a
        # value for any native dtype)
        self._dense_read = (ecfg.kernel == "chunked"
                            and 0 < ecfg.dense_read_max
                            and maxL <= ecfg.dense_read_max)
        staged = (ecfg.max_slots * config.num_heads * maxL
                  * (dkv * (1 if ecfg.kv_dtype == "int8" else 2) + 4) * 2)
        self._window_stage = (self._windowed
                              and 0 < staged <= ecfg.window_stage_max_bytes)
        self._slots = torch.arange(self._b, device=dev)
        self._kpos = torch.arange(maxL, device=dev)
        self._cpos = torch.arange(ecfg.max_encode_len, device=dev)
        self._steps = torch.arange(k, device=dev)
        buckets = dict(bidirectional=False,
                       num_buckets=config.relative_attention_num_buckets,
                       max_distance=config.relative_attention_max_distance,
                       device=dev)
        # bucket of every paged offset k - pos, pos in [0, maxL]
        self._self_lut = positional.bucket_lut(-maxL, maxL - 1, **buckets)
        table = (params["decoder"]["block"][0]["self_attention_layer"]
                 ["self_attention"]["pe_encoding"]["relative_attention_bias"])
        self._bias_table = table.float()
        # the side buffer's bias at step t: its keys lie at base..base+t,
        # the query at base+t, so offsets j - t for j <= t, the same row for
        # every slot: (1, H, t + 1)
        side_lut = positional.bucket_lut(-(k - 1), 0, **buckets)
        self._side_bias = [
            self._bias_table[side_lut[k - 1 - t:].long()].T[None].contiguous()
            for t in range(k)]
        b = self._b
        self._empty_state = (
            torch.zeros((b, h, dkv), device=dev),
            torch.full((b, h), _NEG_INF, device=dev),
            torch.zeros((b, h), device=dev))
        self._side = None
        if self._windowed:
            quant = ecfg.kv_dtype == "int8"
            sdt = torch.int8 if quant else runtime.torch_dtype(config.dtype)

            def side():
                return KVTensor(
                    torch.zeros((b, h, k, dkv), dtype=sdt, device=dev),
                    torch.zeros((b, h, k, 1), device=dev) if quant else None)
            # written in place column by column; a window reads only the
            # columns it has written
            self._side = [(side(), side()) for _ in self.state.layers]

    # -- prefill -----------------------------------------------------------

    def _prefill_batch(self, n: int) -> int:
        """The rows of a prefill batch of n requests."""
        return prefill_batch(n, self.ecfg.max_slots)

    def _encode(self, ids: np.ndarray):
        """Each decoder layer's cross K/V of a prefill batch (nb, bucket)."""
        return encode_cross(self.config, self.params, ids, self.device)

    def _gather_slots(self, x: torch.Tensor) -> torch.Tensor:
        """A window's (3, k, B) outputs with every data rank's slots."""
        return x

    def _insert(self, cross, row: int, slot: int, bucket_len: int,
                max_new: int) -> None:
        """Write row `row` of a batched prefill into slot `slot` and reset
        the slot (in place), on the data rank that owns it."""
        slot -= self._data_rank * self._b
        if not 0 <= slot < self._b:
            return
        st, ecfg = self.state, self.ecfg
        quant = ecfg.kv_dtype == "int8"
        for layer, kvs in zip(st.layers, cross):
            for name, new in zip(("cross_k", "cross_v"), kvs):
                pad = ecfg.max_encode_len - new.shape[2]
                newq = _kv_make(F.pad(new[row], (0, 0, 0, pad)), quant)
                cache = layer[name]
                cache.values[slot] = newq.values.to(cache.values.dtype)
                if cache.scales is not None:
                    cache.scales[slot] = newq.scales
        st.enc_len[slot] = bucket_len
        st.pos[slot] = 0
        st.cur_token[slot] = 0          # decoder start token
        st.active[slot] = True
        st.budget[slot] = max_new

    def warmup(self, buckets=None) -> None:
        """Run every prefill variant (all power-of-two batch sizes per
        bucket) once, through slot 0; leaves the pool idle."""
        st = self.state
        for bucket in buckets or self.ecfg.encode_buckets:
            nb = self._prefill_batch(1)
            while True:
                self._insert(self._encode(np.zeros((nb, bucket), np.int32)),
                             0, 0, bucket, 1)
                if nb >= self._prefill_batch(self.ecfg.max_slots):
                    break
                nb *= 2
        st.active.zero_()
        st.pos.zero_()

    # -- decode ------------------------------------------------------------

    def _self_bias(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, H, maxL) f32 T5 bias of each slot's query at `pos` over every
        paged position."""
        rel = self._kpos[None, :] - pos[:, None] + self._max_len
        return self._bias_table[self._self_lut[rel].long()] \
            .permute(0, 2, 1).contiguous()

    def _step(self, self_attention) -> torch.Tensor:
        """One lockstep decode step for all slots (inactive slots run too;
        their outputs are masked). `self_attention(li, q, k_new, v_new)`
        gives layer li's (B, H, D) self-attention from q (B, H, D) f32 and
        stores the step's K/V. Updates the state; returns (3, B) int64:
        next token, finished flag, was-active flag."""
        config, st, params = self.config, self.state, self.params
        b, dkv, group = self._b, config.d_kv, self._group
        scale = config.softmax_scale
        emb = params["shared"]["embedding"]
        x = emb[st.cur_token].to(runtime.torch_dtype(config.dtype))[:, None, :]
        cross_valid = (self._cpos[None, :]
                       < st.enc_len[:, None])[:, None, None, :]

        for li, blk in enumerate(params["decoder"]["block"]):
            layer = st.layers[li]
            sa = blk["self_attention_layer"]["self_attention"]
            h = sa["Wq"].shape[1] // dkv
            normed = t5._layer_norm(
                config, blk["self_attention_layer"]["layer_norm"]["weight"], x)
            q, k_new, v_new = (
                kv_cache._proj_heads(normed, sa[w], h, dkv)[:, :, 0]
                for w in ("Wq", "Wk", "Wv"))
            attn = self_attention(li, q.float(), k_new, v_new)
            x = x + t5._row_parallel_matmul(
                config, group, attn.to(x.dtype).reshape(b, 1, h * dkv),
                sa["o"])

            ca = blk["cross_attention_layer"]["cross_attention"]
            normed = t5._layer_norm(
                config, blk["cross_attention_layer"]["layer_norm"]["weight"],
                x)
            qc = kv_cache._proj_heads(normed, ca["Wq"], h, dkv)
            s = torch.einsum("bhqd,bhnd->bhqn", qc.float(),
                             _kv_read(layer["cross_k"])) * scale
            s = torch.where(cross_valid, s, _NEG_INF)
            attn = torch.einsum("bhqn,bhnd->bhqd", torch.softmax(s, -1),
                                _kv_read(layer["cross_v"])).to(x.dtype)
            x = x + t5._row_parallel_matmul(
                config, group, attn.transpose(1, 2).reshape(b, 1, h * dkv),
                ca["o"])
            x = t5._ff(config, blk["ff_layer"], x)

        x = t5._layer_norm(config, params["decoder"]["final_layer_norm"]["weight"],
                           x)
        if config.tie_word_embeddings:
            logits = torch.matmul(x, emb.T.to(x.dtype))[:, 0]
        else:
            logits = t5._matmul(x, params["lm_head"])[:, 0]
        if group is not None and not config.tie_word_embeddings:
            from flasht5_tpu_torch.parallel.vocab_parallel import (
                vocab_parallel_next_token)
            nxt = vocab_parallel_next_token(logits, group)
        else:
            nxt = torch.argmax(logits, dim=-1)

        active, pos = st.active, st.pos
        st.budget = torch.where(active, st.budget - 1, st.budget)
        out_of_room = (pos + 1 >= self._max_len) | (st.budget <= 0)
        finished = active & ((nxt == config.eos_token_id) | out_of_room)
        st.cur_token = torch.where(active, nxt, st.cur_token)
        st.pos = torch.where(active, pos + 1, pos)
        st.active = active & ~finished
        return torch.stack([nxt, finished.long(), active.long()])

    def _paged_step(self, page_table: torch.Tensor) -> torch.Tensor:
        """A step that appends its K/V to the pages and reads them back with
        the kernel (kernel="dense"/"ragged", or window_appends=False)."""
        ecfg, st = self.ecfg, self.state
        P = ecfg.page_size
        pos = st.pos
        pids = torch.where(
            st.active,
            page_table[self._slots, (pos // P).clamp(max=page_table.shape[1]
                                                     - 1)].long(),
            ecfg.num_pages)
        offset = pos % P
        lengths = (pos + 1).to(torch.int32)
        bias = self._self_bias(pos)

        def self_attention(li, q, k_new, v_new):
            layer = st.layers[li]
            for plane, new in zip(layer["planes"], (k_new, v_new)):
                newq = _kv_make(new, plane.scales is not None)
                _write_tokens(plane, pids, offset, newq.values,
                              None if newq.scales is None
                              else newq.scales[..., 0])
            read = (paged_kv.dense_small_pool_attention if self._dense_read
                    else paged_kv.paged_decode_attention_chunked_packed)
            return read(q, *layer["pages_kv"], page_table, lengths,
                        sm_scale=self.config.softmax_scale, bias=bias)

        return self._step(self_attention)

    def _window_step(self, t: int, page_table: torch.Tensor,
                     base: torch.Tensor, committed: bool,
                     staged=None) -> torch.Tensor:
        """Step t of a window: new K/V to side-buffer column t; attention =
        the paged kernel over the committed pages (lengths `base`; skipped
        when `committed` is False, as its empty state gives the same
        merge), or the opt-ins' reader (`staged`: each layer's staged
        caches), LSE-merged with attention over side columns 0..t."""
        ecfg, st = self.ecfg, self.state
        scale = self.config.softmax_scale
        quant = ecfg.kv_dtype == "int8"
        bias = self._self_bias(st.pos) if committed else None
        side_bias = self._side_bias[t]

        def self_attention(li, q, k_new, v_new):
            side_k, side_v = self._side[li]
            for side, new in ((side_k, k_new), (side_v, v_new)):
                newq = _kv_make(new, quant)
                side.values[:, :, t] = newq.values.to(side.values.dtype)
                if quant:
                    side.scales[:, :, t] = newq.scales
            if committed and staged is not None:
                (kv_, ks), (vv, vs) = staged[li]
                out_p, m_p, l_p = paged_kv.dense_cache_attention(
                    q, _stage_read(kv_, ks), _stage_read(vv, vs), base,
                    sm_scale=scale, bias=bias, return_state=True)
            elif committed:
                layer = st.layers[li]
                read = (paged_kv.dense_small_pool_attention
                        if self._dense_read
                        else paged_kv.paged_decode_attention_chunked_packed)
                out_p, m_p, l_p = read(
                    q, layer["pages_kv"].values, layer["pages_kv"].scales,
                    page_table, base, sm_scale=scale, bias=bias,
                    return_state=True)
            else:
                out_p, m_p, l_p = self._empty_state
            skf = side_k.values[:, :, :t + 1].float()
            if quant:
                skf = skf * side_k.scales[:, :, :t + 1]
            s = torch.einsum("bhd,bhtd->bht", q, skf) * scale + side_bias
            m_s = s.amax(dim=-1)
            p = torch.exp(s - m_s[..., None])
            l_s = p.sum(dim=-1)
            if quant:
                p = p * side_v.scales[:, :, :t + 1, 0]
            o_s = torch.einsum("bht,bhtd->bhd", p,
                               side_v.values[:, :, :t + 1].float())
            m_c = torch.maximum(m_p, m_s)
            w_p = torch.exp(m_p - m_c) * l_p
            w_s = torch.exp(m_s - m_c)
            return ((out_p * w_p[..., None] + o_s * w_s[..., None])
                    / (w_p + w_s * l_s)[..., None])

        return self._step(self_attention)

    def _flush(self, page_table: torch.Tensor, base: torch.Tensor) -> None:
        """Commit the window's side-buffer tokens to the pages, in place:
        column i of slot b is token base[b] + i, live while i < the slot's
        steps this window; every other column goes to the trash page."""
        ecfg, st = self.ecfg, self.state
        P = ecfg.page_size
        cnt = st.pos - base
        tok = base[:, None] + self._steps[None, :]                 # (B, k)
        live = (self._steps[None, :] < cnt[:, None]) & (tok < self._max_len)
        page = page_table.long().gather(
            1, (tok // P).clamp(max=page_table.shape[1] - 1))
        pids = torch.where(live, page, ecfg.num_pages)
        offsets = tok % P
        for layer, sides in zip(st.layers, self._side):
            for plane, side in zip(layer["planes"], sides):
                _write_tokens(plane, pids, offsets,
                              side.values.transpose(1, 2),
                              None if side.scales is None
                              else side.scales[..., 0].transpose(1, 2))

    def _window(self, released: np.ndarray,
                committed: np.ndarray) -> np.ndarray:
        """`steps_per_sync` decode steps. `released`: host mask of slots
        whose device pos is zeroed first; `committed`: host mask of slots
        with tokens in the pages (where none of this rank's has, the window
        reads no pages). Both, and the page table, are of every slot; this
        rank takes its own slots' rows. Returns host (3, k, B) int64 tokens
        / finished / was-active of every slot."""
        st = self.state
        dev = self.device
        lo = self._data_rank * self._b
        mine = slice(lo, lo + self._b)
        st.pos = torch.where(torch.as_tensor(released[mine], device=dev), 0,
                             st.pos)
        page_table = torch.from_numpy(st.pages.table[mine]).to(dev)
        if self._windowed:
            committed = bool(committed[mine].any())
            base = st.pos
            base32 = base.to(torch.int32)
            staged = None
            if committed and self._window_stage:
                staged = [paged_kv.gather_pool_dense(
                    *layer["pages_kv"], page_table, dequant=False)
                    for layer in st.layers]
            rows = [self._window_step(t, page_table, base32, committed,
                                      staged)
                    for t in range(self.ecfg.steps_per_sync)]
            self._flush(page_table, base)
        else:
            rows = [self._paged_step(page_table)
                    for _ in range(self.ecfg.steps_per_sync)]
        return self._gather_slots(torch.stack(rows, dim=1)).cpu().numpy()

    # -- host scheduler ----------------------------------------------------

    def run(self, requests: List[Request],
            now: Callable[[], float] = None) -> List[Request]:
        """Serve all requests to completion; returns them with .result set
        (tokens WITHOUT the leading start token, EOS-terminated), and
        admitted_at / first_token_at / finished_at stamped in seconds since
        run() started on `now` (default `time.perf_counter`), as the slot
        engine stamps them. `deferrals` counts the admissions this run put
        off because the head of the queue did not fit the free pages while
        a slot was free.

        Spans (`utils/profiling.py`): `paged.run` around it all;
        `paged.admit` with a `paged.encode` (`rows`, `bucket`) a prefill
        batch and a `paged.insert` (`uid`) a request admitted;
        `paged.window` (`steps`, `tokens`: the slot-steps that emitted a
        token); `paged.schedule`, the harvest after each window."""
        now = now or time.perf_counter
        t0 = now()
        with span("paged.run"):
            return self._serve(requests, now, t0)

    def _serve(self, requests: List[Request], now, t0: float) -> List[Request]:
        ecfg = self.ecfg
        self.deferrals = 0
        queue = list(requests)
        slots: List[Optional[Request]] = [None] * ecfg.max_slots
        emitted: List[List[int]] = [[] for _ in range(ecfg.max_slots)]
        st = self.state
        P = ecfg.page_size
        eos = self.config.eos_token_id

        def admit():
            with span("paged.admit"):
                # free every finished slot's pages BEFORE fitting new
                # requests; a released slot's device pos is zeroed by the
                # next window, from the host's `released` mask
                for i in range(ecfg.max_slots):
                    if slots[i] is None:
                        st.pages.release(i)
                # FIFO, reserving pages as it goes: an oversubscribed pool
                # defers at the first request that does not fit
                take = []
                for i in range(ecfg.max_slots):
                    if slots[i] is not None or not queue:
                        continue
                    req = queue[0]
                    max_new = min(req.max_new_tokens,
                                  ecfg.max_pages_per_slot * P - 1)
                    if not st.pages.can_allocate(i, max_new + 1, P):
                        if not any(s is not None for s in slots) \
                                and not take:
                            raise RuntimeError(
                                "request %r needs %d tokens of KV but the "
                                "whole pool is %d pages x %d" %
                                (req.uid, max_new + 1, ecfg.num_pages, P))
                        self.deferrals += 1
                        break
                    queue.pop(0)
                    st.pages.ensure_capacity(i, max_new + 1, P)
                    take.append((req, i, max_new))
                # one batched encode per bucket for everything admitted now
                by_bucket: Dict[int, list] = {}
                for req, i, max_new in take:
                    L = min(len(req.input_ids), ecfg.max_encode_len)
                    bucket = bucket_for(ecfg.encode_buckets, L)
                    by_bucket.setdefault(bucket, []).append(
                        (req, i, max_new, L))
                for bucket, items in by_bucket.items():
                    nb = self._prefill_batch(len(items))
                    padded = np.zeros((nb, bucket), np.int32)
                    for j, (req, i, max_new, L) in enumerate(items):
                        padded[j, :L] = req.input_ids[:L]
                    with span("paged.encode", rows=nb, bucket=bucket):
                        cross = self._encode(padded)
                    for j, (req, i, max_new, L) in enumerate(items):
                        with span("paged.insert", uid=req.uid):
                            self._insert(cross, j, i, bucket, max_new)
                        slots[i] = req
                        emitted[i] = []
                        req.admitted_at = now() - t0

        admit()
        while any(s is not None for s in slots):
            released = np.array([s is None for s in slots])
            # a live slot's committed tokens are the tokens it has emitted
            committed = np.array([s is not None and bool(emitted[i])
                                  for i, s in enumerate(slots)])
            with span("paged.window", steps=ecfg.steps_per_sync) as sp:
                toks_h, fins_h, act_h = self._window(released, committed)
                if sp:
                    sp.set(tokens=int(act_h.sum()))
            with span("paged.schedule"):
                t_host = now() - t0
                finished_now = [False] * len(slots)
                for t in range(toks_h.shape[0]):
                    for i, req in enumerate(slots):
                        if req is None or finished_now[i] or \
                                not act_h[t, i]:
                            continue
                        if not emitted[i]:
                            req.first_token_at = t_host
                        emitted[i].append(int(toks_h[t, i]))
                        if fins_h[t, i]:
                            finished_now[i] = True
                for i, req in enumerate(slots):
                    if req is None or not finished_now[i]:
                        continue
                    toks = list(emitted[i])
                    if eos in toks:
                        toks = toks[:toks.index(eos) + 1]
                    else:
                        toks[-1] = eos     # the boundary position is forced
                    req.result = np.asarray(toks, np.int32)
                    req.finished_at = t_host
                    slots[i] = None
            admit()
        return requests
