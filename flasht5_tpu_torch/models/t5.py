"""T5 v1.1 encoder-decoder in PyTorch: parameters, blocks, `encode`,
`forward` with the loss, and `model_forward`.

The counterpart of `flasht5_tpu/models/t5.py`. The parameter tree is a
nested dict (blocks in lists) with the JAX package's key names, so a JAX tree
carries across one-to-one (convert/from_jax.py):

    shared.embedding
    {encoder,decoder}.block.<i>.self_attention_layer.self_attention.{Wq,Wk,Wv,o}
    {encoder,decoder}.block.<i>.self_attention_layer.layer_norm.weight
    decoder.block.<i>.cross_attention_layer.cross_attention.{Wq,Wk,Wv,o}
    {encoder,decoder}.block.<i>.ff_layer.act.{wi | wi_0,wi_1}
    {encoder,decoder}.block.<i>.ff_layer.{wo, layer_norm.weight}
    {encoder,decoder}.block.0...self_attention.pe_encoding.relative_attention_bias
        (T5; FIRE's block 0 holds pe_encoding.{mlp.{w1,b1,w2,b2}, c,
        L_multiplier, init_L} instead; ALiBi and RoPE have no pe_encoding)
    {encoder,decoder}.final_layer_norm.weight
    lm_head

Linear weights are stored (in, out), applied as `x @ W`. The four positional
encodings run as in the JAX package. The T5 bias, ALiBi and FIRE are
additive biases that block 0 builds and every later block reuses, on `ref`
(plain attention on the materialized bias) and `pallas` (the bias kernels
of `ops/flash_attention.py`; FIRE's MLP trains through their dbias); the T5
bias also runs on `pallas_rpe` (the bucket table inside the RPE kernels).
RoPE rotates q and k (and v, `rope_rotate_v`) in every attention layer,
cross-attention included, and runs the kernels without a bias.
`use_randomized_position_encoding` draws sorted random positions below
`max_sequence_length` from the caller's generator: the bias's once, at
block 0 (FIRE ignores them, as the JAX package does), RoPE's once a layer
and only in training; `pallas_rpe` keeps the plain positions, as in the
JAX package. `use_full_bias_size` and `use_masking` behave as in the JAX
package (the padding mask folded into the bias as query rows; on
`pallas_rpe` the post-kernel select). Gradients come from autograd, through
the kernels' backward where the path has one (`rms_norm`, attention,
cross-entropy, the fused lm_head+CE).
Dropout, attention dropout (`ref` only: the JAX package's `pallas` branch
ignores `attention_dropout_rate`, and so does the port's) and randomized
positions draw from a `torch.Generator` the caller passes down; its bits are
not the JAX package's. `remat` recomputes each block in the backward pass
(`torch.utils.checkpoint`), with the same draws.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from flasht5_tpu_torch import positional, runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.ops.attn_ref import attn_ref
from flasht5_tpu_torch.ops.cross_entropy import (cross_entropy_loss,
                                                 cross_entropy_loss_ref)
from flasht5_tpu_torch.ops.flash_attention import flash_attention
from flasht5_tpu_torch.ops.flash_attention_rpe import flash_attention_rpe
from flasht5_tpu_torch.ops.fused_linear_ce import fused_linear_cross_entropy
from flasht5_tpu_torch.ops.quant import QuantizedTensor, quant_matmul
from flasht5_tpu_torch.ops.rmsnorm import rms_norm, rms_norm_ref

Params = Dict[str, Any]


def check_supported(config: FlashT5Config) -> None:
    """Raise unless `config.tp_axis` (if set) names a dimension of the
    current mesh (`parallel.mesh.use_mesh`), whose process group the
    tensor-parallel model's collectives run over."""
    _tp_group(config)


def _tp_group(config: FlashT5Config):
    """The tensor group (None without tensor parallelism)."""
    if config.tp_axis is None:
        return None
    from flasht5_tpu_torch.parallel.mesh import axis_group
    return axis_group(config.tp_axis)


def _to_columns(group, x: torch.Tensor) -> torch.Tensor:
    """The input of a column-split product: Megatron's identity forward
    with the gradient all-reduced over the tensor group."""
    if group is None:
        return x
    from flasht5_tpu_torch.parallel.collective_matmul import (
        copy_to_tensor_group)
    return copy_to_tensor_group(x, group)


def _row_parallel_matmul(config: FlashT5Config, group, x: torch.Tensor,
                         w) -> torch.Tensor:
    """x @ w, w split by row under tensor parallelism, summed over the
    tensor group (JAX t5.py:217-238): an all-reduce, or with
    `use_collective_matmul` the ring reduce-scatter and an all-gather,
    where the token count splits over the group (else the all-reduce, as
    the JAX model falls back)."""
    if group is None:
        return _matmul(x, w)
    from flasht5_tpu_torch.parallel import collective_matmul as cm
    lead, k = x.shape[:-1], x.shape[-1]
    m = x.numel() // k
    t = torch.distributed.get_world_size(group)
    if config.use_collective_matmul and t > 1 and m % t == 0:
        out = cm.row_parallel_ring(x.reshape(m, k), w, group)
        return out.reshape(*lead, out.shape[-1])
    return cm.reduce_from_tensor_group(_matmul(x, w), group)


def tree_leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the JAX package's flatten order (dict keys sorted,
    lists in order), each path written as `jax.tree_util.keystr` writes it,
    e.g. "['encoder']['block'][0]['ff_layer']['wo']"."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves_with_path(tree[key],
                                                  f"{prefix}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, node in enumerate(tree)
                for leaf in tree_leaves_with_path(node, f"{prefix}[{i}]")]
    return [(prefix, tree)]


# ===========================================================================
# Initialization (T5 scheme, reference: modeling_flash_t5.py:479-504)
# ===========================================================================

class _Init:
    def __init__(self, config: FlashT5Config, seed: int, device):
        self.config = config
        self.device = device
        self.dtype = runtime.torch_dtype(config.param_dtype)
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def normal(self, shape, std):
        w = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device) * std
        return w.to(self.dtype)

    def ones(self, n):
        return torch.full((n,), self.config.initializer_factor,
                          dtype=self.dtype, device=self.device)

    def attention(self, has_pe: bool) -> Params:
        c = self.config
        f, d, dkv = c.initializer_factor, c.d_model, c.d_kv
        inner = c.num_heads * dkv
        p = {
            "Wq": self.normal((d, inner), f * (d * dkv) ** -0.5),
            "Wk": self.normal((d, inner), f * d ** -0.5),
            "Wv": self.normal((d, inner), f * d ** -0.5),
            "o": self.normal((inner, d), f * inner ** -0.5),
        }
        # ALiBi and RoPE carry no learnable parameters
        if has_pe and c.position_encoding_type == "t5":
            p["pe_encoding"] = positional.init_relative_bias_params(
                self.gen, c.relative_attention_num_buckets, c.num_heads,
                initializer_factor=f, d_model=d, dtype=self.dtype,
                device=self.device)
        elif has_pe and c.position_encoding_type == "FIRE":
            p["pe_encoding"] = positional.init_fire_params(
                self.gen, c.num_heads, c.fire_mlp_width, init_c=0.1,
                init_L=float(c.relative_attention_max_distance),
                dtype=self.dtype, device=self.device)
        return p

    def ff(self) -> Params:
        c = self.config
        f, d, dff = c.initializer_factor, c.d_model, c.d_ff
        if c.use_glu_mlp:
            act = {"wi_0": self.normal((d, dff), f * d ** -0.5),
                   "wi_1": self.normal((d, dff), f * d ** -0.5)}
        else:
            act = {"wi": self.normal((d, dff), f * d ** -0.5)}
        return {"act": act, "wo": self.normal((dff, d), f * dff ** -0.5),
                "layer_norm": {"weight": self.ones(d)}}

    def block(self, is_decoder: bool, has_pe: bool) -> Params:
        d = self.config.d_model
        block = {
            "self_attention_layer": {
                "self_attention": self.attention(has_pe),
                "layer_norm": {"weight": self.ones(d)},
            },
            "ff_layer": self.ff(),
        }
        if is_decoder:
            block["cross_attention_layer"] = {
                "cross_attention": self.attention(False),
                "layer_norm": {"weight": self.ones(d)},
            }
        return block

    def stack(self, is_decoder: bool) -> Params:
        c = self.config
        n = c.num_decoder_layers if is_decoder else c.num_layers
        return {"block": [self.block(is_decoder, i == 0) for i in range(n)],
                "final_layer_norm": {"weight": self.ones(c.d_model)}}


def init_params(config: FlashT5Config, seed: int = 0,
                device=None) -> Params:
    """The full encoder-decoder parameter tree, drawn on `device` (default
    `cuda`; raises without a GPU unless device='cpu') from `seed`."""
    device = runtime.resolve_device(device)
    init = _Init(config, seed, device)
    params = {
        "shared": {"embedding": init.normal(
            (config.vocab_size, config.d_model), config.initializer_factor)},
        "encoder": init.stack(is_decoder=False),
        "decoder": init.stack(is_decoder=True),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = init.normal(
            (config.d_model, config.vocab_size),
            config.initializer_factor * config.d_model ** -0.5)
    return params


def init_encoder_params(config: FlashT5Config, seed: int = 0,
                        device=None) -> Params:
    """The encoder-only tree (`shared` + `encoder`, the reference's
    FlashT5EncoderModel, modeling:739-774), drawn on `device` (default
    `cuda`; raises without a GPU unless device='cpu') from `seed`."""
    device = runtime.resolve_device(device)
    init = _Init(config, seed, device)
    return {
        "shared": {"embedding": init.normal(
            (config.vocab_size, config.d_model), config.initializer_factor)},
        "encoder": init.stack(is_decoder=False),
    }


# ===========================================================================
# Building blocks
# ===========================================================================

def _layer_norm(config: FlashT5Config, w: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    if config.use_fused_layernorm:
        # the kernel rounds w to x.dtype as it loads it: the JAX model's
        # `w.astype(x.dtype)`, with no launch of its own
        return rms_norm(x, w, config.layer_norm_epsilon, cast_w=True)
    return rms_norm_ref(x, w.to(x.dtype), config.layer_norm_epsilon)


def _dropout(generator: Optional[torch.Generator], rate: float,
             x: torch.Tensor, deterministic: bool) -> torch.Tensor:
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout (deterministic=False, rate > 0) draws from "
                         "a torch.Generator: pass `generator`")
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _matmul(x: torch.Tensor, w) -> torch.Tensor:
    """A QuantizedTensor goes to the dequant-matmul kernel; a plain weight
    to `torch.matmul`, as the JAX package left it to XLA."""
    if isinstance(w, QuantizedTensor):
        return quant_matmul(x, w)
    return torch.matmul(x, w.to(x.dtype))


def _ff(config: FlashT5Config, params: Params, x: torch.Tensor, *,
        generator=None, deterministic=True) -> torch.Tensor:
    """Pre-norm MLP with residual (reference: modeling_flash_t5.py:147-164).
    Under tensor parallelism wi is split by column and wo by row."""
    group = _tp_group(config)
    h = _to_columns(group, _layer_norm(config, params["layer_norm"]["weight"],
                                       x))
    if config.use_gelu_act:
        def act(t):
            return F.gelu(t, approximate="tanh")
    else:
        act = F.relu
    if config.use_glu_mlp:
        h = act(_matmul(h, params["act"]["wi_0"])) * _matmul(
            h, params["act"]["wi_1"])
    else:
        h = act(_matmul(h, params["act"]["wi"]))
    h = _dropout(generator, config.dropout_rate, h, deterministic)
    h = _row_parallel_matmul(config, group, h, params["wo"])
    return x + _dropout(generator, config.dropout_rate, h, deterministic)


def _fold_mask(bias: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The reference's fold of a padding mask into the bias
    (modeling:266-270, JAX t5.py:394-403): a (B, N) mask becomes
    (B, 1, N, 1), which for self-attention masks query rows."""
    mm = mask[:, None]
    if mm.dim() == 3:
        mm = mm[..., None]
    return torch.where(mm.bool(), bias, torch.finfo(bias.dtype).min)


def _uniform_masked_rows(out: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor, causal: bool) -> torch.Tensor:
    """`use_masking` on `pallas_rpe` (JAX t5.py:455-487): a masked query
    row takes the uniform attention the reference's folded bias gives it,
    the mean of V (the running mean under the causal mask), selected after
    the kernel. Forward-exact; the q/k gradient of those rows is zeroed
    where the reference propagates it (ROADMAP Queue 3)."""
    if causal:
        denom = torch.arange(1, v.shape[2] + 1, dtype=torch.float32,
                             device=v.device)
        uni = (torch.cumsum(v.float(), dim=2) / denom[:, None]).to(out.dtype)
    else:
        uni = v.float().mean(dim=2, keepdim=True).to(out.dtype)
    return torch.where(mask.bool()[:, None, :, None], out, uni)


def _position_bias(config: FlashT5Config, pe_params: Optional[Params],
                   q_len: int, k_len: int, *, bidirectional: bool, device,
                   generator: Optional[torch.Generator] = None,
                   q_positions: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The (1, H, M, N) f32 additive bias of the bias-style encodings (JAX
    t5.py:268-296). With `use_randomized_position_encoding` and a generator,
    the T5 and ALiBi biases take sorted random positions, drawn once here
    (FIRE keeps the plain ones, as the JAX package's does). `q_positions`
    (decoding) keeps those rows of the bias against keys 0..k_len-1."""
    pet = config.position_encoding_type
    q_pos, k_pos = q_positions, None
    if (config.use_randomized_position_encoding and generator is not None
            and pet != "FIRE"):
        q_pos = positional._randomized_positions(
            generator, q_len, config.max_sequence_length).to(device)
        k_pos = positional._randomized_positions(
            generator, k_len, config.max_sequence_length).to(device)
    if pet == "t5":
        return positional.t5_relative_bias(
            pe_params, q_len, k_len, bidirectional=bidirectional,
            num_buckets=config.relative_attention_num_buckets,
            max_distance=config.relative_attention_max_distance,
            q_positions=q_pos, k_positions=k_pos,
            max_len=max(config.max_sequence_length, k_len))
    if pet == "ALiBi":
        return positional.alibi_bias(
            config.num_heads, q_len, k_len, mode=config.alibi_mode,
            q_positions=q_pos, k_positions=k_pos, device=device)
    return positional.fire_bias(pe_params, k_len, q_positions=q_positions)


@functools.lru_cache(maxsize=64)
def rope_tables(table_len: int, rotary_dim: int, base: float,
                scale_base: Optional[float], device
                ) -> Tuple[torch.Tensor, ...]:
    """`positional.rope_cos_sin`'s f32 (cos, sin, cos_k, sin_k), made once
    a length and kept on `device` (constants: nothing writes to them); the
    k tables are the q tables without xPos."""
    cos, sin, cos_k, sin_k = positional.rope_cos_sin(
        table_len, rotary_dim, base=base, scale_base=scale_base,
        device=device)
    return (cos, sin, cos if cos_k is None else cos_k,
            sin if sin_k is None else sin_k)


def rope_tables_for(config: FlashT5Config, length: int, device,
                    randomized: bool = False) -> Tuple[torch.Tensor, ...]:
    """The RoPE tables of a path over `length` positions, as JAX
    t5.py:354-360 and kv_cache.py:72-79 size them: max_sequence_length
    long when randomized, at least that under xPos (whose scale is centred
    on the table), else `length`."""
    if randomized:
        length = config.max_sequence_length
    elif config.rotary_scale_base is not None:
        length = max(config.max_sequence_length, length)
    return rope_tables(length, int(config.d_kv * config.rotary_emb_fraction),
                       config.rotary_base, config.rotary_scale_base, device)


def _rotate(config: FlashT5Config, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, generator: Optional[torch.Generator],
            deterministic: bool):
    """RoPE on q (B, M, H, D) and k, v (B, N, H, D), as JAX t5.py:346-383,
    on `rope_tables_for` max(m, n) positions; randomized training gathers
    the rows of one sorted random draw of max(m, n) positions, the same
    for q and k."""
    m, n = q.shape[1], k.shape[1]
    randomize = (config.use_randomized_position_encoding
                 and not deterministic and generator is not None)
    tables = rope_tables_for(config, max(m, n), q.device, randomize)
    if randomize:
        pos = positional._randomized_positions(
            generator, max(m, n), config.max_sequence_length)
        tables = positional.gather_rope_tables(tables, pos)
    cos, sin, ck, sk = tables
    inter = config.rotary_interleaved
    q = positional.apply_rotary(q, cos[:m], sin[:m], interleaved=inter)
    k = positional.apply_rotary(k, ck[:n], sk[:n], interleaved=inter)
    if config.rope_rotate_v:
        # reference quirk: v is rotated too (positional_encoding.py:330)
        v = positional.apply_rotary(v, ck[:n], sk[:n], interleaved=inter)
    return q, k, v


def _local_heads(group, bias: torch.Tensor) -> torch.Tensor:
    """This tensor rank's heads of a bias over all heads (ALiBi's, FIRE's;
    JAX t5.py:286-292); FIRE's gradient comes back whole on every rank."""
    per = bias.shape[1] // torch.distributed.get_world_size(group)
    start = torch.distributed.get_rank(group) * per
    return _to_columns(group, bias)[:, start:start + per]


def _attention(config: FlashT5Config, params: Params,
               hidden_states: torch.Tensor, *,
               mask: Optional[torch.Tensor] = None,
               key_value_states: Optional[torch.Tensor] = None,
               position_bias: Optional[torch.Tensor] = None,
               has_pe: bool, is_causal: bool, bidirectional: bool,
               rpe_table: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               deterministic: bool = True):
    """Multi-head attention (reference: modeling_flash_t5.py:232-294);
    returns (output, position_bias) so the stack threads block 0's bias.
    `mask` is the padding mask of the queries' side (B, N), used only with
    `use_masking`; cross-attention has no bias to fold it into."""
    b, m = hidden_states.shape[:2]
    group = _tp_group(config)
    hidden_states = _to_columns(group, hidden_states)
    kv_src = (hidden_states if key_value_states is None
              else _to_columns(group, key_value_states))
    n = kv_src.shape[1]
    dkv = config.d_kv
    # the head count of this rank's (column-split) projection
    h = params["Wq"].shape[1] // dkv
    q = _matmul(hidden_states, params["Wq"]).reshape(b, m, h, dkv)
    k = _matmul(kv_src, params["Wk"]).reshape(b, n, h, dkv)
    v = _matmul(kv_src, params["Wv"]).reshape(b, n, h, dkv)
    pe_params = params.get("pe_encoding")
    if config.position_encoding_type == "RoPE":
        # in every layer (reference quirk: the rotary encoder is built
        # whether or not the layer has a positional encoding, modeling:214)
        q, k, v = _rotate(config, q, k, v, generator, deterministic)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    scale = config.softmax_scale
    if config.attention_type != "pallas_rpe":
        if (position_bias is None and has_pe
                and config.position_encoding_type != "RoPE"):
            position_bias = _position_bias(
                config, pe_params, m, n, bidirectional=bidirectional,
                device=q.device, generator=generator)
            if (group is not None
                    and config.position_encoding_type != "t5"):
                position_bias = _local_heads(group, position_bias)
        if position_bias is not None and config.use_full_bias_size:
            position_bias = position_bias.expand(b, h, m, n)
        if position_bias is not None and mask is not None and \
                config.use_masking:
            position_bias = _fold_mask(position_bias, mask)

    if config.attention_type == "pallas_rpe":
        # every layer uses block 0's bucket table (T5 semantics,
        # reference modeling:452-455); the stack threads it as rpe_table.
        # Without one (cross-attention) this is plain flash attention.
        table = rpe_table
        if table is None and has_pe and pe_params is not None:
            table = pe_params["relative_attention_bias"]
        out = flash_attention_rpe(
            q, k, v, table, causal=is_causal, sm_scale=scale,
            bidirectional=bidirectional,
            num_buckets=config.relative_attention_num_buckets,
            max_distance=config.relative_attention_max_distance)
        if (config.use_masking and mask is not None and mask.dim() == 2
                and key_value_states is None):
            out = _uniform_masked_rows(out, v, mask, is_causal)
    elif config.attention_type == "pallas":
        out = flash_attention(q, k, v, position_bias, causal=is_causal,
                              sm_scale=scale)
    else:
        out = attn_ref(q, k, v, position_bias, sm_scale=scale,
                       causal=is_causal,
                       dropout_p=(0.0 if deterministic
                                  else config.attention_dropout_rate),
                       generator=generator)
    out = out.transpose(1, 2).reshape(b, m, h * dkv)
    return (_row_parallel_matmul(config, group, out, params["o"]),
            position_bias)


def _block_apply(config: FlashT5Config, block_params: Params,
                 hidden_states: torch.Tensor, *, is_decoder: bool,
                 has_pe: bool, attention_mask=None, position_bias=None,
                 encoder_hidden_states=None, encoder_attention_mask=None,
                 rpe_table=None, generator=None, deterministic=True):
    def drop(t):
        return _dropout(generator, config.dropout_rate, t, deterministic)

    sa = block_params["self_attention_layer"]
    normed = _layer_norm(config, sa["layer_norm"]["weight"], hidden_states)
    attn_out, position_bias = _attention(
        config, sa["self_attention"], normed, mask=attention_mask,
        position_bias=position_bias, has_pe=has_pe, is_causal=is_decoder,
        bidirectional=not is_decoder, rpe_table=rpe_table,
        generator=generator, deterministic=deterministic)
    hidden_states = hidden_states + drop(attn_out)
    if is_decoder and encoder_hidden_states is not None:
        ca = block_params["cross_attention_layer"]
        normed = _layer_norm(config, ca["layer_norm"]["weight"], hidden_states)
        attn_out, _ = _attention(
            config, ca["cross_attention"], normed,
            mask=encoder_attention_mask,
            key_value_states=encoder_hidden_states, has_pe=False,
            is_causal=False, bidirectional=True, generator=generator,
            deterministic=deterministic)
        hidden_states = hidden_states + drop(attn_out)
    hidden_states = _ff(config, block_params["ff_layer"], hidden_states,
                        generator=generator, deterministic=deterministic)
    return hidden_states, position_bias


def _rematerialized(block, generator: Optional[torch.Generator],
                    x: torch.Tensor, position_bias):
    """`config.remat` (the JAX model's `jax.checkpoint(...,
    nothing_saveable)` around each block): `block(x, position_bias=...)`
    keeps none of its activations and runs again in the backward pass.
    Dropout draws from the caller's `generator`, which checkpointing does
    not stash, so the recompute draws from the state the forward pass
    started from (the same masks) and then puts the generator back where
    the backward pass found it: after the backward it stands where it
    would without remat."""
    start = None if generator is None else generator.get_state()
    runs = []

    def run(x, position_bias):
        if runs and generator is not None:        # the recompute
            now = generator.get_state()
            generator.set_state(start)
            try:
                return block(x, position_bias=position_bias)
            finally:
                # also where the recompute stops early, once it has made
                # every tensor the backward needs
                generator.set_state(now)
        runs.append(True)
        return block(x, position_bias=position_bias)

    # the default generators are not drawn from: nothing of theirs to stash
    return torch.utils.checkpoint.checkpoint(
        run, x, position_bias, use_reentrant=False,
        preserve_rng_state=False)


def stack_apply(config: FlashT5Config, stack_params: Params,
                embedding: torch.Tensor, input_ids: torch.Tensor, *,
                is_decoder: bool,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True) -> torch.Tensor:
    """Embed + N blocks + final norm (reference: modeling_flash_t5.py:410-464).

    Block 0 owns the positional encoding; its bias (`ref`, `pallas`) or its
    bucket table (`pallas_rpe`) applies in every block. The masks act only
    through `use_masking`, as in the JAX package."""
    check_supported(config)
    x = embedding[input_ids.long()].to(runtime.torch_dtype(config.dtype))
    x = _dropout(generator, config.dropout_rate, x, deterministic)
    rpe_table = None
    if config.attention_type == "pallas_rpe":
        pe = stack_params["block"][0]["self_attention_layer"][
            "self_attention"].get("pe_encoding")
        if pe is not None:
            rpe_table = pe["relative_attention_bias"]
    position_bias = None
    remat = config.remat and torch.is_grad_enabled()
    for i, block_params in enumerate(stack_params["block"]):
        block = functools.partial(
            _block_apply, config, block_params, is_decoder=is_decoder,
            has_pe=(i == 0), attention_mask=attention_mask,
            encoder_hidden_states=encoder_hidden_states,
            encoder_attention_mask=encoder_attention_mask,
            rpe_table=rpe_table, generator=generator,
            deterministic=deterministic)
        if remat:
            x, position_bias = _rematerialized(block, generator, x,
                                               position_bias)
        else:
            x, position_bias = block(x, position_bias=position_bias)
    x = _layer_norm(config, stack_params["final_layer_norm"]["weight"], x)
    return _dropout(generator, config.dropout_rate, x, deterministic)


# ===========================================================================
# Losses
# ===========================================================================

def loss_denominator(config: FlashT5Config,
                     labels: torch.Tensor) -> torch.Tensor:
    """The count a loss sum is divided by: every row with
    `use_fused_crossentropy`, else the non-ignored rows (f32, 0-d)."""
    if config.use_fused_crossentropy:
        return torch.tensor(float(labels.numel()), device=labels.device)
    return (labels != -100).sum().float()


def compute_loss(config: FlashT5Config, logits: torch.Tensor,
                 labels: torch.Tensor,
                 denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CE + z-loss (reference: FlashT5CrossEntropyLoss, modeling:40-79).

    Keeps the reference's reduction quirk: the fused path means over ALL
    rows, ignored ones included (modeling:68); the plain path means over the
    non-ignored rows only (modeling:74). A given `denominator` replaces
    that count (the trainers across ranks pass the global one)."""
    z = config.z_loss or 0.0
    flat_logits = logits.reshape(-1, logits.shape[-1])
    flat_labels = labels.reshape(-1)
    if config.use_fused_crossentropy:
        losses, _ = cross_entropy_loss(flat_logits, flat_labels, z,
                                       config.label_smoothing)
    else:
        losses, _ = cross_entropy_loss_ref(
            flat_logits, flat_labels, lse_square_scale=z,
            label_smoothing=config.label_smoothing)
    if denominator is None:
        denominator = torch.clamp(
            loss_denominator(config, flat_labels), min=1.0)
    return torch.sum(losses) / denominator


# ===========================================================================
# Top-level models
# ===========================================================================

def shift_right(config: FlashT5Config,
                input_ids: torch.Tensor) -> torch.Tensor:
    """Decoder-input construction (reference: modeling:506-517)."""
    shifted = torch.roll(input_ids, 1, dims=-1)
    shifted[..., 0] = config.decoder_start_token_id
    return torch.where(shifted == -100, config.pad_token_id, shifted)


def encode(config: FlashT5Config, params: Params, input_ids: torch.Tensor,
           attention_mask: Optional[torch.Tensor] = None, *,
           generator: Optional[torch.Generator] = None,
           deterministic: bool = True) -> torch.Tensor:
    """Encoder hidden states (B, S, d_model). `attention_mask` acts only
    through `use_masking` (as in the JAX package)."""
    return stack_apply(config, params["encoder"],
                       params["shared"]["embedding"], input_ids,
                       is_decoder=False, attention_mask=attention_mask,
                       generator=generator, deterministic=deterministic)


class Outputs(dict):
    """`forward`'s results. On the fused lm_head+CE path the (rows x V)
    logits, which the loss does not need, are computed only when a caller
    first reads `out["logits"]` (eager PyTorch would not drop the dead
    matmul that the JAX package leaves to XLA); until then "logits" is not
    among the keys."""

    def __init__(self, logits_fn, **items):
        super().__init__(**items)
        self._logits_fn = logits_fn

    def __missing__(self, key):
        if key != "logits" or self._logits_fn is None:
            raise KeyError(key)
        self["logits"] = logits = self._logits_fn()
        return logits


def forward(config: FlashT5Config, params: Params,
            input_ids: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None,
            decoder_input_ids: Optional[torch.Tensor] = None,
            decoder_attention_mask: Optional[torch.Tensor] = None,
            labels: Optional[torch.Tensor] = None,
            encoder_hidden_states: Optional[torch.Tensor] = None, *,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = True,
            loss_denominator: Optional[torch.Tensor] = None
            ) -> Dict[str, torch.Tensor]:
    """Conditional-generation forward (reference: modeling:692-736).

    Returns Outputs(loss?, logits, encoder_hidden_states), a dict. With
    labels and `use_fused_lm_head_ce` (untied, plain lm_head) the loss comes
    from the fused lm_head+CE kernels and the logits only on demand.
    Dropout (training, `deterministic=False`) draws from `generator`.
    `loss_denominator` replaces the count the loss sum is divided by.

    Under tensor parallelism (`config.tp_axis`, inside `use_mesh`) the
    parameters are this rank's shards (`parallel.sharding`): the logits
    are this rank's slice of the vocabulary, and with an untied lm_head
    the loss is `vocab_parallel_loss` (JAX t5.py:748-751); the fused
    lm_head+CE stays off, as in the JAX model."""
    if encoder_hidden_states is None:
        encoder_hidden_states = encode(config, params, input_ids,
                                       attention_mask, generator=generator,
                                       deterministic=deterministic)
    if labels is not None and decoder_input_ids is None:
        decoder_input_ids = shift_right(config, labels)
    dec = stack_apply(config, params["decoder"],
                      params["shared"]["embedding"], decoder_input_ids,
                      is_decoder=True, attention_mask=decoder_attention_mask,
                      encoder_hidden_states=encoder_hidden_states,
                      encoder_attention_mask=attention_mask,
                      generator=generator, deterministic=deterministic)
    group = _tp_group(config)
    if config.tie_word_embeddings:
        head = params["shared"]["embedding"].t()
    else:
        head = params["lm_head"]
        dec = _to_columns(group, dec)
    if (labels is not None and config.use_fused_lm_head_ce
            and not config.tie_word_embeddings and group is None
            and isinstance(head, torch.Tensor)):
        # lm_head + CE in one kernel, straight from the decoder's hidden
        # states; the same reduction as compute_loss's fused path: the mean
        # over ALL rows (reference modeling:68)
        losses, _ = fused_linear_cross_entropy(
            dec.reshape(-1, dec.shape[-1]), head, labels.reshape(-1),
            config.z_loss or 0.0, config.label_smoothing)
        loss = (torch.mean(losses) if loss_denominator is None
                else torch.sum(losses) / loss_denominator)
        return Outputs(lambda: _matmul(dec, head), loss=loss,
                       encoder_hidden_states=encoder_hidden_states)
    lm_logits = _matmul(dec, head)
    out = Outputs(None, logits=lm_logits,
                  encoder_hidden_states=encoder_hidden_states)
    if labels is not None and group is not None \
            and not config.tie_word_embeddings:
        from flasht5_tpu_torch.parallel.vocab_parallel import (
            vocab_parallel_loss)
        out["loss"] = vocab_parallel_loss(config, lm_logits, labels, group,
                                          loss_denominator)
    elif labels is not None:
        out["loss"] = compute_loss(config, lm_logits, labels,
                                   loss_denominator)
    return out


def model_forward(config: FlashT5Config, params: Params,
                  input_ids: Optional[torch.Tensor] = None,
                  attention_mask: Optional[torch.Tensor] = None,
                  decoder_input_ids: Optional[torch.Tensor] = None,
                  decoder_attention_mask: Optional[torch.Tensor] = None, *,
                  generator: Optional[torch.Generator] = None,
                  deterministic: bool = True) -> Dict[str, torch.Tensor]:
    """Bare encoder-decoder (FlashT5Model, reference: modeling:520-602):
    dict(last_hidden_state, encoder_last_hidden_state), no lm_head or loss."""
    enc = encode(config, params, input_ids, attention_mask,
                 generator=generator, deterministic=deterministic)
    dec = stack_apply(config, params["decoder"],
                      params["shared"]["embedding"], decoder_input_ids,
                      is_decoder=True, attention_mask=decoder_attention_mask,
                      encoder_hidden_states=enc,
                      encoder_attention_mask=attention_mask,
                      generator=generator, deterministic=deterministic)
    return {"last_hidden_state": dec, "encoder_last_hidden_state": enc}


# ===========================================================================
# Generation without a cache (the reference's own loop)
# ===========================================================================

def finish_generation(config: FlashT5Config, tokens: torch.Tensor,
                      reached_end: bool) -> torch.Tensor:
    """The reference generate's end (modeling:683-688): EOS forced at the
    boundary if the loop ran to max_length, then every position after each
    row's first EOS zeroed and that EOS kept. `tokens` (B, max_length + 1),
    written in place."""
    eos = config.eos_token_id
    out_len = tokens.shape[1]
    if reached_end:
        tokens[:, -1] = eos
    is_eos = tokens == eos
    first = torch.where(is_eos.any(dim=-1), is_eos.int().argmax(dim=-1),
                        out_len - 1)
    pos = torch.arange(out_len, device=tokens.device)[None, :]
    tokens = torch.where(pos <= first[:, None], tokens, 0)
    return torch.where(pos == first[:, None], eos, tokens)


@torch.no_grad()
def greedy_generate(config: FlashT5Config, params: Params,
                    input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None,
                    max_length: int = 32) -> torch.Tensor:
    """Reference-parity greedy decode WITHOUT a KV cache (modeling:648-690):
    start token 0, stop on EOS, force a final EOS, zero-pad after the first
    EOS. Re-runs the decoder over the whole prefix each step (the
    reference's own loop); the KV-cached loop is inference/generate.py."""
    return _generate(config, params, input_ids, attention_mask, max_length,
                     lambda logits: torch.argmax(logits, dim=-1))


@torch.no_grad()
def sample_generate(config: FlashT5Config, params: Params,
                    input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None,
                    max_length: int = 32, *,
                    generator: Optional[torch.Generator],
                    temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 1.0) -> torch.Tensor:
    """Sampling decode with greedy_generate's contract; the draw is
    `inference.sampling.sample_token`'s, its noise from `generator`."""
    from flasht5_tpu_torch.inference.sampling import sample_token

    def select(logits):
        return sample_token(logits, generator=generator,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p)

    return _generate(config, params, input_ids, attention_mask, max_length,
                     select)


def _generate(config, params, input_ids, attention_mask, max_length,
              select_fn) -> torch.Tensor:
    dev = params["shared"]["embedding"].device
    ids = torch.as_tensor(input_ids, device=dev)
    b = ids.shape[0]
    enc = encode(config, params, ids, attention_mask)
    # position t generated at step t; position 0 is the start token
    labels = torch.zeros((b, max_length + 1), dtype=torch.int64, device=dev)
    seen_eos = torch.zeros((b,), dtype=torch.bool, device=dev)
    t = 0
    while t < max_length and not bool(seen_eos.all()):
        out = forward(config, params, attention_mask=attention_mask,
                      decoder_input_ids=labels[:, :-1],
                      encoder_hidden_states=enc)
        nxt = select_fn(out["logits"][:, t])
        labels[:, t + 1] = nxt
        seen_eos |= nxt == config.eos_token_id
        t += 1
    return finish_generation(config, labels, t == max_length)
