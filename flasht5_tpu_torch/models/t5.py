"""T5 v1.1 encoder stack in PyTorch: parameters, blocks and `encode`.

The counterpart of `flasht5_tpu/models/t5.py` for the serving slice. The
parameter tree is a nested dict (blocks in lists) with the JAX package's key
names, so a JAX tree carries across one-to-one (convert/from_jax.py):

    shared.embedding
    {encoder,decoder}.block.<i>.self_attention_layer.self_attention.{Wq,Wk,Wv,o}
    {encoder,decoder}.block.<i>.self_attention_layer.layer_norm.weight
    decoder.block.<i>.cross_attention_layer.cross_attention.{Wq,Wk,Wv,o}
    {encoder,decoder}.block.<i>.ff_layer.act.{wi | wi_0,wi_1}
    {encoder,decoder}.block.<i>.ff_layer.{wo, layer_norm.weight}
    {encoder,decoder}.block.0...self_attention.pe_encoding.relative_attention_bias
    {encoder,decoder}.final_layer_norm.weight
    lm_head

Linear weights are stored (in, out), applied as `x @ W`. Only the T5
relative bias is ported; the forward is inference only (no dropout).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from flasht5_tpu_torch import positional, runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.ops.attn_ref import attn_ref
from flasht5_tpu_torch.ops.flash_attention_rpe import flash_attention_rpe
from flasht5_tpu_torch.ops.quant import QuantizedTensor, quant_matmul
from flasht5_tpu_torch.ops.rmsnorm import rms_norm, rms_norm_ref

Params = Dict[str, Any]


def check_supported(config: FlashT5Config) -> None:
    """Raise for the parts of the configuration the port does not run yet."""
    if config.position_encoding_type != "t5":
        raise NotImplementedError(
            f"{config.position_encoding_type} position encoding is not "
            f"ported yet")
    if config.attention_type == "pallas":
        raise NotImplementedError("attention_type='pallas' is not ported yet")
    if config.tp_axis is not None:
        raise NotImplementedError("tensor parallelism is not ported yet")
    if config.use_masking:
        raise NotImplementedError("use_masking is not ported yet")


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
        if has_pe:
            p["pe_encoding"] = positional.init_relative_bias_params(
                self.gen, c.relative_attention_num_buckets, c.num_heads,
                initializer_factor=f, d_model=d, dtype=self.dtype,
                device=self.device)
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


# ===========================================================================
# Building blocks
# ===========================================================================

def _layer_norm(config: FlashT5Config, w: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    if config.use_fused_layernorm:
        return rms_norm(x, w.to(x.dtype), config.layer_norm_epsilon)
    return rms_norm_ref(x, w.to(x.dtype), config.layer_norm_epsilon)


def _matmul(x: torch.Tensor, w) -> torch.Tensor:
    """A QuantizedTensor goes to the dequant-matmul kernel; a plain weight
    to `torch.matmul`, as the JAX package left it to XLA."""
    if isinstance(w, QuantizedTensor):
        return quant_matmul(x, w)
    return torch.matmul(x, w.to(x.dtype))


def _ff(config: FlashT5Config, params: Params, x: torch.Tensor
        ) -> torch.Tensor:
    """Pre-norm MLP with residual (reference: modeling_flash_t5.py:147-164)."""
    h = _layer_norm(config, params["layer_norm"]["weight"], x)
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
    return x + _matmul(h, params["wo"])


def _heads(y: torch.Tensor, n_heads: int, d_kv: int) -> torch.Tensor:
    """(B, L, H*D) -> (B, H, L, D)."""
    b, n = y.shape[:2]
    return y.reshape(b, n, n_heads, d_kv).transpose(1, 2)


def _attention(config: FlashT5Config, params: Params,
               hidden_states: torch.Tensor, *,
               key_value_states: Optional[torch.Tensor] = None,
               position_bias: Optional[torch.Tensor] = None,
               has_pe: bool, is_causal: bool, bidirectional: bool,
               rpe_table: Optional[torch.Tensor] = None):
    """Multi-head attention (reference: modeling_flash_t5.py:232-294);
    returns (output, position_bias) so the stack threads block 0's bias."""
    b, m = hidden_states.shape[:2]
    kv_src = hidden_states if key_value_states is None else key_value_states
    dkv = config.d_kv
    h = params["Wq"].shape[1] // dkv
    q = _heads(_matmul(hidden_states, params["Wq"]), h, dkv)
    k = _heads(_matmul(kv_src, params["Wk"]), h, dkv)
    v = _heads(_matmul(kv_src, params["Wv"]), h, dkv)
    n = k.shape[2]
    pe_params = params.get("pe_encoding")
    scale = config.softmax_scale

    if config.attention_type == "pallas_rpe":
        # every layer uses block 0's bucket table (T5 semantics,
        # reference modeling:452-455); the stack threads it as rpe_table
        table = rpe_table
        if table is None and has_pe and pe_params is not None:
            table = pe_params["relative_attention_bias"]
        out = flash_attention_rpe(
            q, k, v, table, causal=is_causal, sm_scale=scale,
            bidirectional=bidirectional,
            num_buckets=config.relative_attention_num_buckets,
            max_distance=config.relative_attention_max_distance)
    else:
        if position_bias is None and has_pe and pe_params is not None:
            position_bias = positional.t5_relative_bias(
                pe_params, m, n, bidirectional=bidirectional,
                num_buckets=config.relative_attention_num_buckets,
                max_distance=config.relative_attention_max_distance)
        out = attn_ref(q, k, v, position_bias, sm_scale=scale,
                       causal=is_causal)
    out = out.transpose(1, 2).reshape(b, m, h * dkv)
    return _matmul(out, params["o"]), position_bias


def _block_apply(config: FlashT5Config, block_params: Params,
                 hidden_states: torch.Tensor, *, is_decoder: bool,
                 has_pe: bool, position_bias=None, encoder_hidden_states=None,
                 rpe_table=None):
    sa = block_params["self_attention_layer"]
    normed = _layer_norm(config, sa["layer_norm"]["weight"], hidden_states)
    attn_out, position_bias = _attention(
        config, sa["self_attention"], normed, position_bias=position_bias,
        has_pe=has_pe, is_causal=is_decoder, bidirectional=not is_decoder,
        rpe_table=rpe_table)
    hidden_states = hidden_states + attn_out
    if is_decoder and encoder_hidden_states is not None:
        ca = block_params["cross_attention_layer"]
        normed = _layer_norm(config, ca["layer_norm"]["weight"], hidden_states)
        attn_out, _ = _attention(
            config, ca["cross_attention"], normed,
            key_value_states=encoder_hidden_states, has_pe=False,
            is_causal=False, bidirectional=True)
        hidden_states = hidden_states + attn_out
    hidden_states = _ff(config, block_params["ff_layer"], hidden_states)
    return hidden_states, position_bias


def stack_apply(config: FlashT5Config, stack_params: Params,
                embedding: torch.Tensor, input_ids: torch.Tensor, *,
                is_decoder: bool,
                encoder_hidden_states: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Embed + N blocks + final norm (reference: modeling_flash_t5.py:410-464).

    Block 0 owns the positional encoding; its bias (the `ref` path) or its
    bucket table (the `pallas_rpe` path) applies in every block."""
    check_supported(config)
    x = embedding[input_ids.long()].to(runtime.torch_dtype(config.dtype))
    rpe_table = None
    if config.attention_type == "pallas_rpe":
        pe = stack_params["block"][0]["self_attention_layer"][
            "self_attention"].get("pe_encoding")
        if pe is not None:
            rpe_table = pe["relative_attention_bias"]
    position_bias = None
    for i, block_params in enumerate(stack_params["block"]):
        x, position_bias = _block_apply(
            config, block_params, x, is_decoder=is_decoder, has_pe=(i == 0),
            position_bias=position_bias,
            encoder_hidden_states=encoder_hidden_states, rpe_table=rpe_table)
    return _layer_norm(config, stack_params["final_layer_norm"]["weight"], x)


def encode(config: FlashT5Config, params: Params,
           input_ids: torch.Tensor) -> torch.Tensor:
    """Encoder hidden states (B, S, d_model), with no attention mask: the
    JAX package applies one only through `use_masking`, not ported yet."""
    return stack_apply(config, params["encoder"],
                       params["shared"]["embedding"], input_ids,
                       is_decoder=False)
