"""Weight import and export against HF T5 and FAT5 safetensors checkpoints.

The counterpart of `flasht5_tpu/convert/hf_import.py`, with the same key
tables: the reference's FAT5 canonical naming (its
convert_huggingface_t5.py:12-28) mapped into the port's parameter tree
(models/t5.py docstring), and HF T5 keys renamed into it. Torch Linear
weights are (out, in); the port stores (in, out) and applies x @ W, so every
linear is transposed on import and back on export. Files are read and
written by `convert/safetensors_file.py`, not the safetensors package.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Union

import numpy as np
import torch

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import safetensors_file

Params = Dict[str, Any]
Array = Union[np.ndarray, torch.Tensor]


# FAT5 canonical key -> (pytree path template, transpose?)
# Paths use {stack}/{i} placeholders; block index is captured separately.
_FAT5_PATTERNS = [
    # attention
    (re.compile(r"^(encoder|decoder)\.block\.(\d+)\.self_attention_layer\.self_attention\.(Wq|Wk|Wv|o)\.weight$"),
     lambda m: (m.group(1), int(m.group(2)), "self_attention_layer", "self_attention", m.group(3)), True),
    (re.compile(r"^decoder\.block\.(\d+)\.cross_attention_layer\.cross_attention\.(Wq|Wk|Wv|o)\.weight$"),
     lambda m: ("decoder", int(m.group(1)), "cross_attention_layer", "cross_attention", m.group(2)), True),
    (re.compile(r"^(encoder|decoder)\.block\.(\d+)\.self_attention_layer\.self_attention\.pe_encoding\.relative_attention_bias\.weight$"),
     lambda m: (m.group(1), int(m.group(2)), "self_attention_layer", "self_attention", "pe_encoding", "relative_attention_bias"), False),
    # FIRE pe params (reference: positional_encoding.py:358-372 —
    # mlp.0 = Linear(1, width), mlp.2 = Linear(width, n_heads), plus the
    # scalars c / init_L / L_multiplier)
    (re.compile(r"^(encoder|decoder)\.block\.(\d+)\.self_attention_layer\.self_attention\.pe_encoding\.mlp\.0\.weight$"),
     lambda m: (m.group(1), int(m.group(2)), "self_attention_layer", "self_attention", "pe_encoding", "mlp", "w1"), True),
    (re.compile(r"^(encoder|decoder)\.block\.(\d+)\.self_attention_layer\.self_attention\.pe_encoding\.mlp\.0\.bias$"),
     lambda m: (m.group(1), int(m.group(2)), "self_attention_layer", "self_attention", "pe_encoding", "mlp", "b1"), False),
    (re.compile(r"^(encoder|decoder)\.block\.(\d+)\.self_attention_layer\.self_attention\.pe_encoding\.mlp\.2\.weight$"),
     lambda m: (m.group(1), int(m.group(2)), "self_attention_layer", "self_attention", "pe_encoding", "mlp", "w2"), True),
    (re.compile(r"^(encoder|decoder)\.block\.(\d+)\.self_attention_layer\.self_attention\.pe_encoding\.mlp\.2\.bias$"),
     lambda m: (m.group(1), int(m.group(2)), "self_attention_layer", "self_attention", "pe_encoding", "mlp", "b2"), False),
    (re.compile(r"^(encoder|decoder)\.block\.(\d+)\.self_attention_layer\.self_attention\.pe_encoding\.(c|init_L|L_multiplier)$"),
     lambda m: (m.group(1), int(m.group(2)), "self_attention_layer", "self_attention", "pe_encoding", m.group(3)), False),
    # layer norms
    (re.compile(r"^(encoder|decoder)\.block\.(\d+)\.self_attention_layer\.layer_norm\.weight$"),
     lambda m: (m.group(1), int(m.group(2)), "self_attention_layer", "layer_norm", "weight"), False),
    (re.compile(r"^decoder\.block\.(\d+)\.cross_attention_layer\.layer_norm\.weight$"),
     lambda m: ("decoder", int(m.group(1)), "cross_attention_layer", "layer_norm", "weight"), False),
    (re.compile(r"^(encoder|decoder)\.block\.(\d+)\.ff_layer\.layer_norm\.weight$"),
     lambda m: (m.group(1), int(m.group(2)), "ff_layer", "layer_norm", "weight"), False),
    # mlp
    (re.compile(r"^(encoder|decoder)\.block\.(\d+)\.ff_layer\.act\.(wi_0|wi_1|wi)\.weight$"),
     lambda m: (m.group(1), int(m.group(2)), "ff_layer", "act", m.group(3)), True),
    (re.compile(r"^(encoder|decoder)\.block\.(\d+)\.ff_layer\.wo\.weight$"),
     lambda m: (m.group(1), int(m.group(2)), "ff_layer", "wo"), True),
    # stack-level
    (re.compile(r"^(encoder|decoder)\.final_layer_norm\.weight$"),
     lambda m: (m.group(1), "final_layer_norm", "weight"), False),
    (re.compile(r"^shared\.weight$"), lambda m: ("shared", "embedding"), False),
    (re.compile(r"^lm_head\.weight$"), lambda m: ("lm_head",), True),
]

# HF T5 key -> FAT5 key (the reference's rename table,
# convert_huggingface_t5.py:12-28, inverted into HF->FAT5 direction)
_HF_RENAMES = [
    (r"\.SelfAttention\.q\.", ".self_attention_layer.self_attention.Wq."),
    (r"\.SelfAttention\.k\.", ".self_attention_layer.self_attention.Wk."),
    (r"\.SelfAttention\.v\.", ".self_attention_layer.self_attention.Wv."),
    (r"\.SelfAttention\.o\.", ".self_attention_layer.self_attention.o."),
    (r"\.SelfAttention\.relative_attention_bias\.",
     ".self_attention_layer.self_attention.pe_encoding.relative_attention_bias."),
    (r"\.EncDecAttention\.q\.", ".cross_attention_layer.cross_attention.Wq."),
    (r"\.EncDecAttention\.k\.", ".cross_attention_layer.cross_attention.Wk."),
    (r"\.EncDecAttention\.v\.", ".cross_attention_layer.cross_attention.Wv."),
    (r"\.EncDecAttention\.o\.", ".cross_attention_layer.cross_attention.o."),
    (r"\.layer\.0\.layer_norm\.", ".self_attention_layer.layer_norm."),
    # decoder layer.1 = cross-attn, layer.2 = mlp; encoder layer.1 = mlp
    (r"(decoder\.block\.\d+)\.layer\.1\.layer_norm\.",
     r"\1.cross_attention_layer.layer_norm."),
    (r"(decoder\.block\.\d+)\.layer\.2\.layer_norm\.", r"\1.ff_layer.layer_norm."),
    (r"(encoder\.block\.\d+)\.layer\.1\.layer_norm\.", r"\1.ff_layer.layer_norm."),
    (r"\.DenseReluDense\.wi_0\.", ".ff_layer.act.wi_0."),
    (r"\.DenseReluDense\.wi_1\.", ".ff_layer.act.wi_1."),
    (r"\.DenseReluDense\.wi\.", ".ff_layer.act.wi."),
    (r"\.DenseReluDense\.wo\.", ".ff_layer.wo."),
    (r"\.layer\.0\.", "."), (r"\.layer\.1\.", "."), (r"\.layer\.2\.", "."),
]


def hf_key_to_fat5(key: str) -> str:
    for pat, rep in _HF_RENAMES:
        key = re.sub(pat, rep, key)
    return key


def _insert(tree: Params, path, value):
    """Insert value at path, creating dicts and block lists as needed."""
    node = tree
    for idx, p in enumerate(path[:-1]):
        nxt = path[idx + 1]
        if isinstance(p, int):
            while len(node) <= p:
                node.append({})
            node = node[p]
        elif p in ("encoder", "decoder") and isinstance(nxt, int):
            node = node.setdefault(p, {}).setdefault("block", [])
        elif isinstance(nxt, int):
            node = node.setdefault(p, [])
        else:
            node = node.setdefault(p, {})
    last = path[-1]
    if isinstance(last, int):
        while len(node) <= last:
            node.append({})
    node[last] = value


def _to_tensor(value: Array) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.ascontiguousarray(value))


def state_dict_to_params(state: Dict[str, Array],
                         dtype: torch.dtype = torch.float32,
                         device=None) -> Params:
    """FAT5-named flat state dict (numpy arrays or torch tensors) -> the
    port's parameter tree, every leaf in `dtype` on `device` (default
    `cuda`; raises without a GPU unless device='cpu')."""
    device = runtime.resolve_device(device)
    params: Params = {}
    unmatched = []
    for key, value in state.items():
        for pat, path_fn, transpose in _FAT5_PATTERNS:
            m = pat.match(key)
            if m:
                t = _to_tensor(value)
                if transpose:
                    t = t.t()
                _insert(params, path_fn(m),
                        t.to(device=device, dtype=dtype).contiguous())
                break
        else:
            unmatched.append(key)
    if unmatched:
        raise ValueError(f"unrecognized checkpoint keys: {unmatched[:10]}")
    return params


def load_fat5_safetensors(path: str, dtype: torch.dtype = torch.float32,
                          device=None) -> Params:
    """Load a FAT5-named safetensors checkpoint (the reference converter's
    output format, convert_huggingface_t5.py:31)."""
    return state_dict_to_params(safetensors_file.load_file(path), dtype,
                                device)


def hf_state_to_fat5(state: Dict[str, Array]) -> Dict[str, Array]:
    """An HF T5/mT5/FLAN-T5 state dict under FAT5 names: the encoder's and
    decoder's `embed_tokens` (views of `shared.weight`) dropped, or taken
    as `shared.weight` where that is missing."""
    renamed = {hf_key_to_fat5(k): v for k, v in state.items()
               if not k.endswith("embed_tokens.weight")}
    if "shared.weight" not in renamed:
        for k, v in state.items():
            if k.endswith("embed_tokens.weight"):
                renamed["shared.weight"] = v
                break
    return renamed


def load_hf_t5_safetensors(path: str, dtype: torch.dtype = torch.float32,
                           device=None) -> Params:
    """Load an HF T5/mT5/FLAN-T5 safetensors checkpoint directly."""
    return state_dict_to_params(
        hf_state_to_fat5(safetensors_file.load_file(path)), dtype, device)


def params_to_fat5_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """Export the port's tree to the FAT5 flat naming in torch layout
    (linears transposed back to (out, in)), as contiguous CPU tensors, for
    interchange with the reference implementation."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, t, transpose=False):
        t = t.detach().cpu()
        out[key] = (t.t() if transpose else t).contiguous()

    def attn(prefix, p, kind):
        for name in ("Wq", "Wk", "Wv", "o"):
            put(f"{prefix}.{kind}.{name}.weight", p[name], True)
        pe = p.get("pe_encoding")
        if pe is not None and "relative_attention_bias" in pe:
            put(f"{prefix}.{kind}.pe_encoding.relative_attention_bias.weight",
                pe["relative_attention_bias"])
        elif pe is not None and "mlp" in pe:  # FIRE
            base = f"{prefix}.{kind}.pe_encoding"
            put(f"{base}.mlp.0.weight", pe["mlp"]["w1"], True)
            put(f"{base}.mlp.0.bias", pe["mlp"]["b1"])
            put(f"{base}.mlp.2.weight", pe["mlp"]["w2"], True)
            put(f"{base}.mlp.2.bias", pe["mlp"]["b2"])
            for name in ("c", "init_L", "L_multiplier"):
                put(f"{base}.{name}", pe[name])

    for stack in ("encoder", "decoder"):
        if stack not in params:
            continue
        sp = params[stack]
        for i, blk in enumerate(sp["block"]):
            base = f"{stack}.block.{i}"
            sa = blk["self_attention_layer"]
            attn(f"{base}.self_attention_layer", sa["self_attention"],
                 "self_attention")
            put(f"{base}.self_attention_layer.layer_norm.weight",
                sa["layer_norm"]["weight"])
            if "cross_attention_layer" in blk:
                ca = blk["cross_attention_layer"]
                attn(f"{base}.cross_attention_layer", ca["cross_attention"],
                     "cross_attention")
                put(f"{base}.cross_attention_layer.layer_norm.weight",
                    ca["layer_norm"]["weight"])
            ff = blk["ff_layer"]
            for name, t in ff["act"].items():
                put(f"{base}.ff_layer.act.{name}.weight", t, True)
            put(f"{base}.ff_layer.wo.weight", ff["wo"], True)
            put(f"{base}.ff_layer.layer_norm.weight",
                ff["layer_norm"]["weight"])
        put(f"{stack}.final_layer_norm.weight",
            sp["final_layer_norm"]["weight"])
    put("shared.weight", params["shared"]["embedding"])
    if "lm_head" in params:
        put("lm_head.weight", params["lm_head"], True)
    return out


def validate_params(params: Params, config: FlashT5Config) -> None:
    """Shape-check an imported tree against a config; raises on mismatch.
    An encoder-only tree (no `decoder`) is checked as one."""
    d, v = config.d_model, config.vocab_size
    inner = config.inner_dim
    emb = params["shared"]["embedding"]
    if tuple(emb.shape) != (v, d):
        raise ValueError(f"shared.embedding {tuple(emb.shape)} != {(v, d)}")
    for stack, n in (("encoder", config.num_layers),
                     ("decoder", config.num_decoder_layers)):
        if stack == "decoder" and stack not in params:
            continue
        blocks = params[stack]["block"]
        if len(blocks) != n:
            raise ValueError(f"{stack} has {len(blocks)} blocks, config "
                             f"says {n}")
        wq = blocks[0]["self_attention_layer"]["self_attention"]["Wq"]
        if tuple(wq.shape) != (d, inner):
            raise ValueError(f"{stack} Wq {tuple(wq.shape)} != "
                             f"{(d, inner)}")
