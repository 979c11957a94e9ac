"""Parameter-tree quantization.

Turns every large linear weight (Wq, Wk, Wv, o, wi, wi_0, wi_1, wo and the
lm_head) into a per-channel or group-wise INT8/FP8 `QuantizedTensor`, with
the same key rule as the JAX package (`flasht5_tpu/quantize.py:26-35`).
Norms, positional tables and the embedding stay as they are; the model's
matmul dispatch (`models/t5.py::_matmul`) sends quantized weights to the
dequant-matmul kernel.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import torch

from flasht5_tpu_torch.ops.quant import (QuantizedTensor, dequantize,
                                         quantize_fp8, quantize_int8)

_QUANT_KEYS = ("'Wq'", "'Wk'", "'Wv'", "['o']", "'wi'", "'wi_0'", "'wi_1'",
               "'wo'", "lm_head")


def _should_quantize(path_str: str, leaf) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim != 2:
        return False
    if "relative_attention_bias" in path_str or "pe_encoding" in path_str:
        return False
    return any(k in path_str for k in _QUANT_KEYS)


def _map_with_path(fn, tree, path=""):
    """Map `fn(path, leaf)` over nested dicts and lists; the path string is
    written as JAX's `keystr` writes it (['a']['b'][0])."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{path}[{i}]")
                for i, v in enumerate(tree)]
    return fn(path, tree)


def quantize_params(params: Any, mode: str = "int8",
                    group_size: Optional[int] = None) -> Any:
    """Quantize all eligible linears to INT8 or FP8; returns a new tree that
    shares the untouched leaves with `params`."""
    quantizer = {"int8": quantize_int8, "fp8": quantize_fp8}[mode]
    fallbacks = []

    def leaf(path, x):
        if isinstance(x, QuantizedTensor) or not _should_quantize(path, x):
            return x
        if group_size is not None:
            if x.shape[0] % group_size == 0:
                return quantizer(x, group_size)
            fallbacks.append(path)
        return quantizer(x)

    out = _map_with_path(leaf, params)
    if fallbacks:
        warnings.warn(
            f"quantize_params: {len(fallbacks)} weight(s) with input dim not "
            f"divisible by group_size={group_size} fell back to per-channel "
            f"scales (first: {fallbacks[0]})", stacklevel=2)
    return out


def count_group_fallbacks(params: Any, group_size: int) -> int:
    """Number of quantizable weights whose input dim is not divisible by
    `group_size` (these fall back to per-channel scales in
    quantize_params)."""
    n = 0

    def leaf(path, x):
        nonlocal n
        if _should_quantize(path, x) and x.shape[0] % group_size != 0:
            n += 1
        return x

    _map_with_path(leaf, params)
    return n


def dequantize_params(params: Any, dtype: Optional[torch.dtype] = None
                      ) -> Any:
    """Every QuantizedTensor back to a plain tensor (in `dtype`, default its
    scales' dtype); other leaves unchanged."""
    def leaf(path, x):
        if isinstance(x, QuantizedTensor):
            return dequantize(x, dtype or x.scales.dtype)
        return x

    return _map_with_path(leaf, params)


def quantized_bytes(params: Any) -> int:
    """Bytes of the tree's leaves: a QuantizedTensor's one-byte values and
    f32 scales, every other tensor at its dtype's size."""
    total = 0

    def leaf(path, x):
        nonlocal total
        if isinstance(x, QuantizedTensor):
            total += x.qvalues.numel() + x.scales.numel() * 4
        else:
            total += x.numel() * x.element_size()
        return x

    _map_with_path(leaf, params)
    return total
