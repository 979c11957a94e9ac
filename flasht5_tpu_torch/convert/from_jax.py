"""Carry a parameter tree of the JAX package across to the port, and back.

`params_from_numpy` takes the JAX tree as nested dicts and lists of numpy
arrays under the JAX package's key names (which are the port's), with each
quantized weight given as a `(qvalues, scales)` pair. FP8 and bf16 arrays
arrive as `ml_dtypes` arrays and cross through a uint8 or uint16 view, bit
for bit. `params_to_numpy` is its inverse for plain (unquantized) trees, so a
tree trained by the port can be compared with the JAX package's. Nothing
here imports JAX: the caller flattens its tree to numpy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.ops.quant import QuantizedTensor


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    elif a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_numpy(tree: Any, *, device=None) -> Any:
    """The port's parameters (on `device`, default `cuda`) from a numpy tree
    of JAX parameters; `(qvalues, scales)` pairs become QuantizedTensors."""
    device = runtime.resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, tuple) and len(node) == 2 and all(
                isinstance(a, np.ndarray) for a in node):
            return QuantizedTensor(_tensor(node[0], device),
                                   _tensor(node[1], device))
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _tensor(node, device)

    return conv(tree)


def params_to_numpy(tree: Any) -> Any:
    """A numpy tree (nested dicts and lists) of the port's plain parameters;
    bf16 tensors become float32 arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, QuantizedTensor):
        raise TypeError("params_to_numpy takes plain tensors, not "
                        "QuantizedTensors")
    t = tree.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()
