"""Carry a parameter tree of the JAX package across to the port.

`params_from_numpy` takes the JAX tree as nested dicts and lists of numpy
arrays under the JAX package's key names (which are the port's), with each
quantized weight given as a `(qvalues, scales)` pair. FP8 weights arrive as
`ml_dtypes` float8_e4m3fn arrays and cross through a uint8 view, bit for
bit. Nothing here imports JAX: the caller flattens its tree to numpy.
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
