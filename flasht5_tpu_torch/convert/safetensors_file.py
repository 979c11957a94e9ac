"""Reader and writer of the safetensors format, in numpy and torch only.

A file is an 8-byte little-endian header length, a JSON header mapping
each tensor's name to its dtype, shape and byte range (`data_offsets`,
from the end of the header), an optional `__metadata__` of strings, and
the raw little-endian bytes. The types: F32, F16, BF16, I8, I32, I64 and
F8_E4M3. Numpy has no bf16 or fp8 type, so `load_file(path, "np")` widens
those two to float32 (exactly); `"pt"` keeps every type.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional, Union

import numpy as np
import torch

_TORCH = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I8": torch.int8, "I32": torch.int32, "I64": torch.int64,
          "F8_E4M3": torch.float8_e4m3fn}
_CODES = {dt: code for code, dt in _TORCH.items()}
_NUMPY = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
          np.dtype(np.int8): "I8", np.dtype(np.int32): "I32",
          np.dtype(np.int64): "I64"}
_ALIGN = 8


def _as_tensor(value: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous()
    a = np.ascontiguousarray(value)
    if a.dtype.name == "bfloat16":      # an ml_dtypes array, bit for bit
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if a.dtype not in _NUMPY:
        raise TypeError(f"safetensors: no code for numpy dtype {a.dtype}")
    return torch.from_numpy(a.copy())


def save_file(tensors: Dict[str, Union[np.ndarray, torch.Tensor]],
              path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (numpy arrays or torch tensors) to `path`."""
    header, blobs, offset = {}, [], 0
    # wider types first, so that every tensor starts at a multiple of its
    # element size (as the safetensors package orders them)
    items = sorted(((name, _as_tensor(value))
                    for name, value in tensors.items()),
                   key=lambda kv: (-kv[1].element_size(), kv[0]))
    for name, t in items:
        if t.dtype not in _CODES:
            raise TypeError(f"safetensors: no code for {name}'s {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + raw.size]}
        blobs.append(raw)
        offset += raw.size
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % _ALIGN)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw.tobytes())


def read_header(path: str) -> dict:
    """The JSON header of a safetensors file (with `__metadata__`, if any)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n))


def load_file(path: str, framework: str = "pt"
              ) -> Dict[str, Union[np.ndarray, torch.Tensor]]:
    """{name: tensor} of a safetensors file, as CPU torch tensors
    (`framework="pt"`) or numpy arrays (`"np"`; bf16 and fp8 as float32).
    Raises on a malformed header or byte range."""
    if framework not in ("pt", "np"):
        raise ValueError(f"framework {framework!r}: 'pt' or 'np'")
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _TORCH.get(info["dtype"])
        if dtype is None:
            raise TypeError(f"{path}: {name} has unsupported dtype "
                            f"{info['dtype']}")
        start, end = info["data_offsets"]
        shape = list(info["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= start <= end <= len(data) or \
                end - start != int(np.prod(shape, dtype=np.int64)) * itemsize:
            raise ValueError(f"{path}: {name}'s byte range {start}..{end} "
                             f"does not hold {info['dtype']} {shape}")
        t = torch.frombuffer(data, dtype=torch.uint8, count=end - start,
                             offset=start) if end > start else \
            torch.empty(0, dtype=torch.uint8)
        if start % itemsize:
            t = t.clone()               # a misaligned range: copy it out
        t = t.view(dtype).reshape(shape)
        if framework == "np":
            t = t.float() if dtype in (torch.bfloat16,
                                       torch.float8_e4m3fn) else t
            out[name] = t.numpy()
        else:
            out[name] = t
    return out
