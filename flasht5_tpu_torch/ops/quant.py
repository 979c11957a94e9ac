"""Weight-only INT8 / FP8 quantization and the fused dequant matmul.

`quant_matmul` runs the CUDA kernel `csrc/quant_matmul.cu`, which replaces
the Pallas kernel `flasht5_tpu/ops/quant.py::_qmm_kernel` (its source says
what bounds it and how). Unlike the JAX wrapper, which quietly takes the XLA
path for shapes its kernel cannot tile, this wrapper raises for them. At
decode (M <= 32) the kernel splits K over a cluster of CTAs and their warps
as `decode_plan` says, computed once per weight shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from flasht5_tpu_torch import runtime

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_K_TILE = 32

# the decode form (csrc/quant_matmul.cu::qmm_decode_kernel, M <= 32)
_DECODE_ROWS = 32        # rows of x at most
_DECODE_COLS = 128       # output columns of a CTA
_DECODE_STEP = 16        # K rows of one mma step
_DECODE_CTAS = 256       # about two CTAs for each of the H100's 132 SMs
_MAX_SPLITS = 8          # CTAs of a cluster (the portable size)
_MAX_WARPS = 8


class QuantizedTensor(NamedTuple):
    """Symmetric weight-only tensor: w ~= qvalues * expand(scales).

    qvalues: (in, out) int8 or float8_e4m3fn; scales: (groups, out) float32,
    `groups` dividing `in` (1 = per-output-channel scales)."""
    qvalues: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self):
        return self.qvalues.shape

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.qvalues.to(device), self.scales.to(device))


def _group_absmax(w32: torch.Tensor, group_size: Optional[int]) -> torch.Tensor:
    k, n = w32.shape
    if group_size is None or group_size >= k:
        return w32.abs().amax(dim=0, keepdim=True)
    if k % group_size:
        raise ValueError(f"group_size {group_size} does not divide {k}")
    return w32.reshape(k // group_size, group_size, n).abs().amax(dim=1)


def _expand_scales(scales: torch.Tensor, k: int) -> torch.Tensor:
    g, n = scales.shape
    if g == 1:
        return scales
    return scales[:, None, :].expand(g, k // g, n).reshape(k, n)


def quantize_int8(w: torch.Tensor, group_size: Optional[int] = None
                  ) -> QuantizedTensor:
    """Symmetric INT8, per output channel or per `group_size` input rows."""
    w32 = w.float()
    absmax = _group_absmax(w32, group_size)
    scales = torch.where(absmax > 0, absmax / 127.0, 1.0)
    s_full = _expand_scales(scales, w32.shape[0])
    q = torch.clamp(torch.round(w32 / s_full), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scales)


def quantize_fp8(w: torch.Tensor, group_size: Optional[int] = None
                 ) -> QuantizedTensor:
    """FP8 e4m3: each column (or group) scaled so its absmax maps to 448."""
    w32 = w.float()
    absmax = _group_absmax(w32, group_size)
    scales = torch.where(absmax > 0, absmax / 448.0, 1.0)
    s_full = _expand_scales(scales, w32.shape[0])
    return QuantizedTensor((w32 / s_full).to(torch.float8_e4m3fn), scales)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    s_full = _expand_scales(qt.scales, qt.qvalues.shape[0])
    return (qt.qvalues.float() * s_full).to(dtype)


def quant_matmul_ref(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Oracle of the JAX package: x @ dequant(w) in x's dtype."""
    return torch.matmul(x, dequantize(qt, x.dtype))


def quant_matmul_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: x rounded to bf16, the
    stored weight values unscaled, fp32 sums, scales applied to the sum
    (per scale group), output in x's dtype."""
    k_dim = x.shape[-1]
    xb = x.reshape(-1, k_dim).to(torch.bfloat16).float()
    w = qt.qvalues.float()
    groups = qt.scales.shape[0]
    if groups == 1:
        acc = torch.matmul(xb, w) * qt.scales
    else:
        gs = k_dim // groups
        acc = sum(torch.matmul(xb[:, g * gs:(g + 1) * gs],
                               w[g * gs:(g + 1) * gs]) * qt.scales[g]
                  for g in range(groups))
    return acc.to(x.dtype).reshape(*x.shape[:-1], w.shape[1])


@functools.lru_cache(maxsize=None)
def decode_plan(k_dim: int, n_dim: int) -> Tuple[int, int, int]:
    """(splits, warps, k_piece) of the decode form for a (K, N) weight.

    A CTA owns 128 output columns; `splits` CTAs of one cluster split K
    between them and each CTA's `warps` warps split its share again, so K
    is cut into splits * warps pieces of `k_piece` rows (a multiple of 16,
    the mma's depth; the last pieces may be shorter or empty). `splits` is
    the least power of two (at most 8) that gives about two CTAs an SM, as
    far as K has 4 warps of 16 rows for each; `warps` (at most 8) cuts each
    CTA's share into pieces of at least 16 rows: the lm_head (512, 32768)
    takes 256 CTAs of 8 warps and no cluster, a 512-wide projection
    clusters of 8. A piece's boundaries need not fall on scale-group
    boundaries: the kernel folds group scales in at each group's end and
    at each piece's end."""
    col_blocks = -(-n_dim // _DECODE_COLS)
    splits = 1
    while (splits < _MAX_SPLITS and col_blocks * splits < _DECODE_CTAS
           and 2 * splits * 4 * _DECODE_STEP <= k_dim):
        splits *= 2
    warps = max(1, min(_MAX_WARPS, k_dim // (_DECODE_STEP * splits)))
    per = -(-k_dim // (splits * warps))
    k_piece = -(-per // _DECODE_STEP) * _DECODE_STEP
    return splits, warps, k_piece


def decode_pieces(k_dim: int, n_dim: int):
    """The K rows [begin, end) of each piece of the decode form, in the
    order the kernel adds them (cluster rank, then warp)."""
    splits, warps, k_piece = decode_plan(k_dim, n_dim)
    return [(min(k_dim, p * k_piece), min(k_dim, (p + 1) * k_piece))
            for p in range(splits * warps)]


def _lib():
    lib = runtime.kernel_library("quant_matmul")
    fn = lib.ft5_quant_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def quant_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Fused dequant + matmul: x (..., K) @ qt (K, N) -> (..., N) in x's
    dtype. CUDA tensors go to the kernel, CPU tensors to
    `quant_matmul_plain`; shapes or types the kernel does not take raise."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qt)
    k_dim, n_dim = qt.qvalues.shape
    groups = qt.scales.shape[0]
    if not x.is_cuda or qt.qvalues.device != x.device \
            or qt.scales.device != x.device:
        raise ValueError("quant_matmul: x and the weight on one CUDA device")
    if (x.dtype not in _X_CODES
            or qt.qvalues.dtype not in (torch.int8, torch.float8_e4m3fn)
            or qt.scales.dtype != torch.float32):
        raise TypeError(f"quant_matmul: x {x.dtype}, w {qt.qvalues.dtype}, "
                        f"scales {qt.scales.dtype}")
    if (x.shape[-1] != k_dim or qt.scales.shape != (groups, n_dim)
            or k_dim % groups or k_dim % _K_TILE
            or (k_dim // groups) % _K_TILE):
        raise ValueError(f"quant_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(qt.qvalues.shape)}, scales "
                         f"{tuple(qt.scales.shape)}; K and the group size "
                         f"must be multiples of {_K_TILE}")
    lib, fn = _lib()
    x2 = x.reshape(-1, k_dim).contiguous()
    w = qt.qvalues.contiguous()
    scales = qt.scales.contiguous()
    out = torch.empty((x2.shape[0], n_dim), dtype=x.dtype, device=x.device)
    plan = (decode_plan(k_dim, n_dim) if x2.shape[0] <= _DECODE_ROWS
            else (0, 0, 0))
    rc = fn(runtime.ptr(x2), runtime.ptr(w), runtime.ptr(scales),
            runtime.ptr(out), x2.shape[0], n_dim, k_dim, k_dim // groups,
            _X_CODES[x.dtype], int(w.dtype == torch.float8_e4m3fn), *plan,
            runtime.stream_handle(x))
    runtime.check_launch(lib, rc, "quant_matmul")
    quant_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n_dim)


quant_matmul.launches = 0


# ---------------------------------------------------------------------------
# KV-cache quantization (per-position, per-head scales)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric INT8 over the last (head_dim) axis: (int8 (..., D),
    fp32 scales (..., 1))."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scales = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(x32 / scales), -127, 127).to(torch.int8)
    return q, scales


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scales).to(dtype)
