"""The T5 bucket table's gradient through the materialized bias, in CUDA.

Replaces no Pallas kernel: the JAX package leaves the gradient of the
bias's `jnp.take` (`flasht5_tpu/positional.py::t5_relative_bias`) to XLA's
scatter-add. In PyTorch that backward is autograd's sorting
`index_put_(accumulate=True)`; `t5_bias_grad` takes its place as the
backward of `positional._BucketGather`.

dW[b, h] is the sum of dbias[h, i, j] over the (i, j) whose bucket is b.
Bound on the H100: bytes (one read of the f32 dbias and of the int32 bucket
map). The design (`csrc/t5_bias_grad.cu` says more): per-thread bins in
shared memory over a chunk of the bucket map, summed across threads in a
fixed order into a row a CTA, then the rows summed in order by a second
launch; f32 sums, no global float atomics, the same bits on every run.
"""

from __future__ import annotations

import ctypes

import torch

from flasht5_tpu_torch import runtime
from flasht5_tpu_torch.utils.profiling import span

MAX_BUCKETS = 256       # the largest table the kernel takes (its bins)
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def t5_bias_grad_plain(grad: torch.Tensor, buckets: torch.Tensor,
                       num_buckets: int) -> torch.Tensor:
    """The gradient of `table[buckets]` permuted to (1, H, M, N), as
    autograd's `index_put_(accumulate=True)` computes it: (num_buckets, H)
    in grad's dtype."""
    h = grad.shape[1]
    rows = grad[0].reshape(h, -1).t()                   # (M N, H)
    out = torch.zeros((num_buckets, h), dtype=grad.dtype, device=grad.device)
    return out.index_put_((buckets.reshape(-1).long(),), rows,
                          accumulate=True)


def t5_bias_grad(grad: torch.Tensor, buckets: torch.Tensor,
                 num_buckets: int) -> torch.Tensor:
    """dW (num_buckets, H): the (1, H, M, N) bias gradient `grad` summed by
    the (M, N) bucket map `buckets`. A CUDA tensor takes the kernel (f32
    out) and at most `MAX_BUCKETS` buckets; a CPU tensor takes
    `t5_bias_grad_plain`. Opens a `t5_bias.grad` span (`route`: "kernel" or
    "plain"; `elements`: H M N; `buckets`)."""
    _, h, m_len, n_len = grad.shape
    if grad.shape[0] != 1 or buckets.shape != (m_len, n_len):
        raise ValueError(f"t5_bias_grad: grad {tuple(grad.shape)}, buckets "
                         f"{tuple(buckets.shape)}")
    if grad.is_cuda:
        if buckets.device != grad.device:
            raise ValueError("t5_bias_grad: all inputs on one CUDA device")
        if not 1 <= num_buckets <= MAX_BUCKETS:
            raise ValueError(f"t5_bias_grad: {num_buckets} buckets, the "
                             f"kernel takes 1..{MAX_BUCKETS}")
    route = "kernel" if grad.is_cuda else "plain"
    with span("t5_bias.grad", route=route, elements=h * m_len * n_len,
              buckets=num_buckets):
        if route == "plain":
            return t5_bias_grad_plain(grad, buckets, num_buckets)
        lib = runtime.kernel_library("t5_bias_grad")
        fn, parts_fn = lib.ft5_t5_bias_grad, lib.ft5_t5_bias_grad_parts
        if fn.argtypes is None:
            fn.argtypes, fn.restype = _ARGS, ctypes.c_int
            parts_fn.argtypes = [ctypes.c_int] * 2
            parts_fn.restype = ctypes.c_int
        grad = grad.float().contiguous()
        buckets = buckets.to(torch.int32).contiguous()
        part = torch.empty((h, parts_fn(m_len, n_len), num_buckets),
                           dtype=torch.float32, device=grad.device)
        dw = torch.empty((num_buckets, h), dtype=torch.float32,
                         device=grad.device)
        rc = fn(runtime.ptr(grad), runtime.ptr(buckets), runtime.ptr(part),
                runtime.ptr(dw), h, m_len, n_len, num_buckets,
                runtime.stream_handle(grad))
        runtime.check_launch(lib, rc, "t5_bias_grad")
        t5_bias_grad.launches += 1
        return dw


t5_bias_grad.launches = 0
