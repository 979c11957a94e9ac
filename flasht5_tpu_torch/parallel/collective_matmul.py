"""Collective matmuls over the tensor group, and the tensor-parallel
regions' autograd functions.

The counterpart of `flasht5_tpu/parallel/collective_matmul.py` (:32-78):

- `allgather_matmul`:     y = all_gather(x) @ w, chunk by chunk while the
                          shards of x travel the ring;
- `matmul_reducescatter`: this rank's rows of sum_r(x_r @ w_r), the partial
                          sums travelling the ring.

Each hop is a `dist.batch_isend_irecv` pair to the next rank and from the
previous one, issued before the product it can overlap with; each product
goes through `models/t5.py::_matmul`, so a QuantizedTensor weight runs the
`quant_matmul` kernel. Neither is differentiable: the model's row-parallel
product (`row_parallel_ring`) gives the pair a backward of its own.

Megatron's pair of functions (`copy_to_tensor_group`: identity forward,
all-reduce backward, at the input of each column-split product;
`reduce_from_tensor_group`: all-reduce forward, identity backward, after
each row-split product) make the gradients of the whole leaves (norms,
embedding) come out whole on every tensor rank. The JAX step reaches the
same numbers through `loss / t` and a psum of those leaves' gradients
(tp_step.py:43-61, :115-131); the port uses this scheme alone.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _ring(group):
    """(t, this rank's index, the next rank's and the previous rank's
    global ranks) of the ring over `group`."""
    t = dist.get_world_size(group)
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % t)
    prv = dist.get_global_rank(group, (idx - 1) % t)
    return t, idx, nxt, prv


def _hop(send: torch.Tensor, recv: torch.Tensor, nxt: int, prv: int, group):
    """Start sending `send` to the next rank and receiving `recv` from the
    previous one; returns the requests to wait on."""
    return dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group=group),
        dist.P2POp(dist.irecv, recv, prv, group=group)])


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


def allgather_matmul(x_local: torch.Tensor, w, group) -> torch.Tensor:
    """all_gather(x, group) @ w with the ring: x_local (m/t, k) this rank's
    rows, w (k, n) whole (or a QuantizedTensor); the (m, n) product on
    every rank."""
    from flasht5_tpu_torch.models.t5 import _matmul
    t, idx, nxt, prv = _ring(group)
    chunk = x_local.shape[0]
    out = None
    buf = x_local.contiguous()
    for s in range(t):
        src = (idx - s) % t              # whose rows buf holds
        reqs = None
        if s < t - 1:
            nxt_buf = torch.empty_like(buf)
            reqs = _hop(buf, nxt_buf, nxt, prv, group)
        piece = _matmul(buf, w)
        if out is None:
            out = piece.new_empty((chunk * t, piece.shape[1]))
        out[src * chunk:(src + 1) * chunk] = piece
        if reqs is not None:
            _wait(reqs)
            buf = nxt_buf
    return out


def matmul_reducescatter(x_local: torch.Tensor, w_local,
                         group) -> torch.Tensor:
    """Rows [idx m/t, (idx+1) m/t) of sum over the group of x_local @
    w_local: x_local (m, k/t) activations split over k, w_local (k/t, n)
    the matching rows of w (or a QuantizedTensor). The partial sums
    travel in f32 and the result takes x's dtype."""
    from flasht5_tpu_torch.models.t5 import _matmul
    t, idx, nxt, prv = _ring(group)
    m = x_local.shape[0]
    if m % t:
        raise ValueError(f"{m} rows do not split over {t} ranks")
    chunk = m // t

    def part(s):
        # the sum in hand at step s lands, after its t-1-s remaining hops,
        # on rank idx + t-1-s: this step adds that rank's rows
        dest = (idx + t - 1 - s) % t
        return _matmul(x_local[dest * chunk:(dest + 1) * chunk],
                       w_local).float()

    acc = part(0)
    for s in range(1, t):
        recv = torch.empty_like(acc)
        reqs = _hop(acc, recv, nxt, prv, group)
        nxt_part = part(s)               # overlaps the hop
        _wait(reqs)
        acc = recv + nxt_part
    return acc.to(x_local.dtype)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over `group`."""
    return _CopyToGroup.apply(x, group)


def reduce_from_tensor_group(x: torch.Tensor, group) -> torch.Tensor:
    """x all-reduced over `group`; the gradient passed through."""
    return _ReduceFromGroup.apply(x, group)


def _ring_sum(x2d, w, group) -> torch.Tensor:
    """sum over the group of x2d @ w, on every rank: the ring
    reduce-scatter, then an all-gather of the shards."""
    shard = matmul_reducescatter(x2d, w, group)
    parts = [torch.empty_like(shard)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, shard, group=group)
    return torch.cat(parts)


class _RowParallelRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, group):
        ctx.save_for_backward(x2d, w)
        return _ring_sum(x2d, w, group)

    @staticmethod
    def backward(ctx, g):
        # all-reduce forward, identity backward, as reduce_from_tensor_group
        x2d, w = ctx.saved_tensors
        gx = g @ w.to(g.dtype).t() if ctx.needs_input_grad[0] else None
        gw = ((x2d.t() @ g).to(w.dtype) if ctx.needs_input_grad[1]
              else None)
        return gx, gw, None


def row_parallel_ring(x2d: torch.Tensor, w, group) -> torch.Tensor:
    """The row-split product summed over `group`, as the ring
    reduce-scatter and an all-gather (the rows must split over the
    group). A QuantizedTensor weight runs forward only."""
    from flasht5_tpu_torch.ops.quant import QuantizedTensor
    if isinstance(w, QuantizedTensor):
        return _ring_sum(x2d, w, group)
    return _RowParallelRing.apply(x2d, w, group)
