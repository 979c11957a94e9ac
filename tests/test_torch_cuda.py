"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker `cuda`) and skips without one.
The file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py sets JAX up.)

Tolerances: 1e-4 where the kernel and its plain version compute in f32 and
differ only in summation order and the `exp` implementation; in bf16, one
bf16 ulp of the output (2^-8 relative: rtol 1e-2, with atol 1e-2 for values
near 0), and 2e-2 where P is also rounded to bf16 at values that differ
(the kernel's online softmax rescales tiles that the plain version does in
one pass).

The paged decode kernel: 1e-4 for f32 and int8 pools (both compute in f32);
a bf16 pool rounds q, K, P and V to bf16, and the kernel rounds P against
each warp's running maximum where the plain version uses one maximum, so
2e-2 for its output; m and l are fp32 sums of the same products in both:
1e-4.

The backward kernels: f32 gradients within 1e-3 of the largest entry of
each output (the kernels sum over up to 1024 keys or rows, and dW over
millions of scores, in another order than the plain version); in bf16, P and
dS are rounded to bf16 at values that may differ by an f32 ulp, so 3e-2 of
the largest entry. dW and the rms_norm weight gradient are fp32 sums in both
dtypes: 1e-3 of the largest entry. The bias kernels' dbias is dS itself, in
fp32 for both input types, summed over the bias's broadcast axes by the same
PyTorch sum on both sides: 1e-3 of its largest entry.

The T5 bucket table's gradient: f32 sums of the same dbias entries in
another order than `index_put_`'s, each bucket's within 1e-6 of the sum of
its entries' magnitudes (plus 1e-6).

The fused lm_head+CE kernels: lse to 1e-5 relative plus 1e-5 (f32 sums of
the same products in another order), the row sum of the logits to 1e-6 of
the row's sum of |logits|; dx and dW to 1e-4 of their largest entry in f32
and, with bf16 activations (dlogits rounded to bf16 at values that may
differ by an f32 ulp, dx rounded to bf16), one bf16 ulp of each entry plus
1e-3 of the largest.
"""

import pytest
import torch

from flasht5_tpu_torch import positional, runtime
from flasht5_tpu_torch.inference import paged_kv
from flasht5_tpu_torch.ops import (cross_entropy, decode_attention,
                                   flash_attention, flash_attention_rpe,
                                   fused_linear_ce, paged_attention, quant,
                                   rmsnorm, t5_bias_grad)
from flasht5_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runtime.build_kernels()     # the missing libraries, one nvcc each, at once
    torch.manual_seed(0)
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(8, 1, 512), (8, 512, 512), (300, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel(dev, shape, dtype):
    x = torch.randn(shape, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], device=dev)).to(dtype)
    y, rstd = rmsnorm.rms_norm_fwd(x, w)
    y0, rstd0 = rmsnorm.rms_norm_plain(x, w)
    torch.testing.assert_close(rstd, rstd0, rtol=1e-5, atol=1e-6)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)


# bf16 takes the tensor-core forward (128-row query tiles), f32 the
# CUDA-core one (64-row tiles): M and N off both tiles (200 x 1000, 1 x
# 1024, 1030 x 77, where causal rows see no key), and D 32, 64 and 128
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("m_len,n_len,d", [(512, 512, 64), (100, 300, 64),
                                           (300, 100, 64), (77, 77, 32),
                                           (200, 1000, 64), (1, 1024, 64),
                                           (1030, 77, 64), (256, 1024, 128),
                                           (130, 70, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_rpe_kernel(dev, causal, m_len, n_len, d, dtype):
    q = torch.randn((2, 8, m_len, d), device=dev).to(dtype)
    k = torch.randn((2, 8, n_len, d), device=dev).to(dtype)
    v = torch.randn((2, 8, n_len, d), device=dev).to(dtype)
    w = torch.randn((32, 8), device=dev)
    kw = dict(causal=causal, bidirectional=not causal, sm_scale=d ** -0.5)
    o, lse = flash_attention_rpe.flash_attention_rpe_fwd(q, k, v, w, **kw)
    o0, lse0 = flash_attention_rpe.flash_attention_rpe_plain(q, k, v, w,
                                                              **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse0, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("m_len,n_len,d", [(256, 1024, 64), (200, 1000, 32),
                                           (1030, 77, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_no_bias_kernel(dev, causal, m_len, n_len, d, dtype):
    """The forward without a table (the decoder's cross-attention)."""
    q = torch.randn((2, 8, m_len, d), device=dev).to(dtype)
    k = torch.randn((2, 8, n_len, d), device=dev).to(dtype)
    v = torch.randn((2, 8, n_len, d), device=dev).to(dtype)
    kw = dict(causal=causal, sm_scale=d ** -0.5)
    o, lse = flash_attention_rpe.flash_attention_rpe_fwd(q, k, v, None, **kw)
    o0, lse0 = flash_attention_rpe.flash_attention_rpe_plain(q, k, v, None,
                                                              **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse0, rtol=1e-4, atol=1e-4)


# M <= 32 with N % 16 == 0 takes the decode form; above it bf16 x with
# N % 16 == 0 takes the TMA + wgmma form (128 x 128 tiles, K steps of 64)
# and the rest the mma.sync form. The cases cover the three, their ragged
# edges (M 129 and 4097, N 96 and 2050, K 96: a multiple of 32, not of
# 64) and the boundaries between, with per-channel scales and groups of
# 32, 64, 128 and 256 (smaller and larger than a K step); a group size
# that does not divide K is no case (the weight cannot be quantized so).
_QMM_SHAPES = [(8, 512, 512), (8, 512, 2048), (8, 2048, 512),
               (8, 512, 32768), (20, 2048, 100), (32, 512, 512),
               (1, 4096, 512), (8, 512, 90), (33, 512, 512),
               (4096, 512, 2048), (64, 2048, 512), (4096, 2048, 512),
               (77, 512, 96), (129, 512, 512), (4097, 512, 2048),
               (129, 512, 96), (300, 2048, 2050), (200, 96, 512)]
_QMM_MODES = [("int8", None), ("int8", 128), ("fp8", None), ("int8", 32),
              ("int8", 64), ("int8", 256), ("fp8", 64)]


@pytest.mark.parametrize("m,k_dim,n,mode,group_size", [
    (m, k, n, mode, g) for m, k, n in _QMM_SHAPES for mode, g in _QMM_MODES
    if g is None or g >= k or k % g == 0])
def test_quant_matmul_kernel(dev, m, k_dim, n, mode, group_size):
    w = torch.randn((k_dim, n), device=dev) * 0.05
    qt = {"int8": quant.quantize_int8, "fp8": quant.quantize_fp8}[mode](
        w, group_size)
    x = torch.randn((m, k_dim), device=dev).to(torch.bfloat16)
    got = quant.quant_matmul(x, qt).float()
    want = quant.quant_matmul_plain(x, qt).float()
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    x32 = x.float()
    torch.testing.assert_close(quant.quant_matmul(x32, qt),
                               quant.quant_matmul_plain(x32, qt),
                               rtol=1e-4, atol=1e-4)


# The decode form (M <= 32, N % 16 == 0): K split over a cluster of CTAs
# and their warps (`quant.decode_plan`); M 1, 8, 20 and 32 (one to four CTA
# rows of 8), K 512, 2048 and 4096, int8 and fp8, per-channel scales and
# groups of 32-256 whose boundaries fall inside a K piece or a piece's
# inside a group (K 512: pieces of 16 rows), bf16 and f32 x
_DECODE_MODES = [("int8", None), ("fp8", None), ("int8", 32), ("int8", 64),
                 ("int8", 128), ("int8", 256), ("fp8", 64)]


@pytest.mark.parametrize("m", [1, 8, 20, 32])
@pytest.mark.parametrize("k_dim,n", [(512, 512), (2048, 512), (4096, 1024),
                                     (512, 32768)])
@pytest.mark.parametrize("mode,group_size", _DECODE_MODES)
def test_quant_matmul_decode_form(dev, m, k_dim, n, mode, group_size):
    w = torch.randn((k_dim, n), device=dev) * 0.05
    qt = {"int8": quant.quantize_int8, "fp8": quant.quantize_fp8}[mode](
        w, group_size)
    x = torch.randn((m, k_dim), device=dev).to(torch.bfloat16)
    torch.testing.assert_close(quant.quant_matmul(x, qt).float(),
                               quant.quant_matmul_plain(x, qt).float(),
                               rtol=1e-2, atol=1e-2)
    x32 = x.float()
    torch.testing.assert_close(quant.quant_matmul(x32, qt),
                               quant.quant_matmul_plain(x32, qt),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k_dim,n,group_size", [(512, 32768, None),
                                                (2048, 512, 64),
                                                (512, 512, 256)])
def test_quant_matmul_decode_is_deterministic(dev, k_dim, n, group_size):
    """Bit-equal over three runs, and a K split left out of the sum (its
    weight rows zeroed, the planted fault of the on-card check) moves the
    output."""
    qt = quant.quantize_int8(torch.randn((k_dim, n), device=dev) * 0.05,
                             group_size)
    x = torch.randn((8, k_dim), device=dev).to(torch.bfloat16)
    runs = [quant.quant_matmul(x, qt) for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    begin, end = [p for p in quant.decode_pieces(k_dim, n) if p[1] > p[0]][-1]
    qvalues = qt.qvalues.clone()
    qvalues[begin:end] = 0
    dropped = quant.quant_matmul(x, quant.QuantizedTensor(qvalues, qt.scales))
    assert (dropped.float() - runs[0].float()).abs().max() > 0.1


def test_quant_matmul_refuses_untileable_k(dev):
    qt = quant.quantize_int8(torch.randn((48, 64), device=dev))
    with pytest.raises(ValueError, match="multiples of 32"):
        quant.quant_matmul(torch.randn((4, 48), device=dev), qt)


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("L", [66, 512, 1000])
@pytest.mark.parametrize("with_bias", [False, True])
def test_decode_attention_kernel(dev, kv, L, with_bias):
    b, h, d = 8, 8, 64
    q = torch.randn((b, h, d), device=dev).to(
        torch.float32 if kv == "f32" else torch.bfloat16)
    k = torch.randn((b, h, L, d), device=dev)
    v = torch.randn((b, h, L, d), device=dev)
    if kv == "int8":
        (kq, ks), (vq, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
        args = [kq, vq, ks, vs]
    else:
        dt = torch.float32 if kv == "f32" else torch.bfloat16
        args = [k.to(dt), v.to(dt)]
    lengths = torch.randint(0, L + 1, (b,), device=dev, dtype=torch.int32)
    lengths[0] = 0
    bias = torch.randn((b, h, L), device=dev) if with_bias else None
    got = decode_attention.decode_attention(q, *args, lengths=lengths,
                                            bias=bias).float()
    want = decode_attention.decode_attention_plain(
        q, *args, lengths=lengths, bias=bias).float()
    # one chunk (L <= 512): the plain version's rounding points are the
    # kernel's; beyond, P is rounded against a running maximum
    tol = 1e-4 if kv == "f32" else (1e-2 if L <= 512 else 2e-2)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.all(got[0] == 0)


def _decode_case(dev, kv, b, h, L, d, lengths, with_bias=True):
    """q, the cache arguments, lengths and a bias for decode_attention."""
    q = torch.randn((b, h, d), device=dev).to(
        torch.float32 if kv == "f32" else torch.bfloat16)
    k = torch.randn((b, h, L, d), device=dev)
    v = torch.randn((b, h, L, d), device=dev)
    if kv == "int8":
        (kq, ks), (vq, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
        args = [kq, vq, ks, vs]
    else:
        dt = torch.float32 if kv == "f32" else torch.bfloat16
        args = [k.to(dt), v.to(dt)]
    lens = torch.tensor([lengths[i % len(lengths)] for i in range(b)],
                        device=dev, dtype=torch.int32)
    bias = torch.randn((b, h, L), device=dev) if with_bias else None
    return q, args, lens, bias


def _edges(unit, cta, total):
    """Lengths 0, 1, a warp's share and a CTA's share +- 1, and the whole."""
    return sorted({min(total, max(0, x)) for x in
                   (0, 1, unit - 1, unit, unit + 1, cta - 1, cta + 1,
                    total - 1, total)})


# (b, h, L) with the split the plan gives them: 1, 2, 4 and 8 CTAs a
# cluster, at 512 positions or less (one maximum agreed over the cluster)
# and beyond (an online softmax a warp)
_DECODE_SPLITS = [((64, 8, 512), 1), ((16, 8, 512), 2), ((8, 8, 512), 4),
                  ((2, 8, 512), 8), ((4, 8, 1024), 8), ((8, 8, 66), 1),
                  ((4, 4, 1000), 8)]


@pytest.mark.parametrize("shape,splits", _DECODE_SPLITS)
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_decode_attention_splits(dev, shape, splits, kv, d):
    """Every split the plan chooses, at lengths on each side of a warp's
    and a CTA's share."""
    b, h, L = shape
    plan = decode_attention.decode_plan(b, h, L)
    assert plan[0] == splits
    q, args, lens, bias = _decode_case(
        dev, kv, b, h, L, d, _edges(plan[2], plan[1] * plan[2], L))
    got = decode_attention.decode_attention(q, *args, lengths=lens,
                                            bias=bias, sm_scale=d ** -0.5)
    want = decode_attention.decode_attention_plain(
        q, *args, lengths=lens, bias=bias, sm_scale=d ** -0.5)
    tol = 1e-4 if kv == "f32" else (1e-2 if L <= 512 else 2e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.all(got[lens == 0] == 0)


@pytest.mark.parametrize("shape", [(8, 8, 512), (2, 8, 512), (8, 8, 66),
                                   (4, 4, 1000)])
def test_decode_attention_is_deterministic(dev, shape):
    """Bit-equal over three runs, and the V rows of the last split's
    positions zeroed (the planted fault of the on-card check; the last
    cluster rank that holds positions) move the output."""
    b, h, L = shape
    q, args, lens, bias = _decode_case(dev, "int8", b, h, L, 64, [L])
    runs = [decode_attention.decode_attention(q, *args, lengths=lens,
                                              bias=bias) for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    warps = decode_attention.decode_plan(b, h, L)[1]
    first = max(a for a, _ in decode_attention.decode_pieces(b, h, L)[::warps]
                if a < L)     # the last cluster rank that holds positions
    vq = args[1].clone()
    vq[:, :, first:] = 0
    zeroed = decode_attention.decode_attention(
        q, args[0], vq, *args[2:], lengths=lens, bias=bias)
    assert (zeroed.float() - runs[0].float()).abs().max() > 0.05


def _paged_case(dev, kv, d, layout, with_bias, b=6, h=4, P=16, maxp=40,
                lengths=(0, 1, 17, 256, 300, 640)):
    """A fragmented pool (random page order) and slots of `lengths` (cycled
    over the slots): (q, kernel args, bias)."""
    n = b * maxp + 16
    k = torch.randn((n, h, P, d), device=dev)
    v = torch.randn((n, h, P, d), device=dev)
    if kv == "int8":
        (k, ks), (v, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
    else:
        dt = torch.float32 if kv == "f32" else torch.bfloat16
        k, v, ks, vs = k.to(dt), v.to(dt), None, None
    if layout == "fused":
        pages, scales = paged_kv.pack_kv_pages_fused(k, v, ks, vs)
        args = [pages[:, 0], pages[:, 1]] + (
            [None, None] if scales is None else [scales[:, 0], scales[:, 1]])
    else:
        args = [k, v] + ([None, None] if ks is None
                         else [ks[..., 0], vs[..., 0]])
    table = torch.randperm(n, device=dev)[:b * maxp].reshape(b, maxp)
    lengths = torch.tensor([lengths[i % len(lengths)] for i in range(b)],
                           device=dev, dtype=torch.int32)
    q = torch.randn((b, h, d), device=dev).to(
        torch.bfloat16 if kv == "bf16" else torch.float32)
    bias = torch.randn((b, h, maxp * P), device=dev) if with_bias else None
    return q, args + [table.int(), lengths], bias


@pytest.mark.parametrize("layout", ["standard", "fused"])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("with_bias", [False, True])
def test_paged_attention_kernel(dev, layout, kv, d, with_bias):
    q, args, bias = _paged_case(dev, kv, d, layout, with_bias)
    kw = dict(sm_scale=d ** -0.5, bias=bias, return_state=True)
    got = paged_attention.paged_attention(q, *args, **kw)
    want = paged_attention.paged_attention_plain(q, *args, **kw)
    assert got[0].dtype == q.dtype and got[0].shape == q.shape
    tol = 2e-2 if kv == "bf16" else 1e-4
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                               atol=tol)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    # the empty slot: out 0, m -1e30, l 0
    assert torch.all(got[0][0] == 0) and torch.all(got[1][0] == -1e30)
    assert torch.all(got[2][0] == 0)
    # without the state, the same output
    out = paged_attention.paged_attention(q, *args, sm_scale=d ** -0.5,
                                          bias=bias)
    assert torch.equal(out, got[0])


# (b, h, P, maxp) with the split the plan gives them: 1, 2, 4 and 8 CTAs a
# cluster (the paged engine's serving shape takes 2)
_PAGED_SPLITS = [((16, 8, 16, 6), 1), ((8, 8, 64, 5), 2),
                 ((4, 8, 16, 16), 4), ((2, 4, 16, 40), 8)]


@pytest.mark.parametrize("shape,splits", _PAGED_SPLITS)
@pytest.mark.parametrize("layout", ["standard", "fused"])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_attention_splits(dev, shape, splits, layout, kv, d):
    """Every split the plan chooses, at lengths on each side of a warp's
    and a CTA's share of pages, both layouts, with the state."""
    b, h, P, maxp = shape
    plan = paged_attention.paged_plan(b, h, maxp)
    assert plan[0] == splits
    unit = plan[2] * P
    lengths = _edges(unit, plan[1] * unit, maxp * P)
    q, args, bias = _paged_case(dev, kv, d, layout, True, b=b, h=h, P=P,
                                maxp=maxp, lengths=lengths)
    kw = dict(sm_scale=d ** -0.5, bias=bias, return_state=True)
    got = paged_attention.paged_attention(q, *args, **kw)
    want = paged_attention.paged_attention_plain(q, *args, **kw)
    tol = 2e-2 if kv == "bf16" else 1e-4
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                               atol=tol)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    empty = args[-1] == 0
    assert torch.all(got[0][empty] == 0) and torch.all(got[2][empty] == 0)
    assert torch.all(got[1][empty] == -1e30)


@pytest.mark.parametrize("shape", [(8, 8, 64, 5), (64, 8, 128, 16),
                                   (2, 4, 16, 40)])
def test_paged_attention_is_deterministic(dev, shape):
    """Output and state bit-equal over three runs, the output without the
    state bit-equal to it, and the V pages of the last split zeroed (the
    planted fault of the on-card check; the last cluster rank that holds
    pages) move the output."""
    b, h, P, maxp = shape
    q, args, bias = _paged_case(dev, "int8", 64, "fused", True, b=b, h=h,
                                P=P, maxp=maxp, lengths=[maxp * P])
    kw = dict(bias=bias, return_state=True)
    runs = [paged_attention.paged_attention(q, *args, **kw)
            for _ in range(3)]
    for r in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(r, runs[0]))
    assert torch.equal(paged_attention.paged_attention(q, *args, bias=bias),
                       runs[0][0])
    warps = paged_attention.paged_plan(b, h, maxp)[1]
    first = max(a for a, _ in paged_attention.paged_pieces(b, h, maxp)[::warps]
                if a < maxp)  # the last cluster rank that holds pages
    k, v = args[0].clone(), args[1].clone()   # one layout for both planes
    v[args[4][:, first:].flatten().long()] = 0
    zeroed = paged_attention.paged_attention(q, k, v, *args[2:], bias=bias)
    assert (zeroed - runs[0][0]).abs().max() > 0.05


def test_paged_attention_refuses_what_it_does_not_take(dev):
    q, args, _ = _paged_case(dev, "int8", 64, "standard", False)
    k, v, ks, vs, table, lengths = args
    with pytest.raises(ValueError, match="one CUDA device"):
        paged_attention.paged_attention(q, k.cpu(), v.cpu(), ks.cpu(),
                                        vs.cpu(), table, lengths)
    with pytest.raises(ValueError, match="one CUDA device"):
        paged_attention.paged_attention(q, *args[:4], table.cpu(), lengths)
    with pytest.raises(TypeError, match="scales"):
        paged_attention.paged_attention(q, k, v, None, None, table, lengths)
    with pytest.raises(ValueError, match="strides"):     # rows not contiguous
        paged_attention.paged_attention(q, k.transpose(2, 3), v.transpose(2, 3),
                                        ks, vs, table, lengths)
    with pytest.raises(ValueError, match="strides"):     # K and V differ
        paged_attention.paged_attention(
            q, k, torch.stack([v, v], 1)[:, 0], ks, vs, table, lengths)


def _close_to_max(got, want, tol):
    """|got - want| within tol times the largest |want| of that output."""
    scale = float(want.float().abs().max()) or 1.0
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * scale)


def _dw_error_bound(q, k, w, lse, delta, do, v, kw):
    """Per (bucket, head): 1e-5 times the sum of |dS| over that bucket's
    scores, plus 1e-3 times the largest dW. dW is a sum of terms of both
    signs that nearly cancel (each row of dS sums to 0), so its rounding
    error scales with the terms, not with the result: under a causal mask
    with M > N every visible score lies in the last bucket and dW is all
    cancellation."""
    total = flash_attention_rpe.flash_attention_dw_abs_plain(
        q, k, v, w, lse, delta, do, **kw)
    want = flash_attention_rpe.flash_attention_bwd_plain(
        q, k, v, w, lse, delta, do, **kw)[3]
    return 1e-5 * total + 1e-3 * want.abs().max()


@pytest.mark.parametrize("shape", [(8192, 512), (300, 512), (3, 7, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_bwd_kernel(dev, shape, dtype):
    x = torch.randn(shape, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], device=dev)).to(dtype)
    dy = torch.randn(shape, device=dev).to(dtype)
    _, rstd = rmsnorm.rms_norm_fwd(x, w)
    dx, dw = rmsnorm.rms_norm_bwd(x, w, rstd, dy)
    dx0, dw0 = rmsnorm.rms_norm_bwd_plain(x, w, rstd, dy)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(dx.float(), dx0.float(), rtol=tol, atol=tol)
    _close_to_max(dw, dw0, 1e-3)


# the rms_norm kernels' forms: d 96-768 one warp a row (16-byte vectors, or
# one element a lane at d 100 in 2-byte types), d 2048-8192 one CTA a row,
# d 5001 and 40960 a CTA a row with chunks read again; rows from one CTA of
# one warp a row (1, 8) to a persistent grid with backward clusters
_RMS_SHAPES = ([(r, d) for d in (96, 100, 512, 768, 2048, 4096, 8192, 5001)
                for r in (1, 8, 33, 4096)]
               + [(65536, d) for d in (100, 512, 768, 8192)] + [(33, 40960)])
_RMS_TYPES = (torch.float32, torch.bfloat16, torch.float16)


def _rms_inputs(rows, d, x_dtype, w_dtype=torch.float32, dy_dtype=None):
    x = torch.randn((rows, d), device="cuda").to(x_dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda")).to(w_dtype)
    dy = torch.randn((rows, d), device="cuda").to(dy_dtype or x_dtype)
    return x, w, dy


def _rms_check(x, w, dy, cast_w=False):
    y, rstd = rmsnorm.rms_norm_fwd(x, w, cast_w=cast_w)
    y0, rstd0 = rmsnorm.rms_norm_plain(x, w, cast_w=cast_w)
    torch.testing.assert_close(rstd, rstd0, rtol=1e-5, atol=1e-6)
    tol = 1e-5 if x.dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    dx, dw = rmsnorm.rms_norm_bwd(x, w, rstd, dy, cast_w=cast_w)
    dx0, dw0 = rmsnorm.rms_norm_bwd_plain(x, w, rstd, dy, cast_w=cast_w)
    assert dx.dtype == dy.dtype and dw.dtype == torch.float32
    tol = 1e-5 if dy.dtype == torch.float32 else 1e-2
    torch.testing.assert_close(dx.float(), dx0.float(), rtol=tol, atol=tol)
    _close_to_max(dw, dw0, 1e-3)


@pytest.mark.parametrize("shape", _RMS_SHAPES)
def test_rms_norm_kernels_at_every_form(dev, shape):
    """bf16 x and dy with the fp32 weight, as the model passes them (the
    weight's cast folded in)."""
    _rms_check(*_rms_inputs(*shape, torch.bfloat16), cast_w=True)


@pytest.mark.parametrize("shape", _RMS_SHAPES)
def test_rms_norm_op_form_at_every_form(dev, shape):
    """The op's own semantics: the fp32 weight taken unrounded, dW in fp32
    (the JAX op `rms_norm(x, w)`)."""
    _rms_check(*_rms_inputs(*shape, torch.bfloat16))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float16])
def test_rms_norm_op_form_differs_from_the_cast(dev, x_dtype):
    """Without `cast_w` the kernels take the fp32 weight unrounded: y and
    dW differ from the folded cast's somewhere at (8192, 512)."""
    x, w, dy = _rms_inputs(8192, 512, x_dtype)
    w = w + 1e-3 * torch.randn_like(w)
    ya, rstd = rmsnorm.rms_norm_fwd(x, w)
    yb, _ = rmsnorm.rms_norm_fwd(x, w, cast_w=True)
    _, dwa = rmsnorm.rms_norm_bwd(x, w, rstd, dy)
    _, dwb = rmsnorm.rms_norm_bwd(x, w, rstd, dy, cast_w=True)
    assert not torch.equal(ya, yb) and not torch.equal(dwa, dwb)
    assert torch.equal(dwb, dwb.to(x_dtype).float())


@pytest.mark.parametrize("shape", [(33, 100), (300, 512), (5, 2048)])
@pytest.mark.parametrize("w_dtype", _RMS_TYPES)
@pytest.mark.parametrize("x_dtype", _RMS_TYPES)
def test_rms_norm_kernels_at_every_dtype_pair(dev, x_dtype, w_dtype, shape):
    _rms_check(*_rms_inputs(*shape, x_dtype, w_dtype))


@pytest.mark.parametrize("dy_dtype", _RMS_TYPES)
@pytest.mark.parametrize("x_dtype", _RMS_TYPES)
def test_rms_norm_bwd_kernel_takes_any_dy_dtype(dev, x_dtype, dy_dtype):
    _rms_check(*_rms_inputs(300, 512, x_dtype, dy_dtype=dy_dtype))


@pytest.mark.parametrize("shape", [(65536, 512), (8192, 512), (4096, 100),
                                   (33, 8192), (33, 5001), (1, 512)])
def test_rms_norm_kernels_bit_equal_over_runs(dev, shape):
    """Every sum in a fixed order: y, rstd, dx and dW the same bits twice
    (dW over the CTAs, the clusters and the last CTAs' merge)."""
    x, w, dy = _rms_inputs(*shape, torch.bfloat16)
    runs = []
    for _ in range(2):
        y, rstd = rmsnorm.rms_norm_fwd(x, w)
        dx, dw = rmsnorm.rms_norm_bwd(x, w, rstd, dy)
        runs.append((y, rstd, dx, dw))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(8192, 512), (33, 100), (33, 2048)])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float16])
def test_rms_norm_folded_cast_bit_equal(dev, x_dtype, shape):
    """The fp32 weight rounded by the kernel as it loads it, and dW rounded
    to x.dtype by the kernel as it writes it: the same bits as the cast
    made first (`w.to(x.dtype)`, then the cast's gradient)."""
    x, w, dy = _rms_inputs(*shape, x_dtype)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    ya = rmsnorm.rms_norm(xa, wa, cast_w=True)
    yb = rmsnorm.rms_norm(xb, wb.to(x_dtype))
    ya.backward(dy)
    yb.backward(dy)
    assert wa.grad.dtype == torch.float32
    assert torch.equal(ya, yb)
    assert torch.equal(xa.grad, xb.grad)
    assert torch.equal(wa.grad, wb.grad)


def test_rms_norm_kernels_refuse_what_they_do_not_take(dev):
    x, w, dy = _rms_inputs(8, 512, torch.bfloat16)
    _, rstd = rmsnorm.rms_norm_fwd(x, w)
    with pytest.raises(TypeError):
        rmsnorm.rms_norm_fwd(x.double(), w)
    with pytest.raises(TypeError):
        rmsnorm.rms_norm_bwd(x, w.to(torch.int32), rstd, dy)
    with pytest.raises(ValueError):
        rmsnorm.rms_norm_fwd(x, w[:-1])
    with pytest.raises(ValueError):
        rmsnorm.rms_norm_bwd(x, torch.ones((2, 256), device=dev), rstd, dy)
    with pytest.raises(ValueError):
        rmsnorm.rms_norm_fwd(x, w.cpu())
    with pytest.raises(ValueError):
        rmsnorm.rms_norm_bwd(x, w, rstd, dy[:4])
    with pytest.raises(ValueError):
        rmsnorm.rms_norm_bwd(x, w, rstd[:4], dy)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("m_len,n_len,d", [(77, 77, 32), (100, 300, 64),
                                           (300, 100, 64), (256, 1024, 64),
                                           (130, 70, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table", [True, False])
def test_flash_attention_bwd_kernel(dev, causal, m_len, n_len, d, dtype,
                                    table):
    q = torch.randn((2, 4, m_len, d), device=dev).to(dtype)
    k = torch.randn((2, 4, n_len, d), device=dev).to(dtype)
    v = torch.randn((2, 4, n_len, d), device=dev).to(dtype)
    do = torch.randn((2, 4, m_len, d), device=dev).to(dtype)
    w = torch.randn((32, 4), device=dev) if table else None
    kw = dict(causal=causal, bidirectional=not causal, sm_scale=d ** -0.5)
    o, lse = flash_attention_rpe.flash_attention_rpe_fwd(q, k, v, w, **kw)
    o0, lse0 = flash_attention_rpe.flash_attention_rpe_plain(q, k, v, w,
                                                              **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o0.float(), rtol=tol, atol=tol)
    delta = (do.float() * o.float()).sum(-1)
    got = flash_attention_rpe.flash_attention_bwd(q, k, v, w, lse, delta, do,
                                                  **kw)
    want = flash_attention_rpe.flash_attention_bwd_plain(q, k, v, w, lse,
                                                         delta, do, **kw)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    for g, g0 in zip(got[:3], want[:3]):
        assert g.dtype == dtype
        _close_to_max(g, g0, tol)
    if table:
        assert got[3].dtype == torch.float32 and got[3].shape == (32, 4)
        bound = _dw_error_bound(q, k, w, lse, delta, do, v, kw)
        assert torch.all((got[3] - want[3]).abs() <= bound), \
            (got[3] - want[3]).abs().max()
    else:
        assert got[3] is None and want[3] is None


def _t5_bias_case(dev, heads, m_len, n_len, num_buckets, bidirectional,
                  explicit):
    """A table on the card, its bias through `t5_relative_bias`, a gradient
    of the bias and the bucket map: explicit positions are sorted draws
    under 2048, the first pinned to 0 (randomized-position training's)."""
    gen = torch.Generator().manual_seed(m_len * n_len + num_buckets)
    kw = dict(bidirectional=bidirectional, num_buckets=num_buckets,
              max_len=2048)
    if explicit:
        kw.update({key: positional._randomized_positions(gen, length, 2048)
                   for key, length in (("q_positions", m_len),
                                       ("k_positions", n_len))})
    table = torch.randn((num_buckets, heads), generator=gen).to(dev)
    table.requires_grad_(True)
    bias = positional.t5_relative_bias(
        {"relative_attention_bias": table}, m_len, n_len, **kw)
    grad = torch.randn(bias.shape, generator=gen).to(dev)
    return table, bias, grad, positional.bucket_map(m_len, n_len,
                                                    device=dev, **kw)


@pytest.mark.parametrize("shape,num_buckets,bidirectional,explicit", [
    ((8, 1024, 1024), 32, True, False),     # the encoder's
    ((8, 256, 256), 32, False, False),      # the decoder's
    ((8, 77, 301), 64, True, False),        # rows of 4 bytes
    ((8, 300, 1000), 256, True, False),     # the kernel's largest table
    ((8, 512, 512), 32, True, True),
    ((4, 130, 70), 64, False, True),
    ((8, 200, 333), 40, True, True),        # counts that do not divide the
    ((8, 96, 160), 24, False, False),       # kernel's 128 bins a bucket
    ((8, 64, 64), 300, True, False),        # above the limit: refused
])
def test_t5_bias_grad_kernel(dev, shape, num_buckets, bidirectional,
                             explicit):
    """The table's gradient through the bias's backward on the card against
    `t5_bias_grad_plain` (the `index_put_` that autograd's gather runs), the
    `t5_bias.grad` span naming the kernel's route; the kernel gives the same
    bits on a second call. Above the kernel's `MAX_BUCKETS` a CUDA tensor is
    refused. Tolerance in the module's docstring."""
    heads, m_len, n_len = shape
    table, bias, grad, buckets = _t5_bias_case(
        dev, heads, m_len, n_len, num_buckets, bidirectional, explicit)
    if num_buckets > t5_bias_grad.MAX_BUCKETS:
        with pytest.raises(ValueError, match="buckets"):
            bias.backward(grad)
        return
    with profiling.recording() as rec:
        bias.backward(grad)
    assert [(s.attrs["route"], s.attrs["elements"], s.attrs["buckets"])
            for s in rec.spans if s.name == "t5_bias.grad"] == [
        ("kernel", heads * m_len * n_len, num_buckets)]
    want = t5_bias_grad.t5_bias_grad_plain(grad, buckets, num_buckets)
    magnitude = t5_bias_grad.t5_bias_grad_plain(grad.abs(), buckets,
                                                num_buckets)
    got = table.grad
    assert got.dtype == torch.float32 and got.shape == (num_buckets, heads)
    assert torch.all((got - want).abs() <= 1e-6 * magnitude + 1e-6), \
        (got - want).abs().max()
    again = t5_bias_grad.t5_bias_grad(grad, buckets, num_buckets)
    assert torch.equal(again, got)


@pytest.mark.parametrize("n", [64, 128])
def test_wgmma_mn_descriptor(dev, n):
    """wgmma's MN-major B operand alone (the descriptor the bf16 attention
    kernels read V, K, Q and dO through): a (64, 64) @ (64, n) product, A
    from shared memory and from registers, against f32 matmul (exact
    products, f32 sums in another order)."""
    a = torch.randn((64, 64), device=dev).to(torch.bfloat16)
    b = torch.randn((64, n), device=dev).to(torch.bfloat16)
    want = a.float() @ b.float()
    for got in flash_attention_rpe.wgmma_mn_check(a, b):
        _close_to_max(got, want, 1e-5)


# The bf16 kernels on TMA + wgmma at their tiles' edges: 128-row forward
# and dQ CTAs (two warpgroups of 64), 128-key forward tiles at D 64 and 64
# at D 128, 64-key dQ tiles, 128-key dK/dV CTAs over 64-row (D 64) or
# 32-row (D 128) query tiles; M and N one under and one past each, causal
# with N > M and M > N (rows that see no key), the cross shape
@pytest.mark.parametrize("m_len,n_len,d", [(127, 129, 64), (129, 127, 128),
                                           (257, 33, 64), (33, 257, 128),
                                           (1, 129, 64), (129, 1, 64),
                                           (65, 63, 128), (256, 1024, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("table", [True, False])
def test_wgmma_attention_tile_edges(dev, m_len, n_len, d, causal, table):
    q, do = (torch.randn((2, 4, m_len, d), device=dev).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((2, 4, n_len, d), device=dev).to(torch.bfloat16)
            for _ in range(2))
    w = torch.randn((32, 4), device=dev) if table else None
    kw = dict(causal=causal, bidirectional=not causal, sm_scale=d ** -0.5)
    o, lse = flash_attention_rpe.flash_attention_rpe_fwd(q, k, v, w, **kw)
    o0, lse0 = flash_attention_rpe.flash_attention_rpe_plain(q, k, v, w,
                                                              **kw)
    torch.testing.assert_close(o.float(), o0.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, lse0, rtol=1e-4, atol=1e-4)
    delta = (do.float() * o.float()).sum(-1)
    got = flash_attention_rpe.flash_attention_bwd(q, k, v, w, lse, delta, do,
                                                  **kw)
    want = flash_attention_rpe.flash_attention_bwd_plain(q, k, v, w, lse,
                                                         delta, do, **kw)
    floor = 2.0 ** -8 * float(want[2].float().abs().max())
    for g, g0 in zip(got[:3], want[:3]):
        scale = max(float(g0.float().abs().max()), floor)
        torch.testing.assert_close(g.float(), g0.float(), rtol=0,
                                   atol=3e-2 * scale)
    if table:
        bound = _dw_error_bound(q, k, w, lse, delta, do, v, kw) \
            + 1e-3 * floor
        assert torch.all((got[3] - want[3]).abs() <= bound), \
            (got[3] - want[3]).abs().max()


@pytest.mark.parametrize("table", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_bf16_runs_are_bit_equal(dev, table, d, causal):
    """The forward's o and lse and the backward's dq, dk, dv and dW, bit-
    equal over two runs (no atomics; dW's partial rows summed in a fixed
    order)."""
    q, k, v, do = (torch.randn((8, 8, 300, d), device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    w = torch.randn((32, 8), device=dev) if table else None
    kw = dict(causal=causal, bidirectional=not causal, sm_scale=d ** -0.5)
    runs = []
    for _ in range(2):
        o, lse = flash_attention_rpe.flash_attention_rpe_fwd(q, k, v, w,
                                                             **kw)
        delta = (do.float() * o.float()).sum(-1)
        runs.append((o, lse) + tuple(
            t for t in flash_attention_rpe.flash_attention_bwd(
                q, k, v, w, lse, delta, do, **kw) if t is not None))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_attention_bwd_dw_is_deterministic(dev):
    q, k, v, do = (torch.randn((8, 8, 256, 64), device=dev).to(torch.bfloat16)
                   for _ in range(4))
    w = torch.randn((32, 8), device=dev)
    o, lse = flash_attention_rpe.flash_attention_rpe_fwd(q, k, v, w)
    delta = (do.float() * o.float()).sum(-1)
    runs = [flash_attention_rpe.flash_attention_bwd(q, k, v, w, lse, delta,
                                                    do) for _ in range(3)]
    for r in runs[1:]:
        for a, b in zip(r, runs[0]):
            assert torch.equal(a, b)


# The bf16 backward's tensor-core kernels at their tiles' edges (64-key
# dK/dV CTAs, 64-row query tiles, 128-row dQ CTAs, 16-row warps): M and N
# of 1, under 16 and one past a tile, causal with N > M and with M > N, D
# 32 and 128, on each bias source: the bucket table, none, a bias tensor,
# and a bias tensor with use_masking's padded rows
@pytest.mark.parametrize("m_len,n_len,d", [(1, 1, 64), (1, 200, 32),
                                           (15, 15, 128), (200, 1, 64),
                                           (65, 129, 32), (129, 65, 128),
                                           (13, 300, 64), (300, 13, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("source", ["table", "none", "bias", "masked_rows"])
def test_attention_bwd_tile_edges(dev, m_len, n_len, d, causal, source):
    """bf16: 3e-2 of each output's largest entry (1e-3 for dbias, fp32 dS;
    dW to `_dw_error_bound`). Where one key is visible, dS = P (dP - delta)
    is 0 but for rounding, so dq, dk, dbias and dW are rounding noise in
    both versions: their scale is at least one bf16 ulp of dv's largest
    entry (the inputs are N(0, 1))."""
    kw = dict(causal=causal, sm_scale=d ** -0.5)

    def close(got, want, tol):
        floor = 2.0 ** -8 * float(want[2].float().abs().max())
        for g, g0, t in zip(got, want, tol):
            assert g.dtype == g0.dtype
            scale = max(float(g0.float().abs().max()), floor)
            torch.testing.assert_close(g.float(), g0.float(), rtol=0,
                                       atol=t * scale)

    if source in ("table", "none"):
        q, do = (torch.randn((2, 4, m_len, d), device=dev)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((2, 4, n_len, d), device=dev)
                .to(torch.bfloat16) for _ in range(2))
        w = torch.randn((32, 4), device=dev) if source == "table" else None
        kw["bidirectional"] = not causal
        o, lse = flash_attention_rpe.flash_attention_rpe_fwd(q, k, v, w, **kw)
        delta = (do.float() * o.float()).sum(-1)
        got = flash_attention_rpe.flash_attention_bwd(q, k, v, w, lse,
                                                      delta, do, **kw)
        want = flash_attention_rpe.flash_attention_bwd_plain(
            q, k, v, w, lse, delta, do, **kw)
        close(got[:3], want[:3], (3e-2,) * 3)
        if w is not None:   # where dS cancels, 1e-3 of the floor too
            bound = _dw_error_bound(q, k, w, lse, delta, do, v, kw) \
                + 1e-3 * 2.0 ** -8 * want[2].float().abs().max()
            assert torch.all((got[3] - want[3]).abs() <= bound), \
                (got[3] - want[3]).abs().max()
        return
    q, k, v, bias, do = _bias_inputs(dev, m_len, n_len, d, torch.bfloat16,
                                     "bh",
                                     masked_rows=source == "masked_rows")
    o, lse = flash_attention.flash_attention_bias_fwd(q, k, v, bias, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, bias, lse, delta, do)
    dq = flash_attention.flash_attention_bias_dq(*args, **kw)
    dq0 = flash_attention.flash_attention_bias_dq_plain(*args, **kw)
    got = (dq,) + flash_attention.flash_attention_bias_dkv(*args, **kw)
    want = (dq0,) + flash_attention.flash_attention_bias_dkv_plain(*args,
                                                                   **kw)
    close(got, want, (3e-2, 3e-2, 3e-2, 1e-3))


@pytest.mark.parametrize("rows,v", [(2048, 32768), (37, 1000), (5, 50257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_kernels(dev, rows, v, dtype, smoothing):
    logits = (3 * torch.randn((rows, v), device=dev)).to(dtype)
    labels = torch.randint(0, v, (rows,), device=dev)
    labels[::7] = -100
    out = cross_entropy.cross_entropy_fwd(logits, labels,
                                          lse_square_scale=1e-4,
                                          label_smoothing=smoothing)
    out0 = cross_entropy.cross_entropy_fwd_plain(logits, labels,
                                                 lse_square_scale=1e-4,
                                                 label_smoothing=smoothing)
    # lse as before; the loss and z-loss (the epilogue's) to 1e-4 absolute
    torch.testing.assert_close(out[1], out0[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out[0::2], out0[0::2], rtol=1e-5, atol=1e-4)
    assert torch.all(out[0, ::7] == 0) and torch.all(out[2, ::7] == 0)
    lse = out[1]
    dloss, dz = torch.randn(rows, device=dev), torch.randn(rows, device=dev)
    kw = dict(lse_square_scale=1e-4, label_smoothing=smoothing)
    got = cross_entropy.cross_entropy_bwd(logits, labels, lse, dloss, dz,
                                          **kw)
    want = cross_entropy.cross_entropy_bwd_plain(logits, labels, lse, dloss,
                                                 dz, **kw)
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.all(got[::7] == 0)


@pytest.mark.parametrize("rows,v,shards", [(2048, 32768, 4), (37, 1000, 3)])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_split_kernels(dev, rows, v, shards, smoothing):
    """The vocab-split form: each shard's backward kernel (the one-hot
    moved by `class_start_idx`, smoothing over `total_classes`) against its
    plain version, and the shards' partial losses combined against the
    unsplit loss. bf16 logits; dlogits to 1e-2 as the unsplit test, the
    combined loss to 1e-4 (sums over the shards in another order)."""
    logits = (3 * torch.randn((rows, v), device=dev)).to(torch.bfloat16)
    labels = torch.randint(0, v, (rows,), device=dev)
    labels[::7] = -100
    dloss, dz = torch.randn(rows, device=dev), torch.randn(rows, device=dev)
    w = -(-v // shards)
    partials, lses = [], []
    for start in range(0, v, w):
        shard = logits[:, start:start + w].contiguous()
        kw = dict(lse_square_scale=1e-4, label_smoothing=smoothing,
                  total_classes=v, class_start_idx=start)
        lse = cross_entropy.cross_entropy_fwd(shard, labels, **kw,
                                              split=True)[1]
        got = cross_entropy.cross_entropy_bwd(shard, labels, lse, dloss, dz,
                                              **kw)
        want = cross_entropy.cross_entropy_bwd_plain(shard, labels, lse,
                                                     dloss, dz, **kw)
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)
        loss, z = cross_entropy.cross_entropy_loss(
            shard, labels, 1e-4, smoothing, total_classes=v,
            class_start_idx=start, split=True)
        assert torch.all(z == 0)
        partials.append(loss)
        lses.append(lse)
    lse = torch.logsumexp(torch.stack(lses), dim=0)
    combined = torch.where(labels != -100,
                           sum(partials) + lse + 1e-4 * lse * lse, 0.0)
    whole, _ = cross_entropy.cross_entropy_loss(logits, labels, 1e-4,
                                                smoothing)
    torch.testing.assert_close(combined, whole, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_epilogue_and_combine(dev, split, smoothing):
    """The forward kernel's (loss, lse, z-loss) rows, the loss written in
    its epilogue, against its plain version on bf16 (2048, 32768) logits
    (ignored rows among them), unsplit or as four shards whose split rows
    `cross_entropy_combine` joins; a label one column off (each shard's
    `class_start_idx` one too high) must land beyond the limit."""
    rows, v, shards = 2048, 32768, 4
    logits = (3 * torch.randn((rows, v), device=dev)).to(torch.bfloat16)
    labels = torch.randint(0, v, (rows,), device=dev)
    labels[::7] = -100
    kw = dict(lse_square_scale=1e-4, label_smoothing=smoothing)

    def loss(plain=False, off=0):
        fwd, comb = ((cross_entropy.cross_entropy_fwd_plain,
                      cross_entropy.cross_entropy_combine_plain) if plain
                     else (cross_entropy.cross_entropy_fwd,
                           cross_entropy.cross_entropy_combine))
        if not split:
            return fwd(logits, torch.where(labels >= 0, (labels + off) % v,
                                           labels), **kw)
        w = v // shards
        parts = torch.stack([fwd(
            logits[:, i * w:(i + 1) * w].contiguous(), labels,
            total_classes=v, class_start_idx=i * w + off, split=True,
            **kw)[:2] for i in range(shards)])
        return comb(parts, labels, lse_square_scale=1e-4)
    want = loss(plain=True)
    lim = 2e-4 + 1e-5 * want.abs()
    assert torch.all((loss() - want).abs() <= lim)
    assert not torch.all((loss(off=1) - want).abs() <= lim)
    whole = cross_entropy.cross_entropy_fwd_plain(logits, labels, **kw)
    torch.testing.assert_close(want, whole, rtol=1e-5, atol=2e-4)


# bias shapes: per head, per batch and head, one for all, per batch, and a
# (1, H, M, N) bias expanded to (B, H, M, N) with stride 0 (use_full_bias_size)
_BIAS_FORMS = {"1h": (1, 4), "bh": (2, 4), "11": (1, 1), "b1": (2, 1),
               "expanded": (1, 4)}


def _bias_inputs(dev, m_len, n_len, d, dtype, form, masked_rows=False):
    q, do = (torch.randn((2, 4, m_len, d), device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((2, 4, n_len, d), device=dev).to(dtype)
            for _ in range(2))
    bias = torch.randn((*_BIAS_FORMS[form], m_len, n_len), device=dev)
    if form == "expanded":
        bias = bias.expand(2, -1, -1, -1)
    if masked_rows:     # use_masking's fold, then the wrapper's clamp
        rows = torch.zeros((2, 1, m_len, 1), dtype=torch.bool, device=dev)
        rows[0, 0, min(3, m_len - 1)] = rows[1, 0, m_len // 2:] = True
        bias = torch.where(rows, -1e29, bias)
    return q, k, v, bias, do


@pytest.mark.parametrize("form", list(_BIAS_FORMS))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("m_len,n_len,d", [(77, 77, 32), (100, 300, 64),
                                           (300, 100, 64), (130, 70, 128),
                                           (200, 1000, 64), (1, 1024, 64),
                                           (1030, 77, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bias_kernels(dev, form, causal, m_len, n_len, d,
                                      dtype):
    q, k, v, bias, do = _bias_inputs(dev, m_len, n_len, d, dtype, form)
    kw = dict(causal=causal, sm_scale=d ** -0.5)
    o, lse = flash_attention.flash_attention_bias_fwd(q, k, v, bias, **kw)
    o0, lse0 = flash_attention.flash_attention_bias_plain(q, k, v, bias, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse0, rtol=1e-4, atol=1e-4)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, bias, lse, delta, do)
    dk, dv, dbias = flash_attention.flash_attention_bias_dkv(*args, **kw)
    dk0, dv0, dbias0 = flash_attention.flash_attention_bias_dkv_plain(*args,
                                                                      **kw)
    dq = flash_attention.flash_attention_bias_dq(*args, **kw)
    dq0 = flash_attention.flash_attention_bias_dq_plain(*args, **kw)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    for g, g0 in ((dq, dq0), (dk, dk0), (dv, dv0)):
        assert g.dtype == dtype
        _close_to_max(g, g0, tol)
    assert dbias.dtype == torch.float32 and dbias.shape == dbias0.shape
    assert dbias.shape == (2 if form in ("bh", "b1", "expanded") else 1,
                           1 if form in ("11", "b1") else 4, m_len, n_len)
    _close_to_max(dbias, dbias0, 1e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bias_masked_rows(dev, causal):
    """Rows whose bias is -1e29 throughout (use_masking's padded queries
    after the clamp) attend uniformly, and the kernels recompute P = 1
    there from the absorbed lse, as the plain versions do."""
    q, k, v, bias, do = _bias_inputs(dev, 96, 96, 64, torch.float32, "bh",
                                     masked_rows=True)
    kw = dict(causal=causal, sm_scale=1.0)
    o, lse = flash_attention.flash_attention_bias_fwd(q, k, v, bias, **kw)
    o0, lse0 = flash_attention.flash_attention_bias_plain(q, k, v, bias, **kw)
    torch.testing.assert_close(o, o0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, lse0, rtol=1e-4, atol=1e-4)
    if not causal:     # uniform: the mean of V
        torch.testing.assert_close(o[0, :, 3], v[0].mean(1), rtol=1e-4,
                                   atol=1e-4)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, bias, lse, delta, do)
    got = flash_attention.flash_attention_bias_dkv(*args, **kw) + (
        flash_attention.flash_attention_bias_dq(*args, **kw),)
    want = flash_attention.flash_attention_bias_dkv_plain(*args, **kw) + (
        flash_attention.flash_attention_bias_dq_plain(*args, **kw),)
    for g, g0 in zip(got, want):
        _close_to_max(g, g0, 1e-3)


def test_flash_attention_bias_is_deterministic(dev):
    q, k, v, bias, do = _bias_inputs(dev, 256, 256, 64, torch.bfloat16, "1h")
    o, lse = flash_attention.flash_attention_bias_fwd(q, k, v, bias)
    delta = (do.float() * o.float()).sum(-1)
    runs = [flash_attention.flash_attention_bias_dkv(q, k, v, bias, lse,
                                                     delta, do)
            + (flash_attention.flash_attention_bias_dq(q, k, v, bias, lse,
                                                       delta, do),)
            for _ in range(3)]
    for r in runs[1:]:
        for a, b in zip(r, runs[0]):
            assert torch.equal(a, b)


def test_flash_attention_with_bias_end_to_end(dev):
    """The differentiable `flash_attention` on the card against the same
    call on the CPU (the plain versions), bias clamped and differentiated."""
    q, k, v, bias, do = _bias_inputs(dev, 128, 200, 64, torch.float32, "1h")
    bias = bias.clone()
    bias[0, 0, 5] = torch.finfo(torch.float32).min
    grads = []
    for device in (dev, "cpu"):
        ts = [t.detach().to(device).requires_grad_(True)
              for t in (q, k, v, bias)]
        o = flash_attention.flash_attention(*ts, causal=True, sm_scale=0.5)
        o.backward(do.to(device))
        grads.append([o.detach().cpu()] + [t.grad.cpu() for t in ts])
    for g, g0 in zip(*grads):
        _close_to_max(g, g0, 1e-3)
    assert torch.all(grads[0][4][0, 0, 5] == 0)   # clamped: no gradient


def test_flash_attention_bias_refuses_what_it_does_not_take(dev):
    q, k, v, bias, do = _bias_inputs(dev, 64, 64, 64, torch.float32, "1h")
    with pytest.raises(ValueError, match="bias"):
        flash_attention.flash_attention_bias_fwd(q, k, v, bias[:, :, :32])
    with pytest.raises(ValueError, match="bias"):
        flash_attention.flash_attention_bias_fwd(
            q, k, v, torch.zeros((1, 3, 64, 64), device=dev))
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention.flash_attention_bias_fwd(q, k, v, bias.cpu())
    with pytest.raises(TypeError):
        flash_attention.flash_attention_bias_fwd(q.half(), k.half(), v.half(),
                                                 bias)


# ---------------------------------------------------------------------------
# fused lm_head + cross-entropy
# ---------------------------------------------------------------------------

def _flce_inputs(dev, rows, d, v, x_dtype, w_dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((rows, d), generator=g, device=dev)).to(x_dtype)
    w = (torch.randn((d, v), generator=g, device=dev) * d ** -0.5).to(w_dtype)
    labels = torch.randint(0, v, (rows,), generator=g, device=dev)
    labels[torch.rand(rows, generator=g, device=dev) < 0.25] = -100
    dloss = torch.rand(rows, generator=g, device=dev)
    dz = torch.rand(rows, generator=g, device=dev)
    return x, w, labels, dloss, dz


_FLCE_TYPES = {"f32": (torch.float32, torch.float32),
               "bf16": (torch.bfloat16, torch.bfloat16),
               "bf16_w32": (torch.bfloat16, torch.float32)}


def _flce_close(got, want, bf16):
    scale = float(want.float().abs().max()) or 1.0
    torch.testing.assert_close(
        got.float(), want.float(), rtol=2.0 ** -7 if bf16 else 0,
        atol=(1e-3 if bf16 else 1e-4) * scale)


# d at every width: multiples of 64 up to 512 in one chunk of the
# backward, wider ones (the FAT5-base, -large and -XL widths 768, 1024 and
# 2048) in chunks of d, and widths that are not multiples of 64
@pytest.mark.parametrize("rows,d,v", [(256, 512, 32768), (300, 128, 32128),
                                      (37, 64, 300), (64, 384, 384),
                                      (300, 96, 32128), (300, 200, 32128),
                                      (300, 640, 32128), (300, 768, 32128),
                                      (300, 1024, 32128),
                                      (300, 2048, 32128), (37, 97, 300)])
@pytest.mark.parametrize("types", list(_FLCE_TYPES))
@pytest.mark.parametrize("kw", [dict(lse_square_scale=1e-4),
                                dict(label_smoothing=0.1, logit_scale=2.0,
                                     lse_square_scale=1e-4)],
                         ids=["zloss", "smoothing_scale"])
def test_fused_linear_ce_kernels(dev, rows, d, v, types, kw):
    x, w, labels, dloss, dz = _flce_inputs(dev, rows, d, v,
                                           *_FLCE_TYPES[types])
    fkw = dict(logit_scale=kw.get("logit_scale", 1.0),
               label_smoothing=kw.get("label_smoothing", 0.0))
    lse, total = fused_linear_ce.fused_linear_ce_fwd(x, w, **fkw)
    lse0, total0 = fused_linear_ce.fused_linear_ce_fwd_plain(x, w, **fkw)
    torch.testing.assert_close(lse, lse0, rtol=1e-5, atol=1e-5)
    if fkw["label_smoothing"]:
        abs_sum = fused_linear_ce._logits(x, w, fkw["logit_scale"]).abs() \
            .sum(-1)
        assert bool(((total - total0).abs() <= 1e-6 * abs_sum).all())
    else:
        assert total is None and total0 is None
    dx, dw = fused_linear_ce.fused_linear_ce_bwd(x, w, labels, lse0, dloss,
                                                 dz, **kw)
    dx0, dw0 = fused_linear_ce.fused_linear_ce_bwd_plain(x, w, labels, lse0,
                                                         dloss, dz, **kw)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    bf16 = x.dtype == torch.bfloat16
    _flce_close(dx, dx0, bf16)
    _flce_close(dw, dw0, bf16)


def test_fused_linear_ce_kernels_at_d_2048_train_rows(dev):
    """d 2048 (FAT5-XL) at the train step's 2048 rows, bf16, z-loss."""
    x, w, labels, dloss, dz = _flce_inputs(dev, 2048, 2048, 32768,
                                           torch.bfloat16, torch.bfloat16)
    lse, _ = fused_linear_ce.fused_linear_ce_fwd(x, w)
    lse0, _ = fused_linear_ce.fused_linear_ce_fwd_plain(x, w)
    torch.testing.assert_close(lse, lse0, rtol=1e-5, atol=1e-5)
    dx, dw = fused_linear_ce.fused_linear_ce_bwd(x, w, labels, lse0, dloss,
                                                 dz, lse_square_scale=1e-4)
    dx0, dw0 = fused_linear_ce.fused_linear_ce_bwd_plain(
        x, w, labels, lse0, dloss, dz, lse_square_scale=1e-4)
    _flce_close(dx, dx0, True)
    _flce_close(dw, dw0, True)


# The bf16 forward on TMA + wgmma (d a multiple of 8): the scoring's 256
# rows and up to 512 (an f32 lm_head rounded in shared memory), 513 and the
# train step's 2048 (w^T rounded into the scratch; d 512 with x resident in
# shared memory, 768, 1024 and 2048 with x streamed, d 2048 in three
# vocabulary slabs), V 32128 and 32768, an f32 lm_head (every path's) and a
# bf16 one
@pytest.mark.parametrize("rows", [256, 512, 513, 2048])
@pytest.mark.parametrize("d", [512, 768, 1024, 2048])
@pytest.mark.parametrize("v", [32128, 32768])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(), dict(label_smoothing=0.1,
                                             logit_scale=2.0)],
                         ids=["plain", "smoothing_scale"])
def test_fused_linear_ce_fwd_tma(dev, rows, d, v, w_dtype, kw):
    x, w, *_ = _flce_inputs(dev, rows, d, v, torch.bfloat16, w_dtype)
    lse, total = fused_linear_ce.fused_linear_ce_fwd(x, w, **kw)
    lse0, total0 = fused_linear_ce.fused_linear_ce_fwd_plain(x, w, **kw)
    torch.testing.assert_close(lse, lse0, rtol=1e-5, atol=1e-5)
    if kw:
        abs_sum = fused_linear_ce._logits(x, w, kw["logit_scale"]).abs() \
            .sum(-1)
        assert bool(((total - total0).abs() <= 1e-6 * abs_sum).all())
    part = fused_linear_ce.fwd_partials(x, w, **kw)
    assert part.shape[1] == fused_linear_ce.fwd_plan(
        rows, d, v, torch.cuda.get_device_properties(dev)
        .multi_processor_count, fused_linear_ce._fwd_convert(x, w))[2]


@pytest.mark.parametrize("rows,d", [(2048, 512), (256, 768), (300, 200),
                                    (37, 97)])
def test_fused_linear_ce_fwd_is_deterministic(dev, rows, d):
    """lse bit-equal over three runs, on both bf16 forms (d 97: not a
    multiple of 8, the mma.sync form)."""
    x, w, *_ = _flce_inputs(dev, rows, d, 32768, torch.bfloat16,
                            torch.float32)
    runs = [fused_linear_ce.fused_linear_ce_fwd(x, w)[0] for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    torch.testing.assert_close(
        runs[0], fused_linear_ce.fused_linear_ce_fwd_plain(x, w)[0],
        rtol=1e-5, atol=1e-5)


def test_fused_linear_ce_is_deterministic(dev):
    x, w, labels, dloss, dz = _flce_inputs(dev, 300, 512, 32128,
                                           torch.bfloat16, torch.float32)
    runs = []
    for _ in range(3):
        lse, _ = fused_linear_ce.fused_linear_ce_fwd(x, w)
        runs.append((lse,) + fused_linear_ce.fused_linear_ce_bwd(
            x, w, labels, lse, dloss, dz, lse_square_scale=1e-4))
    for r in runs[1:]:
        for a, b in zip(r, runs[0]):
            assert torch.equal(a, b)


# The bf16 backward over chunks of rows and slabs of the vocabulary: one
# row more than the largest chunk at d 512 (two chunks, evened out), and
# one row; V 50257 (a bf16 lm_head whose rows are not 16-byte aligned is
# rounded slab by slab, as an f32 one is) and 32128; a bf16 and an f32
# lm_head (a bf16 one over two chunks keeps dW's f32 sums between them);
# z-loss and smoothing
@pytest.mark.parametrize("v", [50257, 32128])
@pytest.mark.parametrize("rows", ["chunk_plus_one", "one"])
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kw", [dict(lse_square_scale=1e-4),
                                dict(label_smoothing=0.1, logit_scale=2.0)],
                         ids=["zloss", "smoothing_scale"])
def test_fused_linear_ce_bwd_chunks(dev, v, rows, w_dtype, kw):
    d = 512
    n = fused_linear_ce.max_chunk_rows(d) + 1 if rows != "one" else 1
    assert n == 1 or fused_linear_ce.bwd_plan(n, d, v)[0] < n
    x, w, labels, dloss, dz = _flce_inputs(dev, n, d, v, torch.bfloat16,
                                           w_dtype)
    lse, _ = fused_linear_ce.fused_linear_ce_fwd_plain(
        x, w, logit_scale=kw.get("logit_scale", 1.0))
    dx, dw = fused_linear_ce.fused_linear_ce_bwd(x, w, labels, lse, dloss,
                                                 dz, **kw)
    dx0, dw0 = fused_linear_ce.fused_linear_ce_bwd_plain(x, w, labels, lse,
                                                         dloss, dz, **kw)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    _flce_close(dx, dx0, True)
    _flce_close(dw, dw0, True)


def test_fused_linear_ce_bwd_memory_is_bounded(dev):
    """At the train step's 2048 rows x V 32768 (d 512, bf16 activations, an
    f32 lm_head) the backward's peak memory above its inputs and its two
    outputs stays within the 64 MB workspace bound."""
    x, w, labels, dloss, dz = _flce_inputs(dev, 2048, 512, 32768,
                                           torch.bfloat16, torch.float32)
    lse, _ = fused_linear_ce.fused_linear_ce_fwd(x, w)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dx, dw = fused_linear_ce.fused_linear_ce_bwd(x, w, labels, lse, dloss,
                                                 dz, lse_square_scale=1e-4)
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base
             - dx.numel() * dx.element_size() - dw.numel() * dw.element_size())
    assert extra <= 64 * 10 ** 6, extra


@pytest.mark.parametrize("upstream", ["weighted", "loss_sum", "z_sum",
                                      "loss_and_z_sums"])
def test_fused_linear_ce_autograd_against_the_cpu(dev, upstream):
    """A `.sum()` hands the backward a stride-0 upstream gradient (and the
    labels are int64), so the wrapper converts per-row inputs before the
    launch; the gradients must match the CPU's either way."""
    x, w, labels, dloss, _ = _flce_inputs(dev, 200, 128, 1000,
                                          torch.float32, torch.float32)
    grads = []
    for device in (dev, "cpu"):
        xt = x.detach().to(device).requires_grad_(True)
        wt = w.detach().to(device).requires_grad_(True)
        loss, z = fused_linear_ce.fused_linear_cross_entropy(
            xt, wt, labels.to(device), 1e-4, 0.1)
        out = {"weighted": lambda: (loss * dloss.to(device)).sum(),
               "loss_sum": loss.sum, "z_sum": z.sum,
               "loss_and_z_sums": lambda: loss.sum() + z.sum()}[upstream]()
        out.backward()
        grads.append([t.detach().cpu() for t in (loss, z, xt.grad, wt.grad)])
    for g, g0 in zip(*grads):
        _close_to_max(g, g0, 1e-4)


def test_fused_linear_ce_refuses_what_it_does_not_take(dev):
    """Only the types and devices are refused: d 96 (not a multiple of 64)
    and d 640 (over 512), once refused, are taken and match the plain
    version."""
    x, w, *_ = _flce_inputs(dev, 16, 128, 256, torch.float32, torch.float32)
    x96, w96 = x[:, :96], w[:96]
    torch.testing.assert_close(
        fused_linear_ce.fused_linear_ce_fwd(x96, w96)[0],
        fused_linear_ce.fused_linear_ce_fwd_plain(x96, w96)[0],
        rtol=1e-5, atol=1e-5)
    x640, w640, *_ = _flce_inputs(dev, 4, 640, 8, torch.float32,
                                  torch.float32)
    torch.testing.assert_close(
        fused_linear_ce.fused_linear_ce_fwd(x640, w640)[0],
        fused_linear_ce.fused_linear_ce_fwd_plain(x640, w640)[0],
        rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        fused_linear_ce.fused_linear_ce_fwd(x, w.to(torch.bfloat16))
    with pytest.raises(TypeError):
        fused_linear_ce.fused_linear_ce_fwd(x.half(), w.half())
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_linear_ce.fused_linear_ce_fwd(x, w.cpu())


# ---------------------------------------------------------------------------
# generation: decode_attention on the caches `inference.generate` allocates
# (the activations' dtype: bf16 at FAT5-small, f32 on an f32 model), the
# decode state's steps against the CPU, and remat's memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["cross", "self"])
def test_decode_attention_at_generation_shapes(dev, kv, form):
    """Cross (8, 8, 512, 64) at every length 512, no bias; self (8, 8, 64,
    64), a bias row, lengths 1..57 (max_length 64)."""
    if form == "cross":
        q, args, lens, bias = _decode_case(dev, kv, 8, 8, 512, 64, [512],
                                           with_bias=False)
    else:
        q, args, lens, bias = _decode_case(dev, kv, 8, 8, 64, 64,
                                           [1, 9, 17, 25, 33, 41, 49, 57])
    got = decode_attention.decode_attention(q, *args, lengths=lens,
                                            bias=bias, sm_scale=0.125)
    want = decode_attention.decode_attention_plain(
        q, *args, lengths=lens, bias=bias, sm_scale=0.125)
    tol = 1e-4 if kv == "f32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _tiny_generation_model(dtype="float32"):
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.models import t5
    cfg = FlashT5Config(vocab_size=512, d_model=128, d_kv=64, num_heads=4,
                        d_ff=256, num_layers=2, num_decoder_layers=2,
                        dropout_rate=0.0, dtype=dtype,
                        attention_type="pallas_rpe",
                        use_fused_layernorm=True)
    return cfg, t5.init_params(cfg, seed=5, device="cpu")


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    return tree.to(device)


def test_generation_on_the_card_matches_the_cpu(dev):
    """A tiny f32 model: the decode steps' logits within 1e-4 of the CPU's
    (sums in another order), and greedy, beam and speculative tokens equal
    to the CPU's; sampled streams bit-equal from one seed."""
    from flasht5_tpu_torch.inference import (beam_generate, decode_step,
                                             generate, init_decode_state,
                                             speculative_generate)
    from flasht5_tpu_torch.models import t5
    cfg, cpu = _tiny_generation_model()
    gpu = _on(cpu, dev)
    ids = torch.randint(2, 512, (3, 20), generator=torch.Generator()
                        .manual_seed(1))
    for fn, kw in ((generate, {}), (beam_generate, dict(num_beams=4)),
                   (speculative_generate, dict(window=4))):
        a = fn(cfg, cpu, ids, max_length=12, **kw)
        b = fn(cfg, gpu, ids.to(dev), max_length=12, **kw)
        a, b = (a[0], b[0]) if isinstance(a, tuple) else (a, b)
        assert torch.equal(a, b.cpu())
    logits = []
    for params, device in ((cpu, "cpu"), (gpu, dev)):
        state = init_decode_state(cfg, params,
                                  t5.encode(cfg, params, ids.to(device)), 8)
        tok = torch.zeros((3,), dtype=torch.int64, device=device)
        steps = []
        for _ in range(8):
            out, state = decode_step(cfg, params, state, tok)
            steps.append(out.cpu())
            tok = (tok + 7) % 512
        logits.append(torch.stack(steps))
    torch.testing.assert_close(logits[1], logits[0], rtol=1e-4, atol=1e-4)
    runs = [generate(cfg, gpu, ids.to(dev), max_length=12, temperature=1.0,
                     top_k=20, top_p=0.9,
                     generator=torch.Generator(device=dev).manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


def test_remat_lowers_the_train_steps_peak_memory(dev):
    """`remat` keeps no block activations for the backward: the peak memory
    of one forward and backward is lower, and the gradients are the same
    to 1e-3 of each one's largest entry (the recompute launches the same
    kernels; a shared leaf's contributions may be added in another
    order)."""
    import dataclasses
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.models import t5
    cfg = FlashT5Config(vocab_size=4096, d_model=512, d_kv=64, num_heads=8,
                        d_ff=2048, num_layers=4, num_decoder_layers=4,
                        dropout_rate=0.0, dtype="bfloat16",
                        attention_type="pallas_rpe",
                        use_fused_layernorm=True,
                        use_fused_crossentropy=True)
    params = t5.init_params(cfg, seed=0, device=dev)
    leaves = [leaf.requires_grad_(True)
              for _, leaf in t5.tree_leaves_with_path(params)]
    g = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(2, 4096, (8, 1024), device=dev, generator=g)
    labels = torch.randint(2, 4096, (8, 256), device=dev, generator=g)
    peaks, grads = [], []
    for remat in (False, True):
        for leaf in leaves:
            leaf.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = t5.forward(dataclasses.replace(cfg, remat=remat), params,
                          input_ids=ids, labels=labels)["loss"]
        loss.backward()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        grads.append([leaf.grad.float().clone() for leaf in leaves])
    assert peaks[1] < 0.8 * peaks[0]
    for a, b in zip(*grads):
        _close_to_max(b, a, 1e-3)


# ---------------------------------------------------------------------------
# the positional encodings: head dims the wrappers pad, ALiBi's and FIRE's
# biases on the bias kernels and the decode kernel, and tiny models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 48, 96])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table", [True, False])
def test_attention_kernels_at_padded_head_dims(dev, d, causal, dtype, table):
    """d 16, 48 and 96 run zero-padded to 32, 64 and 128: the forward and
    the backward against the plain versions at d itself, with the
    tolerances above; outputs of width d."""
    q, do = (torch.randn((2, 4, 100, d), device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((2, 4, 300, d), device=dev).to(dtype)
            for _ in range(2))
    w = torch.randn((32, 4), device=dev) if table else None
    kw = dict(causal=causal, bidirectional=not causal, sm_scale=d ** -0.5)
    o, lse = flash_attention_rpe.flash_attention_rpe_fwd(q, k, v, w, **kw)
    o0, lse0 = flash_attention_rpe.flash_attention_rpe_plain(q, k, v, w,
                                                              **kw)
    assert o.shape == q.shape
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse0, rtol=1e-4, atol=1e-4)
    delta = (do.float() * o.float()).sum(-1)
    got = flash_attention_rpe.flash_attention_bwd(q, k, v, w, lse, delta, do,
                                                  **kw)
    want = flash_attention_rpe.flash_attention_bwd_plain(q, k, v, w, lse,
                                                         delta, do, **kw)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    for g, g0 in zip(got[:3], want[:3]):
        assert g.shape == g0.shape
        _close_to_max(g, g0, tol)
    if table:
        bound = _dw_error_bound(q, k, w, lse, delta, do, v, kw)
        assert torch.all((got[3] - want[3]).abs() <= bound)


@pytest.mark.parametrize("d", [16, 48, 96])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("L", [66, 1000])
def test_decode_attention_at_padded_head_dims(dev, d, kv, L):
    """d 16, 48 and 96 run zero-padded to 32, 64 and 128 (q and the cache;
    an int8 cache's scales unchanged): against the plain version at d
    itself, with `test_decode_attention_splits`' tolerances; outputs of
    width d."""
    b, h = 4, 4
    q, args, lens, bias = _decode_case(dev, kv, b, h, L, d, [0, 1, 37, L])
    got = decode_attention.decode_attention(q, *args, lengths=lens,
                                            bias=bias, sm_scale=d ** -0.5)
    want = decode_attention.decode_attention_plain(
        q, *args, lengths=lens, bias=bias, sm_scale=d ** -0.5)
    assert got.shape == (b, h, d) and got.is_contiguous()
    tol = 1e-4 if kv == "f32" else (1e-2 if L <= 512 else 2e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.all(got[lens == 0] == 0)


@pytest.mark.parametrize("d", [16, 48, 96])
@pytest.mark.parametrize("layout", ["standard", "fused"])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_paged_attention_at_padded_head_dims(dev, d, layout, kv):
    """The paged kernel at d 16, 48 and 96: q and both pools zero-padded
    (the scales unchanged), out, m and l against the plain version with
    `test_paged_attention_kernel`'s tolerances."""
    q, args, bias = _paged_case(dev, kv, d, layout, True)
    got = paged_attention.paged_attention(q, *args, bias=bias,
                                          sm_scale=d ** -0.5,
                                          return_state=True)
    want = paged_attention.paged_attention_plain(q, *args, bias=bias,
                                                 sm_scale=d ** -0.5,
                                                 return_state=True)
    assert got[0].shape == q.shape
    tol = 2e-2 if kv == "bf16" else 1e-4
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                               atol=tol)
    for g, g0 in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, g0, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [16, 48, 96])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_kernels_at_padded_head_dims(dev, d, causal, dtype):
    q, k, v, bias, do = _bias_inputs(dev, 100, 300, d, dtype, "1h")
    kw = dict(causal=causal, sm_scale=d ** -0.5)
    o, lse = flash_attention.flash_attention_bias_fwd(q, k, v, bias, **kw)
    o0, lse0 = flash_attention.flash_attention_bias_plain(q, k, v, bias, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse0, rtol=1e-4, atol=1e-4)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, bias, lse, delta, do)
    got = flash_attention.flash_attention_bias_dkv(*args, **kw) + (
        flash_attention.flash_attention_bias_dq(*args, **kw),)
    want = flash_attention.flash_attention_bias_dkv_plain(*args, **kw) + (
        flash_attention.flash_attention_bias_dq_plain(*args, **kw),)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    for g, g0, t in zip(got, want, (tol, tol, 1e-3, tol)):
        assert g.shape == g0.shape
        _close_to_max(g, g0, t)


@pytest.mark.parametrize("length,causal", [(1024, False), (256, True)])
def test_attention_without_a_table_on_rope_inputs(dev, length, causal):
    """RoPE's self-attention at its training shapes (the encoder's 1024
    positions bidirectional, the decoder's 256 causal), bf16, no table:
    q and k rotated by the model's tables, the forward and the backward
    (tensor-core bodies) against the plain versions with the bf16
    tolerances above; the keys rolled by one position (a planted fault)
    take the output and dq beyond them."""
    from flasht5_tpu_torch import positional
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.models import t5
    cfg = FlashT5Config(d_kv=64, position_encoding_type="RoPE")
    cos, sin, ck, sk = t5.rope_tables_for(cfg, length, dev)

    def rotated(x, c, s):   # (B, H, L, D) by the tables' first L rows
        return positional.apply_rotary(x.transpose(1, 2), c[:length],
                                       s[:length]).transpose(1, 2)
    q, k, v, do = (torch.randn((2, 8, length, 64), device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    q, k = rotated(q, cos, sin), rotated(k, ck, sk)
    kw = dict(causal=causal, bidirectional=not causal, sm_scale=0.125)
    o, lse = flash_attention_rpe.flash_attention_rpe_fwd(q, k, v, None, **kw)
    o0, lse0 = flash_attention_rpe.flash_attention_rpe_plain(q, k, v, None,
                                                              **kw)
    torch.testing.assert_close(o.float(), o0.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, lse0, rtol=1e-4, atol=1e-4)
    delta = (do.float() * o.float()).sum(-1)
    got = flash_attention_rpe.flash_attention_bwd(q, k, v, None, lse, delta,
                                                  do, **kw)
    want = flash_attention_rpe.flash_attention_bwd_plain(q, k, v, None, lse,
                                                         delta, do, **kw)
    for g, g0 in zip(got[:3], want[:3]):
        _close_to_max(g, g0, 3e-2)
    rolled = torch.roll(k, 1, dims=2)
    o_bad, _ = flash_attention_rpe.flash_attention_rpe_fwd(q, rolled, v,
                                                           None, **kw)
    assert bool(((o_bad.float() - o0.float()).abs()
                 > 2e-2 + 2e-2 * o0.float().abs()).any())
    dq_bad = flash_attention_rpe.flash_attention_bwd(
        q, rolled, v, None, lse, delta, do, **kw)[0]
    scale = float(want[0].float().abs().max())
    assert float((dq_bad.float() - want[0].float()).abs().max()) \
        > 3e-2 * scale


def test_attention_refuses_head_dims_over_128(dev):
    q = torch.randn((1, 2, 8, 160), device=dev)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention_rpe.flash_attention_rpe_fwd(q, q, q, None)


@pytest.mark.parametrize("encoding", ["alibi_asym", "fire"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoding_biases_through_the_bias_kernels(dev, encoding, causal,
                                                  dtype):
    """The model's `flash_attention` on ALiBi's asymmetric bias (-inf
    clamped at -1e29 by the wrapper; no gradient wanted) and on FIRE's
    (its gradient reaches the MLP and the scalars through dbias), card
    against CPU: o and every gradient to 1e-3 of each one's largest entry
    in f32, 3e-2 in bf16. The bias rows shifted by one must move o beyond
    that, except FIRE's in bf16: its rows vary slowly, and one row's shift
    moved o by 1.7e-2 on an H100, under 3e-2 of o's largest entry (its f32
    cases hold it)."""
    from flasht5_tpu_torch import positional
    m = n = 200
    cpu_fire = positional.init_fire_params(torch.Generator().manual_seed(0),
                                           4, init_L=64.0)
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn((2, 4, m, 64), generator=g).to(dtype)
                   for _ in range(4))
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    runs = []
    for device, shift in ((dev, 0), ("cpu", 0), (dev, 1)):
        ts = [_fresh(t, device) for t in (q, k, v)]
        fire = _fresh(cpu_fire, device)
        leaves = [fire["mlp"]["w1"], fire["mlp"]["w2"], fire["c"],
                  fire["init_L"]]
        if encoding == "fire":
            bias = positional.fire_bias(fire, m)
        else:
            bias = positional.alibi_bias(4, m, n, mode="asymetric",
                                         device=device)
        bias = torch.roll(bias, shift, dims=2)
        o = flash_attention.flash_attention(*ts, bias, causal=causal,
                                            sm_scale=0.125)
        o.backward(do.to(device))
        grads = [t.grad for t in ts]
        if encoding == "fire":
            grads += [leaf.grad for leaf in leaves]
        runs.append([o.detach().cpu()] + [t.cpu() for t in grads])
    (card, cpu, faulted) = runs
    for a, b in zip(card, cpu):
        _close_to_max(a, b, tol)
    if dtype == torch.float32 or encoding == "alibi_asym":
        scale = float(cpu[0].float().abs().max())
        assert float((faulted[0].float() - cpu[0].float()).abs().max()) \
            > tol * scale


@pytest.mark.parametrize("shape,lengths", [
    ((8, 8, 64), [1, 9, 17, 25, 33, 41, 49, 57]),
    ((8, 8, 512), [512, 449, 385, 300, 200, 129, 64, 2]),
    ((2, 8, 1000), [1000, 700])])
@pytest.mark.parametrize("kv", ["f32", "bf16"])
def test_decode_attention_on_asymmetric_alibi_rows(dev, shape, lengths, kv):
    """ALiBi's asymmetric rows as the decode state builds them: half the
    heads see the past, half only the query's own position, -1e29
    elsewhere, so whole warp and cluster shares hold only masked positions
    (where exp(-inf - (-inf)) would give NaN). The kernel at every split
    its plan takes against the plain version (the tolerances of
    test_decode_attention_kernel); the rows shifted by one position move
    the output beyond them."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.inference import kv_cache
    b, h, L = shape
    q, args, lens, _ = _decode_case(dev, kv, b, h, L, 64, lengths)
    cfg = FlashT5Config(num_heads=h, d_kv=64, position_encoding_type="ALiBi",
                        alibi_mode="asymetric")
    sa = {"Wq": torch.empty((64 * h, 64 * h))}
    bias = torch.stack([kv_cache._self_bias(cfg, sa, n - 1, 1, L, dev)
                        [0, :, 0] for n in lengths])
    kw = dict(lengths=lens, sm_scale=0.125)
    got = decode_attention.decode_attention(q, *args, bias=bias, **kw)
    want = decode_attention.decode_attention_plain(q, *args, bias=bias, **kw)
    assert torch.isfinite(got.float()).all()
    tol = 1e-4 if kv == "f32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    moved = decode_attention.decode_attention(
        q, *args, bias=torch.roll(bias, 1, dims=2), **kw)
    assert float((moved.float() - want.float()).abs().max()) > 10 * tol


def _fresh(tree, device):
    """A copy of the tree's tensors on `device`, leaves that take grads."""
    if isinstance(tree, dict):
        return {k: _fresh(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fresh(v, device) for v in tree]
    return tree.detach().to(device, copy=True).requires_grad_(True)


_ENCODINGS = {
    "alibi": dict(position_encoding_type="ALiBi"),
    "alibi_asym_h6": dict(position_encoding_type="ALiBi",
                          alibi_mode="asymetric", num_heads=6),
    "rope": dict(position_encoding_type="RoPE"),
    "rope_frac_inter_xpos": dict(position_encoding_type="RoPE",
                                 rotary_emb_fraction=0.5,
                                 rotary_interleaved=True,
                                 rotary_scale_base=512.0),
    "fire": dict(position_encoding_type="FIRE"),
}


@pytest.mark.parametrize("encoding", sorted(_ENCODINGS))
def test_encodings_on_the_card_match_the_cpu(dev, encoding):
    """A tiny f32 model (d_kv 64, 2+2 layers, `pallas`) per encoding: the
    loss and logits within 1e-4, every gradient leaf within 1e-4 of its
    largest entry (f32 sums in another order), and greedy and speculative
    (window 4) tokens equal to the CPU's. A leaf whose gradient sums terms
    that cancel exactly (FIRE's b2: each row of dS sums to 0) is rounding
    noise on both sides, so each leaf's scale is at least 1e-2 of the
    largest gradient entry of the model (b2's gap measured 1.6e-7 of it on
    an H100)."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.inference import generate, speculative_generate
    from flasht5_tpu_torch.models import t5
    cfg = FlashT5Config(**dict(
        dict(vocab_size=512, d_model=128, d_kv=64, num_heads=4, d_ff=256,
             num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
             dtype="float32", attention_type="pallas",
             use_fused_layernorm=True), **_ENCODINGS[encoding]))
    cpu = t5.init_params(cfg, seed=5, device="cpu")
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(2, 512, (2, 80), generator=g)
    labels = torch.randint(2, 512, (2, 30), generator=g)
    runs = []
    for device in ("cpu", dev):
        params = _fresh(cpu, device)
        leaves = [p for _, p in t5.tree_leaves_with_path(params)]
        out = t5.forward(cfg, params, input_ids=ids.to(device),
                         labels=labels.to(device))
        out["loss"].backward()
        with torch.no_grad():
            tokens = [fn(cfg, params, ids.to(device), max_length=12,
                         **kw).cpu()
                      for fn, kw in ((generate, {}),
                                     (speculative_generate,
                                      dict(window=4)))]
        runs.append((out["loss"].detach().cpu(), out["logits"].detach().cpu(),
                     [p.grad.cpu() for p in leaves], tokens))
    (loss0, logits0, grads0, tok0), (loss1, logits1, grads1, tok1) = runs
    torch.testing.assert_close(loss1, loss0, rtol=1e-4, atol=0)
    torch.testing.assert_close(logits1, logits0, rtol=0, atol=1e-4)
    floor = 1e-2 * max(float(g.abs().max()) for g in grads0)
    for a, b in zip(grads1, grads0):
        scale = max(float(b.abs().max()), floor)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale)
    for a, b in zip(tok1, tok0):
        assert torch.equal(a, b)


def test_timed_waits_for_the_card_when_fn_returns_no_tensor(dev):
    """`utils.profiling.timed` on a call that queues a matmul on the card
    and returns None: the host clock must span the matmuls (about 3 ms
    each in f32), not only their enqueueing (microseconds)."""
    from flasht5_tpu_torch.utils.profiling import timed
    x = torch.randn((4096, 4096), device=dev)
    with_tensor = timed(lambda: x @ x, iters=5, warmup=1)
    without = timed(lambda: (x @ x, None)[1], iters=5, warmup=1)
    assert without >= 0.5 * with_tensor


# ---------------------------------------------------------------------------
# the vocab-parallel loss (parallel/vocab_parallel.py) on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_rank(dev, tmp_path):
    """A one-rank NCCL process group, for the length of a test."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _vp_inputs(dev, rows=2048, v=32768):
    logits = (3 * torch.randn((rows, v), device=dev)).to(torch.bfloat16)
    labels = torch.randint(0, v, (rows,), device=dev)
    labels[::7] = -100
    return logits, labels


@pytest.mark.parametrize("fused,smoothing,z", [(True, 0.0, 1e-4),
                                               (False, 0.1, 1e-3)])
def test_vocab_parallel_loss_on_one_nccl_rank(dev, nccl_rank, monkeypatch,
                                              fused, smoothing, z):
    """`vocab_parallel_loss` on the CE kernels, over a one-rank NCCL group,
    against the plain unsplit loss (cross_entropy_loss_ref, autograd) with
    the same reduction: the loss to 1e-5 relative (f32 sums in another
    order); dlogits of both losses times their row count (entries up to
    about 1, as a row's own dloss of 1 gives) to 1e-2 + 1e-2 |entry|, the
    CE kernels' bf16 test. The planted fault, the backward's one-hot one
    class off (`class_start_idx` one too high), lands beyond that."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.parallel import vocab_parallel
    logits, labels = _vp_inputs(dev)
    cfg = FlashT5Config(vocab_size=logits.shape[1],
                        use_fused_crossentropy=fused,
                        label_smoothing=smoothing, z_loss=z)
    den = labels.numel() if fused else int((labels != -100).sum())
    want_in = logits.clone().requires_grad_()
    losses, _ = cross_entropy.cross_entropy_loss_ref(
        want_in, labels, lse_square_scale=z, label_smoothing=smoothing)
    want = losses.sum() / den
    (want * den).backward()
    want_grad = want_in.grad.float()

    def run():
        got_in = logits.clone().requires_grad_()
        got = vocab_parallel.vocab_parallel_loss(cfg, got_in, labels,
                                                 nccl_rank)
        (got * den).backward()
        return got, got_in.grad.float()

    got, got_grad = run()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    assert float(want_grad.abs().max()) > 0.5
    torch.testing.assert_close(got_grad, want_grad, rtol=1e-2, atol=1e-2)
    real = vocab_parallel.split_backward
    monkeypatch.setattr(
        vocab_parallel, "split_backward",
        lambda *a, class_start_idx, **kw: real(
            *a, class_start_idx=class_start_idx + 1, **kw))
    _, bad_grad = run()
    assert bool(((bad_grad - want_grad).abs()
                 > 1e-2 + 1e-2 * want_grad.abs()).any())


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_split_backward_takes_the_global_lse(dev, smoothing):
    """Four shards' backward kernels (`vocab_parallel.split_backward`, what
    each of four tensor ranks runs) with the global lse give the unsplit
    gradient's columns (1e-2, the CE kernels' bf16 limit); the planted
    fault, each shard's own lse, lands beyond that limit."""
    from flasht5_tpu_torch.parallel.vocab_parallel import split_backward
    logits, labels = _vp_inputs(dev)
    rows, v = logits.shape
    dloss = torch.ones((rows,), device=dev)
    kw = dict(lse_square_scale=1e-4, label_smoothing=smoothing,
              total_classes=v)
    lse = torch.logsumexp(logits.float(), dim=-1)
    want = cross_entropy.cross_entropy_bwd_plain(
        logits, labels, lse, dloss, torch.zeros_like(lse),
        lse_square_scale=1e-4, label_smoothing=smoothing).float()
    scale = float(want.abs().max())
    for fault in (False, True):
        parts = []
        for start in range(0, v, v // 4):
            shard = logits[:, start:start + v // 4].contiguous()
            shard_lse = (torch.logsumexp(shard.float(), dim=-1) if fault
                         else lse)
            parts.append(split_backward(shard, labels, shard_lse, dloss,
                                        class_start_idx=start, **kw))
        err = float((torch.cat(parts, dim=1).float() - want).abs().max())
        if fault:
            assert err > 1e-2 * scale + 1e-2, (err, scale)
        else:
            torch.testing.assert_close(torch.cat(parts, dim=1).float(), want,
                                       rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# serving across ranks (inference/sharded_engine.py, sharded_paged_engine.py)
# at one NCCL rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_sharded_engines_on_one_nccl_rank(dev, nccl_rank, paged):
    """Both sharded engines at mesh (1, 1) serve the single-device engines'
    tokens on the card, request by request (a one-rank all-reduce and
    all-gather are the identity): a tiny f32 model with int8 weights and
    KV, the slot engine on the decode kernel."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.inference import engine, paged_engine
    from flasht5_tpu_torch.inference.sharded_engine import (
        ShardedEngine, make_serving_mesh)
    from flasht5_tpu_torch.inference.sharded_paged_engine import (
        ShardedPagedEngine)
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.quantize import quantize_params
    cfg = FlashT5Config(vocab_size=512, d_model=128, d_kv=32, num_heads=4,
                        d_ff=256, num_layers=2, num_decoder_layers=2,
                        dropout_rate=0.0, attention_scale=1.0,
                        dtype="float32", attention_type="pallas_rpe",
                        use_fused_layernorm=True)
    params = quantize_params(t5.init_params(cfg, seed=3, device=dev), "int8")
    if paged:
        single, sharded = (paged_engine.PagedInferenceEngine,
                           ShardedPagedEngine)
        ecfg = paged_engine.PagedEngineConfig(
            max_slots=3, page_size=8, num_pages=12, max_pages_per_slot=3,
            max_encode_len=32, encode_buckets=(16, 32), kv_dtype="int8",
            steps_per_sync=3)
    else:
        single, sharded = engine.InferenceEngine, ShardedEngine
        ecfg = engine.EngineConfig(
            max_slots=3, max_decode_len=20, max_encode_len=32,
            encode_buckets=(16, 32), kv_dtype="int8", steps_per_sync=4,
            use_decode_kernel=True)
    def requests():
        g = torch.Generator().manual_seed(5)
        return [engine.Request(uid=i, input_ids=torch.randint(
            2, 512, (n,), generator=g).numpy().astype("int32"),
            max_new_tokens=17) for i, n in enumerate((12, 30, 7, 25, 16))]
    want = {r.uid: r.result.tolist()
            for r in single(cfg, params, ecfg, device=dev).run(requests())}
    eng = sharded(cfg, params, ecfg, make_serving_mesh(1, 1), device=dev)
    got = {r.uid: r.result.tolist() for r in eng.run(requests())}
    assert got == want
