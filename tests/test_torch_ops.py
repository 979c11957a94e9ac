"""Per-module parity of the PyTorch port's ops with the JAX package.

Inputs are made from a numpy seed and fed to both packages. The JAX side
runs its Pallas kernels in interpret mode (tests/conftest.py); the port side
runs on the CPU, i.e. the plain PyTorch version of each kernel, which
mirrors the TPU kernel's rounding points. The Hopper kernels themselves are
held against their plain versions on the card by tests/test_torch_cuda.py.

Tolerances: 1e-5 where both sides compute in f32 throughout (only the
summation order differs); 1e-4 where both round the same values to bf16 at
the same points (int8 decode attention, the dequant matmul), which leaves
the summation order and rare one-ulp bf16 flips of values that differ by an
f32 ulp.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flasht5_tpu import positional as jpos
from flasht5_tpu.ops import decode_attention as jdec
from flasht5_tpu.ops.attn_ref import attn_ref as jattn_ref
from flasht5_tpu.ops import flash_attention_rpe as jrpe
from flasht5_tpu.ops import quant as jquant
from flasht5_tpu.ops import rmsnorm as jrms
from flasht5_tpu_torch import positional, runtime
from flasht5_tpu_torch.ops import (attn_ref, decode_attention,
                                   flash_attention_rpe, quant, rmsnorm)


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# relative_position_bucket: every offset in [-4096, 4096]
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (32, 64),
                                                      (16, 32)])
def test_bucket_matches_jax_everywhere(bidirectional, num_buckets,
                                       max_distance):
    rel = np.arange(-4096, 4097, dtype=np.int32)
    want = _np(jpos.relative_position_bucket(
        jnp.asarray(rel), bidirectional=bidirectional,
        num_buckets=num_buckets, max_distance=max_distance))
    got = positional.relative_position_bucket(
        _t(rel), bidirectional=bidirectional, num_buckets=num_buckets,
        max_distance=max_distance).numpy()
    np.testing.assert_array_equal(got, want)
    lut = positional.bucket_lut(-4096, 4096, bidirectional=bidirectional,
                                num_buckets=num_buckets,
                                max_distance=max_distance, device="cpu")
    np.testing.assert_array_equal(lut.numpy(), want)


def test_bucket_exact_integer_offsets():
    """The float32 log lands exactly on 2.0, 4.0 and 6.0 at |rel| = 16, 32
    and 64 (16 buckets per direction, max_exact 8): those offsets belong to
    buckets 8 + 2, 8 + 4 and 8 + 6, not the bucket below."""
    rel = torch.tensor([-64, -32, -16, -15, 15, 16, 32, 64], dtype=torch.int32)
    got = positional.relative_position_bucket(rel, bidirectional=True)
    assert got.tolist() == [14, 12, 10, 9, 25, 26, 28, 30]


def test_t5_relative_bias_matches_jax():
    table = np.random.default_rng(0).standard_normal((32, 4)).astype(np.float32)
    for bidirectional in (True, False):
        want = _np(jpos.t5_relative_bias(
            {"relative_attention_bias": jnp.asarray(table)}, 37, 53,
            bidirectional=bidirectional))
        got = positional.t5_relative_bias(
            {"relative_attention_bias": _t(table)}, 37, 53,
            bidirectional=bidirectional)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# rms_norm
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax_kernel():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 21, 128)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    want = _np(jrms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    y, rstd = rmsnorm.rms_norm_fwd(_t(x), _t(w), 1e-6)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)
    assert rstd.shape == (3, 21)
    np.testing.assert_allclose(
        rstd.numpy(), 1.0 / np.sqrt(np.mean(x * x, -1) + 1e-6), rtol=1e-5)


def test_rms_norm_ref_matches_jax_ref():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    want = _np(jrms.rms_norm_ref(jnp.asarray(x), jnp.asarray(w)))
    got = rmsnorm.rms_norm_ref(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# flash_attention_rpe and attn_ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("m_len,n_len", [(48, 48), (40, 72), (72, 40)])
def test_flash_attention_rpe_matches_jax(causal, m_len, n_len):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, m_len, 32)).astype(np.float32)
    k = rng.standard_normal((2, 4, n_len, 32)).astype(np.float32)
    v = rng.standard_normal((2, 4, n_len, 32)).astype(np.float32)
    w = rng.standard_normal((32, 4)).astype(np.float32)
    kw = dict(causal=causal, sm_scale=0.5, bidirectional=not causal,
              num_buckets=32, max_distance=128)
    want = _np(jrpe.flash_attention_rpe(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(w), **kw))
    got = flash_attention_rpe.flash_attention_rpe(_t(q), _t(k), _t(v), _t(w),
                                                  **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the plain version also agrees with the attention oracle on the
    # materialized bias
    bias = positional.t5_relative_bias(
        {"relative_attention_bias": _t(w)}, m_len, n_len,
        bidirectional=not causal)
    oracle = attn_ref.attn_ref(_t(q), _t(k), _t(v), bias, sm_scale=0.5,
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_rpe_needs_a_table():
    """Without a bucket table, `flash_attention_rpe` is plain flash
    attention, as in the JAX package (`flash_attention_rpe.py:1476-1479`):
    forward and backward match the JAX `flash_attention(q, k, v, None)`."""
    from flasht5_tpu.ops import flash_attention as jfa
    rng = np.random.default_rng(9)
    q, k, v, do = (rng.standard_normal((2, 4, n, 32)).astype(np.float32)
                   for n in (24, 40, 40, 24))
    o_j, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, None),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    o = flash_attention_rpe.flash_attention_rpe(*ts, None)
    o.backward(_t(do))
    np.testing.assert_allclose(o.detach().numpy(), _np(o_j), rtol=1e-5,
                               atol=1e-5)
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), _np(g), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_attn_ref_matches_jax(causal):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 3, 20, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, 12, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 12, 16)).astype(np.float32)
    bias = rng.standard_normal((1, 3, 20, 12)).astype(np.float32)
    want = _np(jattn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(bias), sm_scale=0.7, causal=causal))
    got = attn_ref.attn_ref(_t(q), _t(k), _t(v), _t(bias), sm_scale=0.7,
                            causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# quantization and the dequant matmul
# ---------------------------------------------------------------------------

def _weight(seed=5, shape=(256, 384)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.05


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("group_size", [None, 128])
def test_quantize_bit_equal(mode, group_size):
    w = _weight()
    jfn = {"int8": jquant.quantize_int8, "fp8": jquant.quantize_fp8}[mode]
    tfn = {"int8": quant.quantize_int8, "fp8": quant.quantize_fp8}[mode]
    want = jfn(jnp.asarray(w), group_size)
    got = tfn(_t(w), group_size)
    wq = _np(want.qvalues)
    if mode == "fp8":
        np.testing.assert_array_equal(got.qvalues.view(torch.uint8).numpy(),
                                      wq.view(np.uint8))
    else:
        np.testing.assert_array_equal(got.qvalues.numpy(), wq)
    np.testing.assert_array_equal(got.scales.numpy(), _np(want.scales))
    np.testing.assert_array_equal(
        quant.dequantize(got).numpy(), _np(jquant.dequantize(want)))


def test_quantize_kv_bit_equal():
    x = np.random.default_rng(6).standard_normal((2, 4, 9, 32)).astype(
        np.float32)
    x[0, 1, 3] = 0.0   # an all-zero row takes scale 1
    want_q, want_s = jquant.quantize_kv(jnp.asarray(x))
    got_q, got_s = quant.quantize_kv(_t(x))
    np.testing.assert_array_equal(got_q.numpy(), _np(want_q))
    np.testing.assert_array_equal(got_s.numpy(), _np(want_s))
    np.testing.assert_array_equal(
        quant.dequantize_kv(got_q, got_s).numpy(),
        _np(jquant.dequantize_kv(want_q, want_s)))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("group_size", [None, 128])
def test_quant_matmul_matches_jax_kernel(mode, group_size):
    x = np.random.default_rng(7).standard_normal((3, 5, 256)).astype(
        np.float32)
    w = _weight()
    jfn = {"int8": jquant.quantize_int8, "fp8": jquant.quantize_fp8}[mode]
    jqt = jfn(jnp.asarray(w), group_size)
    want = _np(jquant.quant_matmul(jnp.asarray(x), jqt))
    qt = quant.QuantizedTensor(
        torch.from_numpy(_np(jqt.qvalues).view(np.uint8).copy()).view(
            torch.float8_e4m3fn) if mode == "fp8" else _t(_np(jqt.qvalues)),
        _t(_np(jqt.scales)))
    got = quant.quant_matmul(_t(x), qt)
    assert got.shape == (3, 5, 384) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the oracle (no bf16 rounding of x) against the JAX package's
    np.testing.assert_allclose(
        quant.quant_matmul_ref(_t(x), qt).numpy(),
        _np(jquant.quant_matmul_ref(jnp.asarray(x), jqt)),
        rtol=1e-5, atol=1e-5)


# The decode form's K plan: FAT5-small's decode projections and lm_head,
# a wider K, K too short for four warps of 16 rows, and shapes that take
# the mma.sync form on the card (N not a multiple of 16), whose plan is
# computed and ignored
_DECODE_SHAPES = [(512, 512), (512, 2048), (2048, 512), (512, 32768),
                  (4096, 1024), (96, 512), (32, 64), (512, 90), (2048, 100)]


@pytest.mark.parametrize("k_dim,n_dim", _DECODE_SHAPES)
def test_decode_plan_covers_k_exactly(k_dim, n_dim):
    """The pieces run in the kernel's order, cover K once without a gap,
    and start and end on the mma's 16-row steps; the cluster is a power of
    two of at most 8 CTAs of at most 8 warps."""
    splits, warps, k_piece = quant.decode_plan(k_dim, n_dim)
    assert splits in (1, 2, 4, 8) and 1 <= warps <= 8
    assert k_piece % 16 == 0 and splits * warps * k_piece >= k_dim
    pieces = quant.decode_pieces(k_dim, n_dim)
    assert len(pieces) == splits * warps
    assert pieces[0][0] == 0 and pieces[-1][1] == k_dim
    for (_, end), (begin, _) in zip(pieces, pieces[1:]):
        assert end == begin
    assert all(0 <= b - a <= k_piece and a % 16 == 0 and b % 16 == 0
               for a, b in pieces)
    assert sum(b - a for a, b in pieces) == k_dim


def test_decode_plan_fills_the_card():
    """At FAT5-small's decode shapes K is cut into 8 pieces or more (the
    on-card check leaves one out), the lm_head runs on about two CTAs an SM
    of the H100's 132, and a 512-wide projection on clusters of 8 CTAs,
    32 in all."""
    ctas = {}
    for k_dim, n_dim in [(512, 512), (512, 2048), (2048, 512), (512, 32768)]:
        splits, warps, k_piece = quant.decode_plan(k_dim, n_dim)
        assert splits * warps >= 8 and 16 <= k_piece <= 64
        ctas[(k_dim, n_dim)] = -(-n_dim // 128) * splits
    assert ctas[(512, 32768)] >= 1.9 * 132
    assert ctas[(512, 512)] == ctas[(2048, 512)] == 32
    assert quant.decode_plan(512, 512)[0] == 8


@pytest.mark.parametrize("k_dim,group_size", [(512, None), (512, 32),
                                              (512, 256), (2048, 64),
                                              (4096, 128), (4096, 256)])
def test_decode_pieces_fold_group_scales(k_dim, group_size):
    """The decode form's arithmetic over its pieces, in plain PyTorch: each
    piece's products summed per scale group and scaled at the group's end
    or the piece's end (a piece boundary inside a group splits its sum),
    the pieces added in the kernel's order, per-channel scales last; it
    agrees with the plain version's order of sums."""
    rng = np.random.default_rng(9)
    n_dim = 256
    x = _t(rng.standard_normal((8, k_dim)).astype(np.float32)).to(
        torch.bfloat16)
    qt = quant.quantize_int8(_t(_weight(10, (k_dim, n_dim))),
                             group_size)
    xb, w = x.float(), qt.qvalues.float()
    groups = qt.scales.shape[0]
    gs = k_dim // groups
    pieces = quant.decode_pieces(k_dim, n_dim)
    assert groups == 1 or any(a % gs or b % gs for a, b in pieces)
    total = torch.zeros((8, n_dim))
    for a, b in pieces:
        acc = torch.zeros((8, n_dim))
        k = a
        while k < b:
            end = min(b, (k // gs + 1) * gs)
            part = xb[:, k:end] @ w[k:end]
            acc = acc + (part * qt.scales[k // gs] if groups > 1 else part)
            k = end
        total = total + acc
    if groups == 1:
        total = total * qt.scales
    torch.testing.assert_close(total.to(torch.bfloat16).float(),
                               quant.quant_matmul_plain(x, qt).float(),
                               rtol=2.0 ** -7, atol=1e-3)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_decode_attention_matches_jax_kernel(kv, with_bias, with_lengths):
    rng = np.random.default_rng(8)
    b, h, L, d = 3, 4, 40, 32
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, h, L, d)).astype(np.float32)
    v = rng.standard_normal((b, h, L, d)).astype(np.float32)
    bias = (rng.standard_normal((b, h, L)).astype(np.float32)
            if with_bias else None)
    lengths = np.array([40, 17, 1], np.int32) if with_lengths else None
    jargs = [jnp.asarray(k), jnp.asarray(v)]
    targs = [_t(k), _t(v)]
    if kv == "int8":
        kq, ks = jquant.quantize_kv(jnp.asarray(k))
        vq, vs = jquant.quantize_kv(jnp.asarray(v))
        jargs = [kq, vq, ks, vs]
        targs = [_t(_np(a)) for a in jargs]
    opt = lambda a, f: None if a is None else f(a)   # noqa: E731
    want = _np(jdec.decode_attention(
        jnp.asarray(q), *jargs, lengths=opt(lengths, jnp.asarray),
        bias=opt(bias, jnp.asarray), sm_scale=0.8))
    got = decode_attention.decode_attention(
        _t(q), *targs, lengths=opt(lengths, _t), bias=opt(bias, _t),
        sm_scale=0.8)
    tol = 1e-5 if kv == "native" else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # and the oracle of the JAX package, ported
    ref = decode_attention.decode_attention_ref(
        _t(q), *targs, lengths=opt(lengths, _t), bias=opt(bias, _t),
        sm_scale=0.8)
    np.testing.assert_allclose(
        ref.numpy(),
        _np(jdec.decode_attention_ref(
            jnp.asarray(q), *jargs, lengths=opt(lengths, jnp.asarray),
            bias=opt(bias, jnp.asarray), sm_scale=0.8)),
        rtol=1e-5, atol=1e-5)


def test_decode_attention_empty_slot_gives_zero():
    q = torch.ones((2, 1, 32))
    k = torch.ones((2, 1, 8, 32))
    out = decode_attention.decode_attention(
        q, k, k, lengths=torch.tensor([0, 8], dtype=torch.int32))
    assert torch.all(out[0] == 0) and torch.allclose(out[1], torch.ones(32))


class _NoTensorOps(torch.overrides.TorchFunctionMode):
    """Raises on any torch function or tensor method called inside it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        raise AssertionError(f"the plan called {func}")


# the cross and self caches of the slot engine, long caches (online
# softmax a warp), a single slot, many slots, and caches too short to split
_ATTN_SHAPES = [(8, 8, 512), (8, 8, 66), (8, 8, 1000), (1, 8, 4096),
                (64, 8, 512), (2, 2, 127), (2, 2, 128), (3, 4, 1), (1, 1, 9)]


@pytest.mark.parametrize("b,h,L", _ATTN_SHAPES)
def test_decode_plan_covers_positions_once(b, h, L):
    """The warps' shares run in the kernel's merge order (cluster rank,
    then warp), cover [0, L) once without a gap, and fit the kernel: a
    cluster of 1-8 CTAs (a power of two) of 1-8 warps; a split CTA keeps
    64 positions or more."""
    splits, warps, unit = decode_attention.decode_plan(b, h, L)
    assert splits in (1, 2, 4, 8) and 1 <= warps <= 8
    assert unit == -(-L // (splits * warps))
    assert splits == 1 or L >= 64 * splits
    pieces = decode_attention.decode_pieces(b, h, L)
    assert len(pieces) == splits * warps
    assert pieces[0][0] == 0 and pieces[-1][1] == L
    for (_, end), (begin, _) in zip(pieces, pieces[1:]):
        assert end == begin
    covered = [t for a, e in pieces for t in range(a, e)]
    assert covered == list(range(L))


def test_decode_plan_fills_the_card():
    """The cross cache (8, 8, 512) runs on at least ~128 CTAs of the H100's
    132 SMs; the 66-position self cache takes no split; a plan depends on
    nothing but the shape and reads no tensor (the lengths live on the
    card, and reading them would synchronize the step)."""
    splits, warps, _ = decode_attention.decode_plan(8, 8, 512)
    assert 8 * 8 * splits >= 128
    assert decode_attention.decode_plan(8, 8, 66)[0] == 1
    assert decode_attention.decode_plan(64, 8, 512)[0] == 1
    with _NoTensorOps():
        plans = [decode_attention.decode_plan.__wrapped__(*s)
                 for s in _ATTN_SHAPES]
        pieces = decode_attention.decode_pieces(8, 8, 512)
    assert plans == [decode_attention.decode_plan(*s) for s in _ATTN_SHAPES]
    assert len(pieces) == splits * warps
    assert set(inspect.signature(
        decode_attention.decode_plan.__wrapped__).parameters) == {"b", "h",
                                                                  "L"}


# ---------------------------------------------------------------------------
# runtime rules
# ---------------------------------------------------------------------------

def test_entry_points_refuse_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device()
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_wrappers_raise_on_a_device_they_do_not_take():
    x = torch.zeros((4, 128), device="meta")
    with pytest.raises(ValueError):
        rmsnorm.rms_norm(x, torch.zeros((128,), device="meta"))
    with pytest.raises(ValueError):
        quant.quant_matmul(x, quant.QuantizedTensor(
            torch.zeros((128, 64), dtype=torch.int8),
            torch.ones((1, 64))))
