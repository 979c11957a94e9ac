"""Parity of the port's training kernels' plain versions with the JAX package.

The backward of `rms_norm`, of the RPE attention (with the bucket table's
gradient) and of the no-bias attention, and the fused cross-entropy forward
and backward. Inputs and cotangents are made from a numpy seed and fed to
both packages; the JAX side runs its Pallas kernels in interpret mode
(tests/conftest.py) and is differentiated with `jax.vjp`, the port side runs
on the CPU (the plain version of each kernel) through autograd. The Hopper
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.

Tolerances: 1e-4 where both sides compute in f32 and differ only in the
order of their sums (the attention gradients sum over up to 72 keys or rows,
dW over up to 72 x 72 scores); in bf16, 2e-2 relative and absolute, a little
over two bf16 ulps (2^-8 relative each), since a value one f32 ulp apart on
the two sides can round to neighbouring bf16 values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flasht5_tpu.ops import cross_entropy as jce
from flasht5_tpu.ops import flash_attention as jfa
from flasht5_tpu.ops import flash_attention_rpe as jrpe
from flasht5_tpu.ops import rmsnorm as jrms
from flasht5_tpu_torch.ops import (cross_entropy, flash_attention,
                                   flash_attention_rpe, rmsnorm)

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)
    return t.requires_grad_(grad)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want), **tol)


# ---------------------------------------------------------------------------
# rms_norm backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 128), (3, 21, 128)])
def test_rms_norm_backward_matches_jax(dtype, shape):
    """dx and dW of the port's `rms_norm` (autograd through
    `rms_norm_bwd_plain`) against `jax.vjp` of the JAX kernel; the row
    counts (37, 63) are not multiples of the JAX kernel's row block."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    y_j, vjp = jax.vjp(lambda a, b: jrms.rms_norm(a, b, 1e-6),
                       jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    dx_j, dw_j = vjp(jnp.asarray(dy, jdt))
    xt, wt = _t(x, tdt, True), _t(w, tdt, True)
    y = rmsnorm.rms_norm(xt, wt, 1e-6)
    y.backward(_t(dy, tdt))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert xt.grad.dtype == tdt and wt.grad.dtype == tdt
    _close(y, y_j, tol)
    _close(xt.grad, dx_j, tol)
    _close(wt.grad, dw_j, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_folded_cast_matches_jax(dtype):
    """The model passes its fp32 weight as stored and the kernel rounds it
    to x.dtype: y, dx and the fp32 parameter's gradient against `jax.vjp`
    of the JAX model's cast followed by its kernel. 37 rows: not a multiple
    of the JAX kernel's row block."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((37, 128)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    dy = rng.standard_normal((37, 128)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    y_j, vjp = jax.vjp(lambda a, b: jrms.rms_norm(a, b.astype(a.dtype), 1e-6),
                       jnp.asarray(x, jdt), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy, jdt))
    xt, wt = _t(x, tdt, True), _t(w, torch.float32, True)
    y = rmsnorm.rms_norm(xt, wt, 1e-6, cast_w=True)
    y.backward(_t(dy, tdt))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert y.dtype == tdt and wt.grad.dtype == torch.float32
    assert dw_j.dtype == jnp.float32
    _close(y, y_j, tol)
    _close(xt.grad, dx_j, tol)
    _close(wt.grad, dw_j, tol)


@pytest.mark.parametrize("x_dtype,w_dtype", [("bfloat16", "float32"),
                                             ("float32", "bfloat16")])
def test_rms_norm_mixed_dtypes_match_jax_op(x_dtype, w_dtype):
    """The op `rms_norm(x, w)` with w in another dtype than x, against the
    JAX op of the same name on the same arrays: w multiplies as stored
    (widened to f32, not rounded to x.dtype) and dW comes back in w's
    dtype, summed in f32. y and dx are rounded to x.dtype once on both
    sides from the same f32 arithmetic: within one ulp of x.dtype; dW to
    1e-5 of its largest entry before its own rounding to w.dtype."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((37, 512)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(512)).astype(np.float32)
    dy = rng.standard_normal((37, 512)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.dtype(x_dtype)), jnp.asarray(w, jnp.dtype(
        w_dtype))
    y_j, vjp = jax.vjp(lambda a, b: jrms.rms_norm(a, b, 1e-6), jx, jw)
    dx_j, dw_j = vjp(jnp.asarray(dy, jx.dtype))
    xdt, wdt = getattr(torch, x_dtype), getattr(torch, w_dtype)
    xt, wt = _t(x, xdt, True), _t(w, wdt, True)
    y = rmsnorm.rms_norm(xt, wt, 1e-6)
    y.backward(_t(dy, xdt))
    assert y.dtype == xdt and xt.grad.dtype == xdt and wt.grad.dtype == wdt
    assert dw_j.dtype == jw.dtype
    ulp = dict(rtol=2.0 ** -7 if x_dtype == "bfloat16" else 1e-5, atol=1e-6)
    _close(y, y_j, ulp)
    _close(xt.grad, dx_j, ulp)
    wtol = 2.0 ** -7 if w_dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(wt.grad.float().numpy(), _np(dw_j),
                               rtol=wtol, atol=1e-5 * np.abs(_np(dw_j)).max())
    # the departure the op used to have: w rounded to x.dtype first moves y
    if x_dtype == "bfloat16":
        y_cast = rmsnorm.rms_norm(xt.detach(), wt.detach(), 1e-6, cast_w=True)
        assert not torch.equal(y_cast, y.detach())


def test_layer_norm_keeps_the_folded_cast_bits():
    """The model's `_layer_norm` passes `cast_w`: on bf16 activations and
    the fp32 parameter it gives the bits of the cast made first
    (`rms_norm(x, w.to(bf16))`), its dx, and the cast's gradient of w."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.models import t5
    cfg = FlashT5Config(d_model=128, dtype="bfloat16",
                        use_fused_layernorm=True)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((37, 128)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    dy = _t(rng.standard_normal((37, 128)), torch.bfloat16)
    xa, wa = _t(x, torch.bfloat16, True), _t(w, torch.float32, True)
    xb, wb = _t(x, torch.bfloat16, True), _t(w, torch.float32, True)
    ya = t5._layer_norm(cfg, wa, xa)
    yb = rmsnorm.rms_norm(xb, wb.to(torch.bfloat16), cfg.layer_norm_epsilon)
    ya.backward(dy)
    yb.backward(dy)
    assert wa.grad.dtype == torch.float32
    assert torch.equal(ya, yb)
    assert torch.equal(xa.grad, xb.grad)
    assert torch.equal(wa.grad, wb.grad)


# ---------------------------------------------------------------------------
# attention backward
# ---------------------------------------------------------------------------

def _attn_inputs(m_len, n_len, d=32, b=2, h=4, seed=11):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, m_len, d)).astype(np.float32)
    k = rng.standard_normal((b, h, n_len, d)).astype(np.float32)
    v = rng.standard_normal((b, h, n_len, d)).astype(np.float32)
    w = rng.standard_normal((32, h)).astype(np.float32)
    do = rng.standard_normal((b, h, m_len, d)).astype(np.float32)
    return q, k, v, w, do


def _jax_vjp(fn, args, cotangent):
    """(fn(*args), its vjp at `cotangent`), jitted: interpret-mode Pallas
    runs several times faster compiled than op by op."""
    def run(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)
    return jax.jit(run)(tuple(jnp.asarray(a) for a in args),
                        jnp.asarray(cotangent))


def _rpe_grads(causal, m_len, n_len, **jax_kw):
    q, k, v, w, do = _attn_inputs(m_len, n_len)
    kw = dict(causal=causal, sm_scale=0.5, bidirectional=not causal,
              num_buckets=32, max_distance=128)
    o_j, want = _jax_vjp(
        lambda *a: jrpe.flash_attention_rpe(*a, **kw, **jax_kw),
        (q, k, v, w), do)
    ts = [_t(a, grad=True) for a in (q, k, v, w)]
    o = flash_attention_rpe.flash_attention_rpe(*ts, **kw)
    o.backward(_t(do))
    _close(o, o_j, F32_TOL)
    for t, g in zip(ts, want):
        _close(t.grad, g, F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("m_len,n_len", [(48, 48), (40, 72), (72, 40)])
def test_rpe_attention_backward_matches_jax(causal, m_len, n_len):
    """dq, dk, dv and the table's dW against the JAX backward at its
    defaults (one key tile: the fused single-tile kernels)."""
    _rpe_grads(causal, m_len, n_len)


@pytest.mark.parametrize("causal", [False, True])
def test_rpe_attention_backward_matches_jax_two_pass(monkeypatch, causal):
    """block_n=16 and FLASHT5_RPE_FUSED_BWD=0 on the JAX side: its
    two-pass `_bwd_dkv_kernel` / `_bwd_dq_kernel` pair over several key
    tiles. (Its fused multi-tile kernel, the =1 form, accumulates dq through
    an aliased buffer that interpret mode does not carry across grid steps:
    on the CPU its dq is wrong against the JAX package's own attention
    oracle, so it is not a reference here.)"""
    monkeypatch.setenv("FLASHT5_RPE_FUSED_BWD", "0")
    _rpe_grads(causal, 56, 56, block_n=16)


@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_rpe"])
@pytest.mark.parametrize("causal,m_len,n_len", [(False, 40, 72),
                                                (False, 72, 40),
                                                (True, 48, 48),
                                                (True, 40, 72)])
def test_no_bias_attention_matches_jax(entry, causal, m_len, n_len):
    """The decoder's cross-attention path: the port's
    `flash_attention(q, k, v, None)` and `flash_attention_rpe(..., None)`,
    forward and backward, against the JAX `flash_attention(q, k, v, None)`."""
    q, k, v, _, do = _attn_inputs(m_len, n_len, seed=12)
    o_j, want = _jax_vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, None, causal=causal,
                                            sm_scale=0.7),
        (q, k, v), do)
    ts = [_t(a, grad=True) for a in (q, k, v)]
    if entry == "flash_attention":
        o = flash_attention.flash_attention(*ts, None, causal=causal,
                                            sm_scale=0.7)
    else:
        o = flash_attention_rpe.flash_attention_rpe(*ts, None, causal=causal,
                                                    sm_scale=0.7)
    o.backward(_t(do))
    _close(o, o_j, F32_TOL)
    for t, g in zip(ts, want):
        _close(t.grad, g, F32_TOL)


def test_attention_bwd_plain_matches_autograd_of_the_oracle():
    """A second anchor, independent of both kernels: the plain backward's
    dq, dk, dv and dW (its scatter_add over buckets) equal autograd through
    the plain attention oracle on the materialized T5 bias."""
    from flasht5_tpu_torch import positional
    from flasht5_tpu_torch.ops.attn_ref import attn_ref
    q, k, v, w, do = (_t(a, grad=True) for a in _attn_inputs(24, 40, seed=13))
    bias = positional.t5_relative_bias({"relative_attention_bias": w}, 24,
                                       40, bidirectional=False)
    attn_ref(q, k, v, bias, sm_scale=0.5, causal=True).backward(do)
    o, lse = flash_attention_rpe.flash_attention_rpe_plain(
        q, k, v, w, causal=True, sm_scale=0.5, bidirectional=False)
    delta = (do.float() * o.float()).sum(-1)
    got = flash_attention_rpe.flash_attention_bwd_plain(
        q, k, v, w, lse, delta, do, causal=True, sm_scale=0.5,
        bidirectional=False)
    for g, t in zip(got, (q, k, v, w)):
        np.testing.assert_allclose(g.detach().numpy(), t.grad.numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_attention_dw_abs_plain_sums_abs_ds_by_bucket():
    """The scale of dW's error that the card checks hold dW to: the sum of
    |dS| over each bucket's scores, with dS taken as autograd's gradient of
    a per-batch bias through the plain oracle."""
    from flasht5_tpu_torch import positional
    from flasht5_tpu_torch.ops.attn_ref import attn_ref
    q, k, v, w, do = (_t(a) for a in _attn_inputs(24, 40, seed=15))
    kw = dict(causal=False, sm_scale=0.5, bidirectional=True)
    bias = positional.t5_relative_bias({"relative_attention_bias": w}, 24, 40,
                                       bidirectional=True)
    bias = bias.expand(q.shape[0], -1, -1, -1).clone().requires_grad_(True)
    attn_ref(q, k, v, bias, sm_scale=0.5, causal=False).backward(do)
    o, lse = flash_attention_rpe.flash_attention_rpe_plain(q, k, v, w, **kw)
    delta = (do.float() * o.float()).sum(-1)
    got = flash_attention_rpe.flash_attention_dw_abs_plain(
        q, k, v, w, lse, delta, do, **kw)
    rel = torch.arange(40)[None, :] - torch.arange(24)[:, None]
    bucket = positional.relative_position_bucket(rel, bidirectional=True,
                                                 num_buckets=32,
                                                 max_distance=128)
    abs_ds = bias.grad.abs().sum(0)                      # (H, M, N)
    want = torch.stack([abs_ds[:, bucket == b].sum(-1) for b in range(32)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-6)
    assert torch.all(got >= flash_attention_rpe.flash_attention_bwd_plain(
        q, k, v, w, lse, delta, do, **kw)[3].abs() - 1e-6)


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------

def _ce_inputs(rows, v, dtype, seed=14):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((rows, v))).astype(np.float32)
    labels = rng.integers(0, v, size=(rows,)).astype(np.int32)
    labels[::5] = -100
    dloss = rng.standard_normal(rows).astype(np.float32)
    dz = rng.standard_normal(rows).astype(np.float32)
    if dtype == "bfloat16":   # both sides see the same bf16 values
        logits = np.asarray(jnp.asarray(logits, jnp.bfloat16), np.float32)
    return logits, labels, dloss, dz


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("tiled,rows", [("1", 37), ("0", 29)])
def test_cross_entropy_matches_jax(monkeypatch, dtype, smoothing, tiled,
                                   rows):
    """Per-row (loss, z_loss) and dlogits against the JAX op, through its
    vocab-tiled kernels (FLASHT5_CE_TILED=1, the default) and its whole-row
    kernels (=0): z-loss 1e-4, rows with ignore_index, V = 1000, which is
    not a multiple of either side's vocabulary tile."""
    monkeypatch.setenv("FLASHT5_CE_TILED", tiled)
    logits, labels, dloss, dz = _ce_inputs(rows, 1000, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    (loss_j, z_j), vjp = jax.vjp(
        lambda x: jce.cross_entropy_loss(x, jnp.asarray(labels), 1e-4,
                                         smoothing),
        jnp.asarray(logits, jdt))
    (dlogits_j,) = vjp((jnp.asarray(dloss), jnp.asarray(dz)))
    x = _t(logits, tdt, True)
    loss, z = cross_entropy.cross_entropy_loss(
        x, torch.from_numpy(labels), 1e-4, smoothing)
    torch.autograd.backward([loss, z], [_t(dloss), _t(dz)])
    assert loss.dtype == torch.float32 and x.grad.dtype == tdt
    assert float(loss[0].detach()) == 0.0 == float(z[0].detach())  # ignored
    _close(loss, loss_j, F32_TOL)
    _close(z, z_j, F32_TOL)
    _close(x.grad, dlogits_j, F32_TOL if dtype == "float32" else BF16_TOL)


def test_cross_entropy_ref_matches_jax_ref():
    logits, labels, _, _ = _ce_inputs(23, 300, "float32", seed=15)
    for smoothing in (0.0, 0.1):
        want = jce.cross_entropy_loss_ref(
            jnp.asarray(logits), jnp.asarray(labels), lse_square_scale=1e-4,
            label_smoothing=smoothing, logit_scale=0.5)
        got = cross_entropy.cross_entropy_loss_ref(
            _t(logits), torch.from_numpy(labels), lse_square_scale=1e-4,
            label_smoothing=smoothing, logit_scale=0.5)
        for g, w in zip(got, want):
            _close(g, w, dict(rtol=1e-5, atol=1e-5))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_training_wrappers_refuse_a_device_they_do_not_take():
    meta = dict(device="meta")
    x = torch.zeros((4, 128), **meta)
    w = torch.zeros((128,), **meta)
    r = torch.zeros((4,), **meta)
    with pytest.raises(ValueError):
        rmsnorm.rms_norm_bwd(x, w, r, x)
    q = torch.zeros((1, 2, 8, 32), **meta)
    with pytest.raises(ValueError):
        flash_attention_rpe.flash_attention_bwd(
            q, q, q, None, torch.zeros((1, 2, 8), **meta),
            torch.zeros((1, 2, 8), **meta), q)
    with pytest.raises(ValueError):
        cross_entropy.cross_entropy_fwd(x, r.long())
    with pytest.raises(ValueError):
        cross_entropy.cross_entropy_bwd(x, r.long(), r, r, r)


def test_training_wrappers_refuse_a_dtype_they_do_not_take():
    x = torch.zeros((4, 128), dtype=torch.float64, device="meta")
    r = torch.zeros((4,), device="meta")
    with pytest.raises(TypeError):
        rmsnorm.rms_norm_bwd(x, torch.zeros((128,), device="meta"), r, x)
    q = torch.zeros((1, 2, 8, 32), dtype=torch.float16, device="meta")
    lse = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(TypeError):
        flash_attention_rpe.flash_attention_bwd(q, q, q, None, lse, lse, q)
    with pytest.raises(TypeError):
        cross_entropy.cross_entropy_fwd(x.to(torch.int32), r.long())


def test_unported_options_raise():
    """Data, tensor and pipeline parallelism run across ranks
    (tests/test_torch_parallel*.py): without a process group, or outside a
    mesh, they raise."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.train import Trainer, TrainerConfig
    cfg = FlashT5Config(vocab_size=64, d_model=32, d_kv=8, num_heads=4,
                        d_ff=64, num_layers=1, dtype="float32")
    for name in ("data_parallel", "tensor_parallel", "pipeline_parallel"):
        with pytest.raises(RuntimeError, match="process group"):
            Trainer(cfg, TrainerConfig(**{name: 2}), device="cpu")
    with pytest.raises(RuntimeError, match="mesh"):
        t5.check_supported(cfg.replace(tp_axis="tp"))


# ---------------------------------------------------------------------------
# the vocab-split form
# ---------------------------------------------------------------------------

_SPLIT_V, _SPLIT_SHARDS = 256, 4


@pytest.mark.parametrize("smoothing,z_scale", [(0.0, 0.0), (0.1, 1e-4)])
def test_cross_entropy_split_matches_jax(smoothing, z_scale):
    """Each of four vocab shards of V = 256 through `split=True`,
    `class_start_idx` and `total_classes`: the per-row partial loss, z and
    dlogits against the JAX op's tiled kernels (interpret mode), with and
    without smoothing and z-loss (which `split` leaves out of the loss but
    not of the backward, as in JAX). Then the four shards combined (the
    global lse by logsumexp of the shard lses, the partials summed, the
    z-loss of the global lse added) against the unsplit loss. f32, 1e-4:
    sums of up to 256 terms in another order."""
    rows, v = 29, _SPLIT_V
    w = v // _SPLIT_SHARDS
    logits, labels, dloss, dz = _ce_inputs(rows, v, "float32", seed=16)
    partials, lses = [], []
    for s in range(_SPLIT_SHARDS):
        shard = np.ascontiguousarray(logits[:, s * w:(s + 1) * w])
        kw = dict(total_classes=v, class_start_idx=s * w, split=True)
        (loss_j, z_j), vjp = jax.vjp(
            lambda x: jce.cross_entropy_loss(
                x, jnp.asarray(labels), z_scale, smoothing, 1.0, -100,
                v, s * w, True), jnp.asarray(shard))
        (dlogits_j,) = vjp((jnp.asarray(dloss), jnp.asarray(dz)))
        x = _t(shard, grad=True)
        loss, z = cross_entropy.cross_entropy_loss(
            x, torch.from_numpy(labels), z_scale, smoothing, **kw)
        torch.autograd.backward([loss, z], [_t(dloss), _t(dz)])
        _close(loss, loss_j, F32_TOL)
        _close(z, z_j, F32_TOL)
        _close(x.grad, dlogits_j, F32_TOL)
        assert float(z.detach().abs().max()) == 0.0
        partials.append(loss.detach())
        lses.append(torch.logsumexp(_t(shard), dim=-1))
    lse = torch.logsumexp(torch.stack(lses), dim=0)
    valid = torch.from_numpy(labels) != -100
    combined = torch.where(valid, sum(partials) + lse
                           + z_scale * lse * lse, 0.0)
    whole, _ = cross_entropy.cross_entropy_loss(
        _t(logits), torch.from_numpy(labels), z_scale, smoothing)
    np.testing.assert_allclose(combined.numpy(), whole.numpy(), **F32_TOL)


# the forward kernel's epilogue and the combine over shards: plain versions
_EPILOGUE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
@pytest.mark.parametrize("smoothing,z_scale", [(0.0, 0.0), (0.1, 1e-4)])
def test_cross_entropy_epilogue_plain_matches_jax(split, smoothing, z_scale):
    """`cross_entropy_fwd_plain` (the loss the forward kernel writes in its
    epilogue, from its lse, row sum and label logit) against the JAX op's
    forward: unsplit, each row's (loss, z-loss); split, each of four
    shards' partial loss (labels in other shards, ignored rows), then
    `cross_entropy_combine_plain` over the stacked (lse, partial) pairs
    against JAX's shards combined and against the unsplit loss. f32 at
    1e-6: sums of up to 256 terms in another order."""
    rows, v = 29, _SPLIT_V
    logits, labels, _, _ = _ce_inputs(rows, v, "float32", seed=17)
    tl = torch.from_numpy(labels)

    def jax_loss(x, **kw):
        return jce.cross_entropy_loss(jnp.asarray(x), jnp.asarray(labels),
                                      z_scale, smoothing, **kw)

    kw = dict(lse_square_scale=z_scale, label_smoothing=smoothing)
    if not split:
        loss, lse, z = cross_entropy.cross_entropy_fwd_plain(_t(logits), tl,
                                                             **kw)
        loss_j, z_j = jax_loss(logits)
        _close(loss, loss_j, _EPILOGUE_TOL)
        _close(z, z_j, _EPILOGUE_TOL)
        _close(lse, jax.nn.logsumexp(jnp.asarray(logits), axis=-1),
               _EPILOGUE_TOL)
        return
    w = v // _SPLIT_SHARDS
    pairs, partials_j, lses_j = [], [], []
    for s in range(_SPLIT_SHARDS):
        shard = np.ascontiguousarray(logits[:, s * w:(s + 1) * w])
        out = cross_entropy.cross_entropy_fwd_plain(
            _t(shard), tl, total_classes=v, class_start_idx=s * w,
            split=True, **kw)
        loss_j, _ = jax_loss(shard, total_classes=v, class_start_idx=s * w,
                             split=True)
        lse_j = jax.nn.logsumexp(jnp.asarray(shard), axis=-1)
        _close(out[0], loss_j, _EPILOGUE_TOL)
        _close(out[1], lse_j, _EPILOGUE_TOL)
        assert not out[2].any()
        pairs.append(out[:2])
        partials_j.append(loss_j)
        lses_j.append(lse_j)
    loss, lse, z = cross_entropy.cross_entropy_combine_plain(
        torch.stack(pairs), tl, lse_square_scale=z_scale)
    lse_j = jax.nn.logsumexp(jnp.stack(lses_j), axis=0)
    valid = jnp.asarray(labels) != -100
    z_j = jnp.where(valid, z_scale * lse_j * lse_j, 0.0)
    _close(lse, lse_j, _EPILOGUE_TOL)
    _close(loss, jnp.where(valid, sum(partials_j) + lse_j, 0.0) + z_j,
           _EPILOGUE_TOL)
    _close(z, z_j, _EPILOGUE_TOL)
    whole_j, _ = jax_loss(logits)
    _close(loss, whole_j, F32_TOL)
