"""The port's fused lm_head+CE (`flasht5_tpu_torch/ops/fused_linear_ce.py`)
against the JAX package's `fused_linear_cross_entropy`, and the port's
`t5.forward` with `use_fused_lm_head_ce` against the JAX package's.

Inputs come from a numpy seed and go to both. The JAX op runs its Pallas
kernels in interpret mode (tests/conftest.py), as tests/test_fused_linear_ce.py
runs it; the port runs on the CPU, i.e. the plain versions of its kernels.

Tolerances, with their reasons:
- f32: both sides form the same f32 products and differ only in the order
  of their sums: loss and z to 1e-5, as the JAX package's own test holds
  its op; dx and dw to rtol 1e-5, atol 1e-6.
- bf16 activations: dlogits are rounded to bf16 on both sides, and a value
  one f32 ulp apart may round to the neighbouring bf16 value (2^-8
  relative), so dx (bf16) is held to one bf16 ulp of each entry (rtol
  2^-7) and dw (f32 sums of 64 such terms) to 1e-3 of its largest entry.
- the model (two encoder and two decoder layers): f32 loss to 1e-5
  relative, each gradient leaf to 1e-4 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.ops.fused_linear_ce import (
    fused_linear_cross_entropy as jax_flce)
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.ops import fused_linear_ce as flce

# the kwarg cases of tests/test_fused_linear_ce.py
CASES = [
    dict(),
    dict(lse_square_scale=1e-4),
    dict(label_smoothing=0.1),
    dict(logit_scale=0.5),
    dict(lse_square_scale=1e-4, label_smoothing=0.1, logit_scale=2.0),
]
CASE_IDS = ["plain", "zloss", "smoothing", "scale", "all"]


def _make(rows, d, v, seed=0, ignore_frac=0.25):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((d, v)) * d ** -0.5).astype(np.float32)
    labels = rng.integers(0, v, rows).astype(np.int32)
    labels[rng.random(rows) < ignore_frac] = -100
    dloss = rng.random(rows).astype(np.float32)
    dz = rng.random(rows).astype(np.float32)
    return x, w, labels, dloss, dz


def _jax(x, w, labels, dloss, dz, kw, dtype=jnp.float32):
    def f(x, w):
        return jax_flce(x, w, jnp.asarray(labels), **kw)
    (loss, z), vjp = jax.vjp(f, jnp.asarray(x, dtype), jnp.asarray(w))
    dx, dw = vjp((jnp.asarray(dloss), jnp.asarray(dz)))
    return [np.asarray(a, np.float32) for a in (loss, z, dx, dw)]


def _port(x, w, labels, dloss, dz, kw, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss, z = flce.fused_linear_cross_entropy(xt, wt, torch.from_numpy(labels),
                                              **kw)
    torch.autograd.backward((loss, z), (torch.from_numpy(dloss),
                                        torch.from_numpy(dz)))
    assert xt.grad.dtype == dtype and wt.grad.dtype == torch.float32
    return [a.detach().float().numpy()
            for a in (loss, z, xt.grad, wt.grad)]


@pytest.mark.parametrize("kw", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("shape", [(64, 128, 384), (48, 128, 512),
                                   (37, 128, 300), (16, 640, 300),
                                   (16, 96, 300)],
                         ids=["64x128x384", "48x128x512", "ragged",
                              "d640", "d96"])
def test_op_matches_jax(kw, shape):
    args = _make(*shape)
    loss, z, dx, dw = _port(*args, kw)
    jloss, jz, jdx, jdw = _jax(*args, kw)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(z, jz, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx, jdx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dw, jdw, rtol=1e-5, atol=1e-6)


def test_bf16_activations_match_jax():
    args = _make(64, 128, 384)
    kw = dict(lse_square_scale=1e-4)
    loss, z, dx, dw = _port(*args, kw, dtype=torch.bfloat16)
    jloss, jz, jdx, jdw = _jax(*args, kw, dtype=jnp.bfloat16)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(z, jz, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx, jdx, rtol=2.0 ** -7, atol=0)
    np.testing.assert_allclose(dw, jdw, rtol=0,
                               atol=1e-3 * np.abs(jdw).max())


def test_all_rows_ignored():
    x, w, _, dloss, dz = _make(16, 128, 256)
    labels = np.full(16, -100, np.int32)
    loss, z, dx, dw = _port(x, w, labels, dloss, dz,
                            dict(lse_square_scale=1e-4))
    jloss, jz, jdx, jdw = _jax(x, w, labels, dloss, dz,
                               dict(lse_square_scale=1e-4))
    for got, want in ((loss, jloss), (z, jz), (dx, jdx), (dw, jdw)):
        assert not np.any(got) and not np.any(want)


def test_plain_versions_are_the_kernels_functions():
    """The forward's plain lse against logsumexp of the materialized
    logits, and the wrappers on CPU tensors taking the plain versions."""
    x, w, labels, dloss, dz = _make(40, 64, 200)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    lse, total = flce.fused_linear_ce_fwd(xt, wt, logit_scale=2.0,
                                          label_smoothing=0.1)
    logits = (xt @ wt) * 2.0
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=1e-6,
                               atol=1e-5)
    torch.testing.assert_close(total, logits.sum(-1), rtol=1e-5, atol=1e-4)
    assert flce.fused_linear_ce_fwd(xt, wt)[1] is None


# ---------------------------------------------------------------------------
# the model with use_fused_lm_head_ce
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=384, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
            z_loss=1e-4, pad_token_id=0, dtype="float32",
            use_fused_lm_head_ce=True)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_model_loss_and_gradients_match_jax(smoothing):
    jcfg = JaxConfig(**TINY, label_smoothing=smoothing)
    cfg = FlashT5Config(**TINY, label_smoothing=smoothing)
    jparams = jt5.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    ids = rng.integers(2, 384, (2, 24)).astype(np.int32)
    labels = rng.integers(2, 384, (2, 12)).astype(np.int32)
    labels[:, -3:] = -100

    def loss_fn(p):
        return jt5.forward(jcfg, p, input_ids=jnp.asarray(ids),
                           labels=jnp.asarray(labels))["loss"]
    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)

    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    leaves = t5.tree_leaves_with_path(params)
    for _, p in leaves:
        p.requires_grad_(True)
    out = t5.forward(cfg, params, input_ids=torch.from_numpy(ids),
                     labels=torch.from_numpy(labels))
    assert "logits" not in out          # not computed: the loss needs none
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               rtol=1e-5)
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [p for p, _ in leaves] == [jax.tree_util.keystr(p)
                                      for p, _ in want]
    for (path, p), (_, g) in zip(leaves, want):
        g = np.asarray(g, np.float32)
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=path)


def test_model_logits_on_demand():
    """Reading out["logits"] on the fused path computes the unfused path's
    logits; the unfused path returns them at once."""
    cfg = FlashT5Config(**TINY)
    params = t5.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(2, 384, (2, 16)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(2, 384, (2, 8)).astype(np.int32))
    with torch.no_grad():
        fused = t5.forward(cfg, params, input_ids=ids, labels=labels)
        plain = t5.forward(cfg.replace(use_fused_lm_head_ce=False), params,
                           input_ids=ids, labels=labels)
    assert "logits" not in fused and "logits" in plain
    torch.testing.assert_close(fused["logits"], plain["logits"])
    assert "logits" in fused
    # the unfused path here means over the non-ignored rows, the fused one
    # over all rows; no label is ignored, so the two agree
    torch.testing.assert_close(fused["loss"], plain["loss"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("rows,d,v", [(2048, 512, 32768), (2048, 2048, 32128),
                                      (256, 768, 32128), (1, 512, 50257),
                                      (100_000, 4096, 256_000),
                                      (7681, 512, 50257), (37, 97, 300)])
@pytest.mark.parametrize("cast", [True, False])
def test_bwd_plan_keeps_the_workspace_bounded(rows, d, v, cast):
    """The bf16 backward's chunks, slabs and dx splits keep its scratch
    (dx's f32 sums and split partials, a slab's dlogits and rounded
    weight) within WORKSPACE_BYTES, under 64 MB, in as few row chunks as
    that budget allows."""
    chunk, slab, splits = flce.bwd_plan(rows, d, v, cast)
    live = min(chunk, rows)
    scratch = (live * d * 4 * (splits + (v > slab))
               + slab * (2 * live + (2 * d if cast else 0)))
    assert scratch <= flce.WORKSPACE_BYTES <= 64 * 10 ** 6
    assert chunk % 128 == 0 and slab % 128 == 0 and 1 <= splits <= 16
    assert -(-rows // chunk) == -(-rows // flce.max_chunk_rows(d))


def _fwd_splits(rows, d, v, sms, convert=False):
    """The vocabulary columns [begin, end) of each split of the bf16
    forward's plan, in the partials' order (slab by slab)."""
    slab, per, splits = flce.fwd_plan(rows, d, v, sms, convert)
    cols = []
    for v0 in range(0, v, slab):
        n = min(slab, v - v0)
        tiles = -(-n // 128)
        for t0 in range(0, tiles, per):
            cols.append((v0 + 128 * t0, v0 + min(n, 128 * (t0 + per))))
    assert len(cols) == splits
    return slab, per, cols


@pytest.mark.parametrize("rows,d,v", [(2048, 512, 32768), (256, 512, 32768),
                                      (256, 768, 32128), (2048, 2048, 32128),
                                      (1, 64, 300), (300, 968, 50257),
                                      (20_000, 512, 32768)])
@pytest.mark.parametrize("convert", [False, True])
def test_fwd_plan_covers_the_vocabulary(rows, d, v, convert):
    """The bf16 forward's slabs and splits cover the vocabulary once, in
    order, with no empty split; a slab's bf16 w^T fits WORKSPACE_BYTES (the
    form that converts w in shared memory has one slab and no scratch);
    the CTAs (row blocks of 128 by splits) fill the H100's 132 SMs about
    once where the vocabulary has the tiles."""
    slab, per, cols = _fwd_splits(rows, d, v, 132, convert)
    assert slab % 128 == 0
    if convert:
        assert slab >= v
    else:
        assert min(slab, v) * d * 2 <= flce.WORKSPACE_BYTES
    assert cols[0][0] == 0 and cols[-1][1] == v
    for (_, end), (begin, _) in zip(cols, cols[1:]):
        assert end == begin
    assert all(end > begin for begin, end in cols)
    row_blocks = -(-rows // 128)
    tiles = -(-min(slab, v) // 128)
    per_slab = -(-tiles // per)
    assert row_blocks * per_slab <= 132 or per_slab == 1
    assert row_blocks * per_slab >= min(66, row_blocks * tiles)


@pytest.mark.parametrize("rows,d,v,sms,convert", [(40, 64, 1000, 8, False),
                                                  (40, 64, 1000, 8, True),
                                                  (6, 2048, 32128, 132,
                                                   False)])
@pytest.mark.parametrize("logit_scale", [1.0, 2.0])
def test_fwd_plan_partials_merge_to_the_lse(rows, d, v, sms, convert,
                                            logit_scale):
    """Each split's (max, sum of exp, sum of logits), merged as
    flce_merge_kernel merges them, gives the plain forward's lse and row
    sum: the plan's splits, d 2048's three slabs among them, lose no
    column."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((d, v)).astype(np.float32)
                         * d ** -0.5)
    logits = flce._logits(x, w, logit_scale)
    _, _, cols = _fwd_splits(rows, d, v, sms, convert)
    part_m = torch.stack([logits[:, a:b].amax(-1) for a, b in cols])
    part_se = torch.stack([torch.exp(logits[:, a:b] - part_m[i, :, None])
                           .sum(-1) for i, (a, b) in enumerate(cols)])
    part_sl = torch.stack([logits[:, a:b].sum(-1) for a, b in cols])
    m = part_m.amax(0)
    lse = torch.log((part_se * torch.exp(part_m - m)).sum(0)) + m
    lse0, total0 = flce.fused_linear_ce_fwd_plain(
        x, w, logit_scale=logit_scale, label_smoothing=0.1)
    torch.testing.assert_close(lse, lse0, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(part_sl.sum(0), total0, rtol=1e-5, atol=1e-3)


def test_fwd_form_follows_rows_and_weight():
    """Few rows and an f32 lm_head whose rows TMA can describe take the
    form that rounds w in shared memory; more rows, a bf16 lm_head or a
    vocabulary that is not a multiple of 4 take the scratch."""
    x = torch.zeros((flce.CONVERT_ROWS, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 1000))
    assert flce._fwd_tma(x) and flce._fwd_convert(x, w)
    assert not flce._fwd_convert(torch.zeros((flce.CONVERT_ROWS + 1, 64),
                                             dtype=torch.bfloat16), w)
    assert not flce._fwd_convert(x, w.to(torch.bfloat16))
    assert not flce._fwd_convert(x, torch.zeros((64, 1001)))
    assert not flce._fwd_tma(torch.zeros((4, 97), dtype=torch.bfloat16))
    assert not flce._fwd_tma(torch.zeros((4, 64)))
