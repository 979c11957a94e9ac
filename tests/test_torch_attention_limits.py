"""The bf16 attention backward's derived limit, and head dims that the
decode kernels' wrappers zero-pad, on the CPU.

The limit (`ops/flash_attention_rpe.py::grad_limits` on `grad_abs_plain`'s
sums) holds a kernel's dq, dk and dv against the plain version entry by
entry on the card. It is derived from the rounding points: P and dS are
rounded to bf16 before their products, and two roundings of nearly equal
f32 values may land one bf16 ulp apart. Here, on small seeded inputs, it
must cover the plain version's own bf16 error against the same function in
f64 (one rounding of each term, where the limit allows two), and must not
cover the plain version on its keys rolled by one position (the planted
fault of the on-card check).

The decode kernels take any head dim up to 128 by zero-padding q and the
cache (or the pools) to 32, 64 or 128 in their wrappers; the padding is
exact because the zeros add nothing to a score and `sm_scale` is passed.
The plain versions run here, so the padding's host code is held through
them: zero-padded inputs give the unpadded result. A tiny d_kv 16 model
then serves through the slot and the paged engine the tokens the JAX slot
engine serves (one JAX engine run, in interpret mode).
"""

import jax
import numpy as np
import pytest
import torch

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.inference import engine as jengine
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.ops.quant import QuantizedTensor as JaxQT
from flasht5_tpu.quantize import quantize_params as jax_quantize_params
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy
from flasht5_tpu_torch.inference import engine, paged_engine
from flasht5_tpu_torch.ops import (decode_attention, flash_attention_rpe,
                                   paged_attention, quant)


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)


def _grads_f64(q, k, v, bias, lse, delta, do, causal, sm_scale):
    """dq, dk, dv of the backward's function in f64, no rounding."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = q @ k.transpose(-1, -2) * sm_scale + bias
    lse4 = lse.double()[..., None]
    ok = flash_attention_rpe._visible(q.shape[2], k.shape[2], causal,
                                      "cpu") & (lse4 > -5e29)
    p = torch.where(ok, torch.exp(s - torch.where(ok, lse4, 0.0)), 0.0)
    ds = p * (do @ v.transpose(-1, -2) - delta.double()[..., None])
    return (ds @ k * sm_scale, ds.transpose(-1, -2) @ q * sm_scale,
            p.transpose(-1, -2) @ do)


@pytest.mark.parametrize("table,causal,sm_scale", [
    (True, False, 1.0), (False, False, 0.25), (True, True, 0.25),
    (False, True, 1.0)])
def test_derived_limit_covers_bf16_and_not_a_rolled_key(table, causal,
                                                        sm_scale):
    rng = np.random.default_rng(13)
    q, do = _bf16(rng, 2, 3, 37, 16), _bf16(rng, 2, 3, 37, 16)
    k, v = _bf16(rng, 2, 3, 53, 16), _bf16(rng, 2, 3, 53, 16)
    w = (torch.from_numpy(rng.standard_normal((32, 3)).astype(np.float32))
         if table else None)
    kw = dict(causal=causal, bidirectional=not causal, sm_scale=sm_scale)
    o, lse = flash_attention_rpe.flash_attention_rpe_plain(q, k, v, w, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, w, lse, delta, do)
    plain = flash_attention_rpe.flash_attention_bwd_plain(*args, **kw)[:3]
    limits = flash_attention_rpe.grad_limits(
        flash_attention_rpe.flash_attention_grad_abs_plain(*args, **kw),
        plain, 53, 37)
    bias = flash_attention_rpe._bias(w, 37, 53, not causal, 32, 128)
    exact = _grads_f64(q, k, v, torch.as_tensor(bias).double(), lse, delta,
                       do, causal, sm_scale)
    rolled = flash_attention_rpe.flash_attention_bwd_plain(
        q, torch.roll(k, 1, 2), v, w, lse, delta, do, **kw)[:3]
    for name, p, f64, f, lim in zip(("dq", "dk", "dv"), plain, exact,
                                    rolled, limits):
        err = (p.double() - f64).abs()
        assert torch.all(err <= lim.double()), \
            (name, float((err / lim.double()).max()))
        assert torch.any((f.float() - p.float()).abs() > lim), name
    # the limit is tighter than the old one (2e-3 of the largest entry plus
    # one ulp) where the entries are small
    dq, lim = plain[0].float(), limits[0]
    old = 2e-3 * dq.abs().max() + 2.0 ** -7 * dq.abs()
    assert torch.any(lim < old)


@pytest.mark.parametrize("d", [16, 48, 96])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_decode_attention_zero_padded_head_is_exact(d, kv):
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.standard_normal((3, 2, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((3, 2, 20, d)).astype(
        np.float32)) for _ in range(2))
    args = [k, v]
    if kv == "int8":
        (kq, ks), (vq, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
        args = [kq, vq, ks, vs]
    lens = torch.tensor([0, 7, 20], dtype=torch.int32)
    kw = dict(lengths=lens, sm_scale=d ** -0.5)
    want = decode_attention.decode_attention_plain(q, *args, **kw)
    qp, kp, vp = decode_attention.padded_head(d, q, *args[:2])
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] > d
    got = decode_attention.decode_attention_plain(qp, kp, vp, *args[2:], **kw)
    torch.testing.assert_close(got[..., :d], want, rtol=1e-6, atol=1e-6)
    assert torch.all(got[..., d:] == 0)


@pytest.mark.parametrize("d", [16, 48, 96])
def test_paged_attention_zero_padded_pools_are_exact(d):
    rng = np.random.default_rng(d + 1)
    k, v = (torch.from_numpy(rng.standard_normal((9, 2, 4, d)).astype(
        np.float32)) for _ in range(2))
    (kq, ks), (vq, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
    q = torch.from_numpy(rng.standard_normal((2, 2, d)).astype(np.float32))
    table = torch.tensor([[3, 1, 7], [0, 8, 2]], dtype=torch.int32)
    lens = torch.tensor([9, 12], dtype=torch.int32)
    rest = (ks[..., 0], vs[..., 0], table, lens)
    want = paged_attention.paged_attention_plain(q, kq, vq, *rest,
                                                 sm_scale=d ** -0.5,
                                                 return_state=True)
    qp, kp, vp = decode_attention.padded_head(d, q, kq, vq)
    got = paged_attention.paged_attention_plain(qp, kp, vp, *rest,
                                                sm_scale=d ** -0.5,
                                                return_state=True)
    torch.testing.assert_close(got[0][..., :d], want[0], rtol=1e-6,
                               atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


TINY16 = dict(vocab_size=512, d_model=64, d_kv=16, num_heads=4, d_ff=128,
              num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
              attention_scale=1.0, dtype="float32", pad_token_id=0,
              attention_type="pallas_rpe", use_fused_layernorm=True)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda x: ((np.asarray(x.qvalues), np.asarray(x.scales))
                   if isinstance(x, JaxQT) else np.asarray(x)),
        tree, is_leaf=lambda x: isinstance(x, JaxQT))


def _requests(module):
    rng = np.random.default_rng(17)
    return [module.Request(uid=i, input_ids=rng.integers(
        2, 512, size=(n,)).astype(np.int32), max_new_tokens=8)
        for i, n in enumerate((12, 30, 7, 25))]


def test_d_kv16_model_serves_the_jax_tokens_through_both_engines():
    """d_kv 16 (the JAX tests' width; the card's wrappers zero-pad it):
    the slot engine with the decode kernel's path and the paged engine
    serve the JAX slot engine's tokens, int8 weights and KV."""
    jcfg = JaxConfig(**TINY16)
    jparams = jax_quantize_params(
        jt5.init_params(jax.random.PRNGKey(1), jcfg), "int8")
    cfg = FlashT5Config(**TINY16)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    kw = dict(max_slots=3, max_decode_len=10, max_encode_len=32,
              encode_buckets=(32,), kv_dtype="int8", steps_per_sync=4,
              use_decode_kernel=True)
    want = [r.result for r in jengine.InferenceEngine(
        jcfg, jparams, jengine.EngineConfig(**kw)).run(_requests(jengine))]
    slot = engine.InferenceEngine(cfg, params, engine.EngineConfig(**kw),
                                  device="cpu").run(_requests(engine))
    paged = paged_engine.PagedInferenceEngine(
        cfg, params, paged_engine.PagedEngineConfig(
            max_slots=3, page_size=8, num_pages=12, max_pages_per_slot=3,
            max_encode_len=32, encode_buckets=(32,), kv_dtype="int8",
            steps_per_sync=3), device="cpu").run(_requests(engine))
    assert any(len(w) > 4 for w in want)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(slot[i].result, w, err_msg=f"slot {i}")
        np.testing.assert_array_equal(paged[i].result, w,
                                      err_msg=f"paged {i}")
