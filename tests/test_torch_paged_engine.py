"""The paged serving slice end to end: the port's PagedInferenceEngine
against the JAX package's, on the same carried-across int8 weights.

Both engines run the tiny FAT5-shaped model of tests/test_torch_engine.py
(d_model 128, 4 heads of 32, 2+2 layers, vocab 512, float32, `pallas_rpe`,
fused layernorm, int8 per-channel weights) on the CPU: the JAX side with its
Pallas kernels in interpret mode, the port with the plain version of each
kernel. Pages of 8 tokens, 3 steps a window and up to 17 new tokens make a
request span six windows, so window flushes land mid-page and cross page
boundaries; five requests over three slots make the scheduler refill slots
and reuse pages; in the first comparison two encode buckets batch prefills
of two widths (the others take one bucket, which saves ~5 s of JAX
compilation each).

The served tokens must be exactly equal. Both sides round activations to
bf16 before each int8 matmul at the same points, and the paged attention
differs only in summation order; the arg-max margins of this model and
these inputs (tests/test_torch_engine.py) are far wider than that.

A JAX engine run costs ~15-20 s here, nearly all of it compilation, so each
configuration runs once, cached per module: the default window path with
int8 and with native KV, `kernel="dense"` with int8, and each opt-in
(`dense_read_max`, `window_stage_max_bytes`) with int8 and native KV. The
port's other routes (`ragged`, the per-step path of `window_appends=False`)
are held to the port's own window path.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.inference import paged_engine as jpaged
from flasht5_tpu.inference.engine import Request as JaxRequest
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.ops.quant import QuantizedTensor as JaxQT
from flasht5_tpu.quantize import quantize_params as jax_quantize_params
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy
from flasht5_tpu_torch.inference import engine, paged_engine

TINY = dict(vocab_size=512, d_model=128, d_kv=32, num_heads=4, d_ff=256,
            num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
            attention_scale=1.0, dtype="float32", pad_token_id=0,
            attention_type="pallas_rpe", use_fused_layernorm=True)
LENGTHS = (12, 30, 7, 25, 16)
MAX_NEW = 17


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda x: ((np.asarray(x.qvalues), np.asarray(x.scales))
                   if isinstance(x, JaxQT) else np.asarray(x)),
        tree, is_leaf=lambda x: isinstance(x, JaxQT))


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**TINY)
    jparams = jax_quantize_params(
        jt5.init_params(jax.random.PRNGKey(0), jcfg), "int8")
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    return jcfg, jparams, FlashT5Config(**TINY), params


def _config(module, kv_dtype="int8", **kw):
    base = dict(max_slots=3, page_size=8, num_pages=12, max_pages_per_slot=3,
                max_encode_len=32, encode_buckets=(16, 32), kv_dtype=kv_dtype,
                pages_per_item=2, steps_per_sync=3)
    return module.PagedEngineConfig(**{**base, **kw})


def _requests(make, max_new=MAX_NEW, lengths=LENGTHS):
    rng = np.random.default_rng(11)
    return [make(uid=i, input_ids=rng.integers(2, 512, size=(n,)).astype(
        np.int32), max_new_tokens=max_new) for i, n in enumerate(lengths)]


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX engine's served tokens per (kv_dtype, kernel, buckets), run
    once."""
    jcfg, jparams, *_ = models

    @functools.lru_cache(maxsize=None)
    def served(kv_dtype, kernel, buckets, opt_in=()):
        eng = jpaged.PagedInferenceEngine(
            jcfg, jparams, _config(jpaged, kv_dtype, kernel=kernel,
                                   encode_buckets=buckets, **dict(opt_in)))
        return tuple(r.result for r in eng.run(_requests(JaxRequest)))
    return served


def _serve(models, **kw):
    *_, cfg, params = models
    eng = paged_engine.PagedInferenceEngine(
        cfg, params, _config(paged_engine, **kw), device="cpu")
    return eng, [r.result for r in eng.run(_requests(engine.Request))]


@pytest.mark.parametrize("kv_dtype,kernel,buckets", [
    ("int8", "chunked", (16, 32)), ("native", "chunked", (32,)),
    ("int8", "dense", (32,))])
def test_paged_engine_tokens_match_jax(models, jax_tokens, kv_dtype, kernel,
                                       buckets):
    want = jax_tokens(kv_dtype, kernel, buckets)
    eng, got = _serve(models, kv_dtype=kv_dtype, kernel=kernel,
                      encode_buckets=buckets)
    eos = models[2].eos_token_id
    assert any(len(w) > 9 for w in want)       # some span 3+ windows, 2 pages
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None and g[-1] == eos
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    # the engine is reusable: a second run serves the same tokens
    again = [r.result for r in eng.run(_requests(engine.Request))]
    for g, w in zip(again, want):
        np.testing.assert_array_equal(g, w)


# the opt-ins: a slot's pool is 3 pages of 8 = 24 tokens, within 32; the
# window's staged caches take ~0.1 MB, within 1 MB
OPT_INS = {"dense_read": (("dense_read_max", 32),),
           "window_stage": (("window_stage_max_bytes", 1 << 20),)}


@pytest.mark.parametrize("kv_dtype", ["int8", "native"])
@pytest.mark.parametrize("opt_in", list(OPT_INS))
def test_paged_opt_ins_match_jax(models, jax_tokens, opt_in, kv_dtype):
    """`dense_read_max` and `window_stage_max_bytes` against the JAX engine
    with the same opt-in: the committed pages read by a gather (or staged
    once a window) and plain attention, not the kernel."""
    want = jax_tokens(kv_dtype, "chunked", (32,), OPT_INS[opt_in])
    eng, got = _serve(models, kv_dtype=kv_dtype, encode_buckets=(32,),
                      **dict(OPT_INS[opt_in]))
    assert eng._dense_read == (opt_in == "dense_read")
    assert eng._window_stage == (opt_in == "window_stage")
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


@pytest.mark.parametrize("kw", [dict(kernel="ragged"),
                                dict(kernel="chunked", window_appends=False)],
                         ids=["ragged", "stepwise"])
def test_other_routes_match_the_window_path(models, kw):
    _, want = _serve(models)
    _, got = _serve(models, **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_oversubscribed_pool_defers_admission(models):
    """num_pages < slots x max_pages_per_slot: requests that do not fit wait
    in the queue, and each request is still served the tokens it gets from
    a pool that never defers."""
    def uneven(uid, input_ids, max_new_tokens):
        return engine.Request(uid=uid, input_ids=input_ids,
                              max_new_tokens=7 if uid < 3 else 3)

    *_, cfg, params = models
    lengths = (6, 7, 8, 9, 10, 11)

    def run(**kw):
        eng = paged_engine.PagedInferenceEngine(
            cfg, params, _config(paged_engine, kv_dtype="native",
                                 page_size=4, max_pages_per_slot=2,
                                 max_encode_len=16, encode_buckets=(16,),
                                 **kw), device="cpu")
        return {r.uid: r.result
                for r in eng.run(_requests(uneven, lengths=lengths))}

    # 4 slots x 2 pages worst case = 8 pages; the pool holds only 5
    tight = run(max_slots=4, num_pages=5)
    ample = run(max_slots=4, num_pages=8)
    assert len(tight) == 6
    for uid, toks in ample.items():
        np.testing.assert_array_equal(tight[uid], toks, err_msg=f"uid {uid}")


def test_impossible_request_raises(models):
    *_, cfg, params = models
    eng = paged_engine.PagedInferenceEngine(
        cfg, params, _config(paged_engine, max_slots=2, page_size=4,
                             num_pages=1, max_pages_per_slot=2),
        device="cpu")
    with pytest.raises(RuntimeError, match="pool"):
        eng.run(_requests(engine.Request, max_new=7, lengths=(6,)))


def test_warmup_leaves_the_pool_idle(models):
    *_, cfg, params = models
    eng = paged_engine.PagedInferenceEngine(
        cfg, params, _config(paged_engine), device="cpu")
    eng.warmup()
    assert not eng.state.active.any() and not eng.state.pos.any()
    done = eng.run(_requests(engine.Request)[:2])
    assert all(r.result is not None for r in done)


@pytest.mark.parametrize("change", [dict(kernel="flash"),
                                    dict(kv_dtype="fp8"),
                                    dict(tp_axis="tensor")])
def test_paged_engine_refuses_what_is_not_ported(models, change):
    """What the engine does not take: an unknown kernel or KV dtype, and
    tensor parallelism outside a mesh (the sharded paged engine serves it
    inside one, tests/test_torch_sharded_paged_engine.py). The opt-ins run
    now (`test_paged_opt_ins_match_jax`)."""
    *_, cfg, params = models
    ecfg_change = {k: v for k, v in change.items() if k != "tp_axis"}
    err = ValueError
    if "tp_axis" in change:
        cfg = cfg.replace(tp_axis=change["tp_axis"])
        err = RuntimeError
    with pytest.raises(err):
        paged_engine.PagedInferenceEngine(
            cfg, params, _config(paged_engine, **ecfg_change), device="cpu")


def test_paged_engine_runs_on_the_card_by_default(models):
    *_, cfg, params = models
    with pytest.raises(ValueError, match="lie on"):
        paged_engine.PagedInferenceEngine(
            cfg, params, _config(paged_engine), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            paged_engine.PagedInferenceEngine(cfg, params,
                                              _config(paged_engine))
