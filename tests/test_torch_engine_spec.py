"""Speculative windows in the port's slot engine (`spec_window >= 2`).

The contracts of tests/test_engine_spec.py on the port: each request's
tokens equal the standard greedy engine's at any acceptance rate (random
inputs, near-zero acceptance; windows of 2 and 4; native and int8 caches),
oracle drafts collapse the window count below the token count, budgets and
EOS hold with more requests than slots and always-wrong drafts, and
sampling and the single-query decode kernel are refused. One case holds the
port's speculative engine token for token against the JAX package's, from
the same numpy weights. Tokens are compared exactly: a tiny f32 model on
the CPU on both sides.
"""

import copy

import jax
import numpy as np
import pytest

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.inference import engine as jengine
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy
from flasht5_tpu_torch.inference import engine
from flasht5_tpu_torch.models import t5

TINY = dict(vocab_size=256, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            num_layers=2, dropout_rate=0.0, attention_scale=1.0,
            dtype="float32", pad_token_id=0)
BASE = dict(max_slots=3, max_decode_len=16, max_encode_len=16,
            encode_buckets=(16,))


@pytest.fixture(scope="module")
def model():
    cfg = FlashT5Config(**TINY)
    return cfg, t5.init_params(cfg, seed=0, device="cpu")


def make_reqs(module, rng, lengths, max_new=10):
    return [module.Request(uid=i, input_ids=rng.integers(
                2, 256, size=(n,)).astype(np.int32), max_new_tokens=max_new)
            for i, n in enumerate(lengths)]


def serve(cfg, params, reqs, **kw):
    eng = engine.InferenceEngine(cfg, params,
                                 engine.EngineConfig(**dict(BASE, **kw)),
                                 device="cpu")
    done = eng.run(copy.deepcopy(reqs))
    return eng, {r.uid: r.result for r in done}


def _same(want, got):
    assert want.keys() == got.keys()
    for uid in want:
        np.testing.assert_array_equal(want[uid], got[uid], err_msg=str(uid))


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("spec_window", [2, 4])
def test_spec_engine_matches_standard(model, kv_dtype, spec_window):
    cfg, params = model
    reqs = make_reqs(engine, np.random.default_rng(1), [5, 9, 14, 7, 11, 6])
    _, std = serve(cfg, params, reqs, kv_dtype=kv_dtype)
    eng, spc = serve(cfg, params, reqs, kv_dtype=kv_dtype,
                     spec_window=spec_window)
    _same(std, spc)
    stats = eng.spec_stats
    assert stats["tokens"] == sum(len(r) for r in spc.values())
    assert 0 < stats["windows"] <= stats["slot_windows"] <= stats["tokens"]


def test_spec_engine_matches_the_jax_spec_engine():
    """Window 4, int8 caches: the JAX package's speculative engine and the
    port's on the same weights and requests (drafts from a source that
    holds some of the greedy stream, so that windows accept)."""
    jcfg = JaxConfig(**TINY)
    jparams = jt5.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    rng = np.random.default_rng(3)
    jreqs = make_reqs(jengine, rng, [6, 12, 9, 15], max_new=12)
    kw = dict(BASE, max_decode_len=20, kv_dtype="int8", spec_window=4,
              steps_per_sync=4)
    jeng = jengine.InferenceEngine(jcfg, jparams, jengine.EngineConfig(**kw))
    want = {r.uid: r.result for r in jeng.run(copy.deepcopy(jreqs))}
    reqs = [engine.Request(uid=r.uid, input_ids=r.input_ids,
                           max_new_tokens=r.max_new_tokens) for r in jreqs]
    eng, got = serve(FlashT5Config(**TINY), params, reqs,
                     **{k: v for k, v in kw.items() if k not in BASE})
    _same(want, got)
    assert eng.spec_stats == jeng.spec_stats


def test_spec_engine_oracle_drafts_collapse_windows(model):
    """draft_source = each request's own greedy output behind the start
    token: windows accept fully, so there are fewer windows than tokens."""
    cfg, params = model
    reqs = make_reqs(engine, np.random.default_rng(3), [6, 8, 10], max_new=12)
    _, std = serve(cfg, params, reqs, max_decode_len=20)
    for r in reqs:
        r.draft_source = np.concatenate([[0], std[r.uid]]).astype(np.int32)
    eng, spc = serve(cfg, params, reqs, max_decode_len=20, spec_window=4,
                     steps_per_sync=4)
    _same(std, spc)
    assert 0 < eng.spec_stats["windows"] < eng.spec_stats["tokens"], \
        eng.spec_stats


def test_spec_engine_budget_and_churn(model):
    """More requests than slots, budgets of 3, always-wrong drafts on every
    other request: budgets, EOS and slot reuse as in the standard engine."""
    cfg, params = model
    reqs = make_reqs(engine, np.random.default_rng(5),
                     [5, 7, 9, 6, 8, 10, 11, 12], max_new=3)
    for r in reqs[::2]:
        r.draft_source = np.full((12,), 7, np.int32)
    _, std = serve(cfg, params, reqs, max_slots=2)
    _, spc = serve(cfg, params, reqs, max_slots=2, spec_window=3)
    _same(std, spc)
    assert all(len(r) <= 4 for r in spc.values())   # 3 tokens + forced EOS


@pytest.mark.parametrize("change,match", [
    (dict(temperature=0.7), "greedy"),
    (dict(use_decode_kernel=True), "single-query")])
def test_spec_engine_refuses(model, change, match):
    cfg, params = model
    with pytest.raises(ValueError, match=match):
        engine.InferenceEngine(cfg, params, engine.EngineConfig(
            **BASE, spec_window=4, **change), device="cpu")
