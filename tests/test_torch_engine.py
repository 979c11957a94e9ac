"""The serving slice end to end: the port's InferenceEngine against the JAX
package's, on the same carried-across int8 weights.

Both engines run a tiny FAT5-shaped model (d_model 128, 4 heads of 32,
d_ff 256, vocab 512, 2+2 layers) at float32 with `attention_type=
"pallas_rpe"`, the fused layernorm and int8 per-channel weights. The JAX side
runs its Pallas kernels in interpret mode (tests/conftest.py); the port runs
on the CPU, i.e. the plain version of each kernel. Five requests of mixed
lengths over three slots make the scheduler refill a slot, and two encode
buckets make it batch prefills of different widths.

Tolerance of the logits: 2e-2 absolute. Both sides round the activations to
bf16 before every dequant matmul, at the same points; an activation that
differs by one f32 ulp (another summation order) can round to the other
side of a bf16 boundary, which moves it by 2^-8 relative, and such flips
cascade through the layers. The largest logits here are about 3.5, where a
bf16 ulp is 1.6e-2; 2e-2 is a little over one. The greedy tokens must be
equal: the arg-max margins of this model and these inputs (0.05 at the
least) are wider than the logit error.
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
from flasht5_tpu_torch.inference import engine

TINY = dict(vocab_size=512, d_model=128, d_kv=32, num_heads=4, d_ff=256,
            num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
            attention_scale=1.0, dtype="float32", pad_token_id=0,
            attention_type="pallas_rpe", use_fused_layernorm=True)
LENGTHS = (12, 30, 7, 25, 16)
LOGIT_TOL = 2e-2


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


def _engine_kw(kv_dtype, use_decode_kernel):
    return dict(max_slots=3, max_decode_len=10, max_encode_len=32,
                encode_buckets=(16, 32), kv_dtype=kv_dtype, steps_per_sync=4,
                use_decode_kernel=use_decode_kernel)


def _requests(module):
    rng = np.random.default_rng(11)
    return [module.Request(uid=i, input_ids=rng.integers(
        2, 512, size=(n,)).astype(np.int32), max_new_tokens=8)
        for i, n in enumerate(LENGTHS)]


@pytest.mark.parametrize("kv_dtype,use_decode_kernel",
                         [("int8", True), ("native", False)])
def test_engine_tokens_match_jax(models, kv_dtype, use_decode_kernel):
    jcfg, jparams, cfg, params = models
    kw = _engine_kw(kv_dtype, use_decode_kernel)
    want = jengine.InferenceEngine(jcfg, jparams, jengine.EngineConfig(**kw)
                                   ).run(_requests(jengine))
    eng = engine.InferenceEngine(cfg, params, engine.EngineConfig(**kw),
                                 device="cpu")
    got = eng.run(_requests(engine))
    for w, g in zip(want, got):
        assert g.result is not None and g.result[-1] == cfg.eos_token_id
        np.testing.assert_array_equal(g.result, w.result,
                                      err_msg=f"request {g.uid}")
        assert g.admitted_at <= g.first_token_at <= g.finished_at
    # the engine is reusable: a second run serves the same tokens
    again = eng.run(_requests(engine))
    for w, g in zip(want, again):
        np.testing.assert_array_equal(g.result, w.result)


@pytest.mark.parametrize("kv_dtype,use_decode_kernel",
                         [("int8", True), ("native", False)])
def test_probe_step_logits_match_jax(models, kv_dtype, use_decode_kernel):
    """Teacher-forced decode steps of two slots (one admitted into each
    bucket): the logits of every step agree with the JAX engine's."""
    jcfg, jparams, cfg, params = models
    kw = _engine_kw(kv_dtype, use_decode_kernel)
    jeng = jengine.InferenceEngine(jcfg, jparams, jengine.EngineConfig(**kw))
    eng = engine.InferenceEngine(cfg, params, engine.EngineConfig(**kw),
                                 device="cpu")
    jreqs, reqs = _requests(jengine), _requests(engine)
    for slot, idx in enumerate((0, 1)):
        jeng.admit_request(jreqs[idx], slot)
        eng.admit_request(reqs[idx], slot)
    token = np.zeros((3,), np.int32)
    for _ in range(6):
        jnxt, jlogits = jeng.probe_step(token_override=token)
        nxt, logits = eng.probe_step(token_override=token)
        assert logits.shape == (3, 512)
        np.testing.assert_allclose(logits[:2], np.asarray(jlogits)[:2],
                                   rtol=0, atol=LOGIT_TOL)
        np.testing.assert_array_equal(nxt[:2], np.asarray(jnxt)[:2])
        token = np.asarray(jnxt, np.int32)


def test_warmup_leaves_the_pool_idle(models):
    *_, cfg, params = models
    eng = engine.InferenceEngine(
        cfg, params, engine.EngineConfig(**_engine_kw("int8", True)),
        device="cpu")
    eng.warmup()
    assert not eng.state.active.any()
    done = eng.run(_requests(engine)[:2])
    assert all(r.result is not None for r in done)


# sampling (temperature > 0) runs now: tests/test_torch_generate.py;
# speculative windows too (tests/test_torch_engine_spec.py), but not on the
# single-query decode kernel, which these settings turn on
@pytest.mark.parametrize("change", [dict(spec_window=2),
                                    dict(spec_window=4)])
def test_engine_refuses_what_is_not_ported(models, change):
    *_, cfg, params = models
    with pytest.raises(ValueError, match="single-query"):
        engine.InferenceEngine(
            cfg, params,
            engine.EngineConfig(**_engine_kw("int8", True), **change),
            device="cpu")


def test_engine_refuses_tensor_parallel(models):
    """Outside a mesh: the sharded engines (tests/test_torch_sharded_
    engine.py) serve across tensor ranks inside one."""
    *_, cfg, params = models
    with pytest.raises(RuntimeError, match="mesh"):
        engine.InferenceEngine(
            cfg.replace(tp_axis="tensor"), params,
            engine.EngineConfig(**_engine_kw("int8", True)), device="cpu")


def test_engine_params_must_lie_on_its_device(models):
    *_, cfg, params = models
    meta = dict(params, shared={"embedding": params["shared"]["embedding"]
                                .to("meta")})
    with pytest.raises(ValueError, match="lie on"):
        engine.InferenceEngine(
            cfg, meta, engine.EngineConfig(**_engine_kw("int8", True)),
            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.InferenceEngine(
                cfg, params, engine.EngineConfig(**_engine_kw("int8", True)))
