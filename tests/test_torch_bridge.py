"""The weight bridge: a JAX parameter tree carried across to the port gives
the same encoder output as the JAX model.

JAX `init_params` (plain, or `quantize_params`'d to int8 / fp8) is flattened
to numpy on this side, with each QuantizedTensor as a (qvalues, scales)
pair, and `params_from_numpy` builds the port's tree on the CPU.

Tolerances: 1e-4 for plain f32 weights, where only the summation order
differs through two layers. For quantized weights both sides round the
activations to bf16 before each dequant matmul; an activation that differs
by an f32 ulp at a bf16 rounding boundary moves by a bf16 ulp (2^-8
relative), and such flips cascade through the layers. So each element must
agree within 1e-2 absolute plus 1e-2 relative (about one bf16 ulp of the
outputs, which reach 4), and the mean error must stay below 1e-3, which a
systematic fault would not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.ops.quant import QuantizedTensor as JaxQT
from flasht5_tpu.quantize import quantize_params as jax_quantize_params
from flasht5_tpu_torch.config import FlashT5Config, flagship_config
from flasht5_tpu_torch.convert import params_from_numpy
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.ops.quant import QuantizedTensor
from flasht5_tpu_torch.quantize import quantize_params

TINY = dict(vocab_size=512, d_model=128, d_kv=32, num_heads=4, d_ff=256,
            num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
            attention_scale=1.0, dtype="float32", pad_token_id=0)


def jax_tree_to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda x: ((np.asarray(x.qvalues), np.asarray(x.scales))
                   if isinstance(x, JaxQT) else np.asarray(x)),
        tree, is_leaf=lambda x: isinstance(x, JaxQT))


def _configs(**kw):
    d = dict(TINY, **kw)
    return JaxConfig(**d), FlashT5Config(**d)


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
@pytest.mark.parametrize("attention", ["pallas_rpe", "ref"])
def test_encode_matches_jax(mode, attention):
    jcfg, cfg = _configs(attention_type=attention,
                         use_fused_layernorm=attention == "pallas_rpe")
    jparams = jt5.init_params(jax.random.PRNGKey(0), jcfg)
    if mode is not None:
        jparams = jax_quantize_params(jparams, mode)
    params = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    ids = np.random.default_rng(0).integers(2, 512, size=(2, 24)).astype(
        np.int32)
    want = np.asarray(jt5.encode(jcfg, jparams, jnp.asarray(ids)))
    got = t5.encode(cfg, params, torch.from_numpy(ids)).numpy()
    tol = 1e-4 if mode is None else 1e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert np.abs(got - want).mean() < (1e-5 if mode is None else 1e-3)


def test_params_from_numpy_keeps_tree_and_bits():
    jcfg, _ = _configs()
    jparams = jax_quantize_params(
        jt5.init_params(jax.random.PRNGKey(1), jcfg), "fp8")
    tree = jax_tree_to_numpy(jparams)
    params = params_from_numpy(tree, device="cpu")
    wq = params["decoder"]["block"][1]["ff_layer"]["wo"]
    assert isinstance(wq, QuantizedTensor)
    assert wq.qvalues.dtype == torch.float8_e4m3fn
    src = tree["decoder"]["block"][1]["ff_layer"]["wo"][0]
    np.testing.assert_array_equal(wq.qvalues.view(torch.uint8).numpy(),
                                  src.view(np.uint8))
    table = params["encoder"]["block"][0]["self_attention_layer"][
        "self_attention"]["pe_encoding"]["relative_attention_bias"]
    assert table.shape == (32, 4) and table.dtype == torch.float32
    assert len(params["decoder"]["block"]) == 2


def test_quantize_params_matches_jax_key_rule():
    """The port's quantize_params picks the same leaves as the JAX one and
    quantizes them to the same bits."""
    jcfg, _ = _configs()
    jparams = jt5.init_params(jax.random.PRNGKey(2), jcfg)
    want = jax_tree_to_numpy(jax_quantize_params(jparams, "int8"))
    got = quantize_params(params_from_numpy(jax_tree_to_numpy(jparams),
                                            device="cpu"), "int8")

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}.{i}")
        elif isinstance(a, tuple):
            assert isinstance(b, QuantizedTensor), path
            np.testing.assert_array_equal(b.qvalues.numpy(), a[0])
            np.testing.assert_array_equal(b.scales.numpy(), a[1])
        else:
            assert isinstance(b, torch.Tensor), path
            np.testing.assert_array_equal(b.numpy(), a)

    walk(want, got)


def test_init_params_tree_matches_jax():
    """The port's own seeded init builds the JAX package's tree: the same
    keys, shapes and dtypes (the values differ: other generators)."""
    jcfg, cfg = _configs()
    want = jax_tree_to_numpy(jt5.init_params(jax.random.PRNGKey(0), jcfg))
    got = t5.init_params(cfg, seed=0, device="cpu")
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in flat_w] == \
        [jax.tree_util.keystr(p) for p, _ in flat_g]
    for (_, a), (_, b) in zip(flat_w, flat_g):
        assert tuple(b.shape) == a.shape and str(b.dtype) == f"torch.{a.dtype}"


def test_flagship_config_is_fat5_small():
    cfg = flagship_config()
    assert (cfg.num_layers, cfg.num_decoder_layers, cfg.d_model,
            cfg.num_heads, cfg.d_kv, cfg.d_ff, cfg.vocab_size) == \
        (12, 12, 512, 8, 64, 2048, 32768)
    assert cfg.attention_type == "pallas_rpe" and cfg.use_fused_layernorm
    assert not cfg.tie_word_embeddings and cfg.softmax_scale == 1.0
    assert FlashT5Config(attention_type="fa2_rpe").attention_type == "pallas_rpe"
    assert FlashT5Config(num_heads=4).softmax_scale == 0.5
